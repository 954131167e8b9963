// Flash attention backward for Hopper (sm_90a) on the tensor cores: bf16
// tiles fed by TMA into wgmma. The `wgmma` route of K2 (dq) and K3 (dk, dv)
// for bf16 inputs; fp32 inputs keep csrc/flash_attention_bwd.cu (`simt`).
//
// Replaces the Pallas TPU kernels `_backward_dq` and `_backward_dkv` in
// perceiver_io_tpu/ops/flash_attention.py, as csrc/flash_attention_bwd.cu
// does, with the same function: p = exp(s - lse) recomputed from the
// forward's logsumexp over pre-scaled queries, ds = p * (do.v^T - delta)
// with delta = rowsum(o * do) from the caller (fp32), then
//   K2: dq = ds . k
//   K3: dv = p^T . do, dk = ds^T . q
// under the forward's masks: the right-aligned causal mask
// `col <= row + (j - i)` with tiles wholly above the shifted diagonal never
// loaded, and an optional (b, j) key pad mask (1 = pad). Masking is by
// select only: a dead row's lse is MASK, so exp(s - lse) overflows there; a
// row that sees no key gets dq = 0 exactly, a key that no row sees
// dk = dv = 0 exactly. p and ds are rounded to bf16 before their products,
// as on the TPU: here by packing the fp32 accumulator into the bf16x2 A
// fragments of the next wgmma. Every sum is fp32; outputs are bf16.
//
// What bounds them on the H100: per (batch, head) at the training shapes
// (i = 512 latents, j = 512..1024 keys, d = 112) K2 does 6*d flops per
// visible (query, key) pair (S, dP, dQ) and K3 8*d (S^T, dP^T, dV, dK)
// against (3i + 2j)*d and (2i + 4j)*d bf16 elements of traffic: ~300-700
// flops per byte, above the bf16 tensor-core ridge (~295), so both are
// bound by the tensor cores' rate. The design puts all five products on
// wgmma with fp32 accumulators in registers, never writes p or ds to
// shared or device memory (the A operand of each second product comes from
// the registers of the first), reads each streamed tile once per 64-row
// block, skips the tiles the causal mask removes, and overlaps the TMA
// loads of the next tiles with the products of this one.
//
// Schedule, as flash_fwd_wgmma_kernel's: one consumer warpgroup (64 rows of
// the block's own tile) and one producer warp per block, 160 threads, ~98 KB
// of shared memory at d = 112. K2 keeps dQ, S and dP in registers (ptxas:
// 197 a thread at d = 112), so two blocks fit on an SM and one block's
// exponentials and selects overlap the other's products. K3 keeps dK, dV, S^T and dP^T (64 + 64 +
// 32 + 32 fp32 at d = 112 and 128; ptxas: 240, no spill), so one block fits:
// capped at two blocks per SM (__launch_bounds__(THREADS, 2)) it spilled and
// ran slower. The blocks with the most tiles start first (K2 from the last
// query tile, K3 from the first key tile).
//   K2: one block per (64-row query tile, head, batch). The producer loads
//       q and do once, then streams k and v tiles of 64 keys through a ring
//       of STAGES (full / empty mbarriers) up to the tile's causal bound
//       (last row + j - i), writing each tile's 64-bit key mask (in range,
//       not padded) beside it. Per tile the consumer computes S = Q.K^T and dP = dO.V^T
//       (SS, both operands K-major, d/16 k-steps each), p and ds in the
//       accumulator layout with lse and delta read once per row, the select
//       only on tiles that straddle the shifted diagonal or hold a masked
//       key, then dQ += dS.K (RS: dS packed to bf16 in registers, K
//       MN-major from the same shared tile S read K-major).
//   K3: one block per (64-key tile, head, batch). k and v are loaded once;
//       q and do tiles stream through the ring from the first query tile
//       whose causal bound reaches the key tile to the last, each with its
//       64 lse and delta values, which the producer warp's lanes write
//       beside it (all 32 lanes arrive on the stage's full barrier). Per
//       tile the consumer computes S^T = K.Q^T and dP^T = V.dO^T (keys x
//       queries: the key mask is per accumulator row, lse and delta per
//       column), p^T and ds^T under the select, packs each to bf16 in
//       registers and runs dV += P^T.dO and dK += dS^T.Q (RS, dO and Q
//       MN-major from the streamed tiles). dK and dV stay in fp32 registers;
//       the block owns its keys, so there are no atomics and the result is
//       deterministic.
//
// d = 112 is 224 bytes a row: each tile is two 64-column swizzled boxes over
// a map whose inner extent is d, TMA zero-fills columns 112-127, the SS
// products run 7 k-steps over the real columns, the RS products are
// m64n128k16 (m64n64k16 at d = 64) whose columns 112-127 stay 0 and are not
// stored. d = 96 is the same with columns 96-127 zero and 6 k-steps.
//
// v and do of their own width dv (the DV template argument beside D;
// csrc/head_dims.cuh lists the pairs; the Perceiver IO masked LM has d = 32
// with dv = 160 and 96): q and k tiles take ceil(d / 64) boxes a row, v and
// do ceil(dv / 64). S = Q.K^T runs d / 16 k-steps, dP = dO.V^T dv / 16; dQ
// and dK are 64 x 64 * ceil(d / 64) accumulators, dV 64 x 64 * ceil(dv / 64)
// (at dv = 160 m64n128k16 over the first two boxes and m64n64k16 over the
// third, 96 fp32 registers a thread; with dK's 32 and S^T, dP^T's 64 that is
// d = 112's 192). At d = 32 the one q/k box holds 32 real columns and TMA
// zero-fills the rest. At d = dv = 160 dK and dV would hold 96 + 96 fp32
// registers beside S^T's and dP^T's 64, past the 255 a thread can have: K3
// runs as two launches over the same grid (kv_split), one accumulating dV
// alone (S^T, no dP^T) and one dK alone, each computing S^T (five products
// where one launch has four). K2 keeps its 96-register dQ at 160.
// Ragged edges (i, j not multiples of 64) are TMA zero-fill plus the select
// and a store guard.
#include <cuda_bf16.h>
#include <stdint.h>

#include "head_dims.cuh"  // FLASH_HEAD_DIM_PAIRS
#include "sm90.cuh"

namespace {

constexpr int BM = 64;                   // query rows per tile
constexpr int BN = 64;                   // keys per tile
constexpr int STAGES = 2;                // streamed tile pairs in flight
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 box
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int DV>
struct Tile {
  static constexpr int QK_BOXES = (D + 63) / 64;         // 64-column boxes per q or k row
  static constexpr int V_BOXES = (DV + 63) / 64;         // per v or do row
  static constexpr int DP = 64 * QK_BOXES;               // dQ / dK accumulator width
  static constexpr int DVP = 64 * V_BOXES;               // dV accumulator width
  static constexpr int KSTEPS = D / 16;                  // k-steps of S = Q.K^T
  static constexpr int VSTEPS = DV / 16;                 // k-steps of dP = dO.V^T
  static constexpr int QK_BYTES = QK_BOXES * BOX_BYTES;  // 64 rows of q or k
  static constexpr int V_BYTES = V_BOXES * BOX_BYTES;    // 64 rows of v or do
  // two resident tiles (one q/k-wide, one v-wide), a ring of STAGES tile
  // pairs, K3's per-stage lse and delta, and the barriers with K2's
  // per-stage key masks
  static constexpr int SMEM = 1024 + (1 + STAGES) * (QK_BYTES + V_BYTES) + STAGES * 2 * BM * 4 +
                              (3 * STAGES + 1) * 8;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  return raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* once,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], full_count);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_init(once, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
}

// TMA loads of one 64-row tile (its BOXES boxes) at row `row` of (batch, head) bh
template <int BOXES>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int bh) {
  for (int h = 0; h < BOXES; ++h)
    sm90::tma_load_3d(dst + h * BOX_BYTES, map, bar, h * 64, row, bh);
}

// s = A0 . B0^T over the D columns and (WITH_DP) dp = A1 . B1^T over the DV
// columns: four 64-row tiles in shared memory, all K-major; one wgmma group,
// waited on
template <int D, int DV, bool WITH_DP = true>
__device__ __forceinline__ void ss_pair(float (&s)[32], float (&dp)[32], const uint8_t* a0,
                                        const uint8_t* b0, const uint8_t* a1, const uint8_t* b1) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Tile<D, DV>::KSTEPS; ++kk) {
    const int at = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    sm90::wgmma_m64n64k16_ss(s, sm90::desc_sw128(a0 + at, 16, 1024),
                             sm90::desc_sw128(b0 + at, 16, 1024), kk > 0);
  }
  if constexpr (WITH_DP) {
#pragma unroll
    for (int kk = 0; kk < Tile<D, DV>::VSTEPS; ++kk) {
      const int at = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      sm90::wgmma_m64n64k16_ss(dp, sm90::desc_sw128(a1 + at, 16, 1024),
                               sm90::desc_sw128(b1 + at, 16, 1024), kk > 0);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
}

// K3's parts: both accumulators in one block, or (where dK's and dV's
// registers together pass 128 a thread, (160, 160)) dV alone and dK alone,
// one launch each over the same grid
constexpr int BOTH = 0, DV_ONLY = 1, DK_ONLY = 2;
template <int D, int DV>
constexpr bool kv_split() { return Tile<D, DV>::DP / 2 + Tile<D, DV>::DVP / 2 > 128; }

// a 64 x 64 fp32 accumulator as bf16 A fragments: registers 8c..8c+7 are the
// 64 x 16 slice of columns 16c..16c+15 (sm90.cuh)
__device__ __forceinline__ void pack_fragments(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = sm90::pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc += A . B over 64 k rows: A from registers, B a 64-row tile read MN-major
// (its rows are the k dimension, its columns the n dimension); issued, not waited on
template <int DP>
__device__ __forceinline__ void rs_product(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_mn_cols<DP>(acc, a[kk], b + kk * 2048, BOX_BYTES);
}

// rows r_lo (rr = 0) and r_lo + 8 (rr = 1) of a DP-column accumulator,
// columns < N, as bf16
template <int N, int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[DP / 2], int r_lo, int limit,
                                           int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r_lo + 8 * rr;
    if (row >= limit) continue;
    __nv_bfloat16* orow = out + (size_t)row * N;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col < N) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * rr], acc[4 * c + 2 * rr + 1]);
      }
    }
  }
}

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
                          int I, int J) {
  using T = Tile<D, DV>;
  static_assert(D % 16 == 0 && D <= 192, "q/k head dim must be a multiple of 16, at most 192");
  static_assert(DV % 16 == 0 && DV <= 192, "v head dim must be a multiple of 16, at most 192");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = aligned_smem(smem_raw);        // [box]
  uint8_t* do_s = q_s + T::QK_BYTES;            // [box]
  uint8_t* k_s = do_s + T::V_BYTES;             // [stage][box]
  uint8_t* v_s = k_s + STAGES * T::QK_BYTES;    // [stage][box]
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * T::V_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* keymask = q_full + 1;  // [stage]: bit c = key c of the tile is seen

  const int tid = threadIdx.x;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bb = blockIdx.z;
  const int bh = bb * H + blockIdx.y;
  const int offset = J - I;
  int n_tiles = (J + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (min(row0 + BM, I) - 1 + offset) / BN + 1);

  init_barriers(full, empty, q_full, 1);

  if (tid >= CONSUMERS) {  // producer warp
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      sm90::tma_prefetch_map(&kmap);
      sm90::tma_prefetch_map(&vmap);
      sm90::mbar_arrive_expect_tx(q_full, T::QK_BYTES + T::V_BYTES);
      load_tile<T::QK_BOXES>(q_s, &qmap, q_full, row0, bh);
      load_tile<T::V_BOXES>(do_s, &domap, q_full, row0, bh);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      if (t >= STAGES) sm90::mbar_wait(&empty[stage], ((t / STAGES) & 1) ^ 1);
      const int key = t * BN + lane;
      const bool ok0 = key < J && (!HAS_PAD || pad[(size_t)bb * J + key] == 0);
      const bool ok1 = key + 32 < J && (!HAS_PAD || pad[(size_t)bb * J + key + 32] == 0);
      const uint32_t lo = __ballot_sync(0xffffffffu, ok0);
      const uint32_t hi = __ballot_sync(0xffffffffu, ok1);
      if (lane == 0) {
        keymask[stage] = (static_cast<uint64_t>(hi) << 32) | lo;
        sm90::mbar_arrive_expect_tx(&full[stage], T::QK_BYTES + T::V_BYTES);
        load_tile<T::QK_BOXES>(k_s + stage * T::QK_BYTES, &kmap, &full[stage], t * BN, bh);
        load_tile<T::V_BOXES>(v_s + stage * T::V_BYTES, &vmap, &full[stage], t * BN, bh);
      }
      __syncwarp();
    }
    return;
  }

  // the consumer warpgroup: query rows row0 .. row0 + 63
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_lo = row0 + warp * 16 + lane / 4;  // rows r_lo and r_lo + 8
  float lse2[2], dlt[2];                          // lse in log2 units, delta
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r_lo + 8 * rr;
    lse2[rr] = row < I ? lse[(size_t)bh * I + row] * LOG2E : 0.f;
    dlt[rr] = row < I ? delta[(size_t)bh * I + row] : 0.f;
  }

  float acc[T::DP / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) acc[i] = 0.f;

  sm90::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int col0 = t * BN;
    sm90::mbar_wait(&full[stage], (t / STAGES) & 1);
    const uint8_t* kt = k_s + stage * T::QK_BYTES;
    float s[32], dp[32];
    ss_pair<D, DV>(s, dp, q_s, kt, do_s, v_s + stage * T::V_BYTES);

    // ds = p * (dp - delta), p = exp(s - lse); a dead row's exp overflows,
    // so the select runs wherever the tile holds a masked entry: tiles that
    // straddle the shifted diagonal or hold a masked key
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) % 2;
      s[i] = exp2f(fmaf(s[i], LOG2E, -lse2[rr])) * (dp[i] - dlt[rr]);
    }
    const uint64_t km = keymask[stage];
    if (km != ~0ull || (CAUSAL && col0 + BN - 1 > row0 + offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = r_lo + 8 * ((i / 2) % 2);
        const bool ok = ((km >> col) & 1) && (!CAUSAL || col0 + col <= row + offset);
        if (!ok) s[i] = 0.f;
      }
    }

    uint32_t da[4][4];
    pack_fragments(da, s);
    sm90::wgmma_fence();
    rs_product<T::DP>(acc, da, kt);  // dQ += dS . K, K MN-major
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[stage]);
  }

  store_rows<D, T::DP>(dq + (size_t)bh * I * D, acc, r_lo, I, lane);
}

template <int D, int DV, bool CAUSAL, bool HAS_PAD, int PART>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int I, int J) {
  using T = Tile<D, DV>;
  static_assert(D % 16 == 0 && D <= 192, "q/k head dim must be a multiple of 16, at most 192");
  static_assert(DV % 16 == 0 && DV <= 192, "v head dim must be a multiple of 16, at most 192");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = aligned_smem(smem_raw);       // [box]
  uint8_t* v_s = k_s + T::QK_BYTES;            // [box]
  uint8_t* q_s = v_s + T::V_BYTES;             // [stage][box]
  uint8_t* do_s = q_s + STAGES * T::QK_BYTES;  // [stage][box]
  float* lse_s = reinterpret_cast<float*>(do_s + STAGES * T::V_BYTES);  // [stage][BM], log2 units
  float* delta_s = lse_s + STAGES * BM;                                // [stage][BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + STAGES * BM);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int bb = blockIdx.z;
  const int bh = bb * H + blockIdx.y;
  const int offset = J - I;
  const int n_tiles = (I + BM - 1) / BM;
  int t0 = 0;
  if (CAUSAL) {
    // the first query tile whose last row sees col0: t*BM + BM - 1 + offset >= col0
    const int x = col0 - offset - BM + 1;
    t0 = x <= 0 ? 0 : (x + BM - 1) / BM;
  }

  init_barriers(full, empty, kv_full, 32);

  if (tid >= CONSUMERS) {  // producer warp
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      sm90::tma_prefetch_map(&qmap);
      sm90::tma_prefetch_map(&domap);
      sm90::mbar_arrive_expect_tx(kv_full, T::QK_BYTES + T::V_BYTES);
      load_tile<T::QK_BOXES>(k_s, &kmap, kv_full, col0, bh);
      load_tile<T::V_BOXES>(v_s, &vmap, kv_full, col0, bh);
    }
    for (int t = t0; t < n_tiles; ++t) {
      const int n = t - t0;
      const int stage = n % STAGES;
      if (n >= STAGES) sm90::mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = lane + 32 * half;
        const int row = t * BM + r;
        lse_s[stage * BM + r] = row < I ? lse[(size_t)bh * I + row] * LOG2E : 0.f;
        delta_s[stage * BM + r] = row < I ? delta[(size_t)bh * I + row] : 0.f;
      }
      // each lane's arrival releases its own lse / delta writes
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[stage], T::QK_BYTES + T::V_BYTES);
        load_tile<T::QK_BOXES>(q_s + stage * T::QK_BYTES, &qmap, &full[stage], t * BM, bh);
        load_tile<T::V_BOXES>(do_s + stage * T::V_BYTES, &domap, &full[stage], t * BM, bh);
      } else {
        sm90::mbar_arrive(&full[stage]);
      }
      __syncwarp();
    }
    return;
  }

  // the consumer warpgroup: keys col0 .. col0 + 63 are its accumulator rows
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k_lo = col0 + warp * 16 + lane / 4;  // keys k_lo and k_lo + 8
  bool key_ok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k_lo + 8 * rr;
    key_ok[rr] = key < J && (!HAS_PAD || pad[(size_t)bb * J + key] == 0);
  }
  const bool keys_ok = key_ok[0] && key_ok[1];

  float acc_k[T::DP / 2], acc_v[T::DVP / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::DVP / 2; ++i) acc_v[i] = 0.f;

  sm90::mbar_wait(kv_full, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int n = t - t0;
    const int stage = n % STAGES;
    const int row0 = t * BM;
    sm90::mbar_wait(&full[stage], (n / STAGES) & 1);
    const uint8_t* qt = q_s + stage * T::QK_BYTES;
    const uint8_t* dot = do_s + stage * T::V_BYTES;
    float s[32], dp[32];  // S^T and dP^T (not for dV alone): rows keys, columns queries
    ss_pair<D, DV, PART != DV_ONLY>(s, dp, k_s, qt, v_s, dot);

    // p^T and ds^T; the select where this thread's keys are masked, the
    // tile straddles the shifted diagonal or runs past the last query
    const bool masked = !keys_ok || row0 + BM > I || (CAUSAL && col0 + BN - 1 > row0 + offset);
    const float* lt = lse_s + stage * BM;
    const float* dt = delta_s + stage * BM;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = 8 * g + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * g + e;
        const int rr = e / 2;
        const float lv = (e % 2) ? l2.y : l2.x;
        const float dl = (e % 2) ? d2.y : d2.x;
        float p = exp2f(fmaf(s[i], LOG2E, -lv));
        float ds = PART == DV_ONLY ? 0.f : p * (dp[i] - dl);
        if (masked) {
          const int query = row0 + c + (e % 2);
          const int key = k_lo + 8 * rr;
          const bool ok = key_ok[rr] && query < I && (!CAUSAL || key <= query + offset);
          p = ok ? p : 0.f;
          ds = ok ? ds : 0.f;
        }
        s[i] = p;
        dp[i] = ds;
      }
    }

    uint32_t pa[4][4], da[4][4];
    if constexpr (PART != DK_ONLY) pack_fragments(pa, s);
    if constexpr (PART != DV_ONLY) pack_fragments(da, dp);
    sm90::wgmma_fence();
    if constexpr (PART != DK_ONLY) rs_product<T::DVP>(acc_v, pa, dot);  // dV += P^T . dO, dO MN-major
    if constexpr (PART != DV_ONLY) rs_product<T::DP>(acc_k, da, qt);   // dK += dS^T . Q, Q MN-major
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    if constexpr (PART != DK_ONLY) sm90::fence_regs(acc_v);
    if constexpr (PART != DV_ONLY) sm90::fence_regs(acc_k);
    sm90::mbar_arrive(&empty[stage]);
  }

  if constexpr (PART != DV_ONLY) store_rows<D, T::DP>(dk + (size_t)bh * J * D, acc_k, k_lo, J, lane);
  if constexpr (PART != DK_ONLY) store_rows<DV, T::DVP>(dv + (size_t)bh * J * DV, acc_v, k_lo, J, lane);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* pad;
  const float* lse;
  const float* delta;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int B, H, I, J;
  cudaStream_t stream;
};

// one K3 launch of part PART over the (64-key tile, head, batch) grid
template <int D, int DV, bool CAUSAL, bool HAS_PAD, int PART>
cudaError_t launch_dkv(const Args& a, const CUtensorMap& qmap, const CUtensorMap& kmap,
                       const CUtensorMap& vmap, const CUtensorMap& domap) {
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, DV, CAUSAL, HAS_PAD, PART>;
  const int smem = Tile<D, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.J + BN - 1) / BN, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(qmap, kmap, vmap, domap, a.pad, a.lse, a.delta,
                                            static_cast<__nv_bfloat16*>(a.dk),
                                            static_cast<__nv_bfloat16*>(a.dv), a.H, a.I, a.J);
  return cudaGetLastError();
}

template <bool DKV, int D, int DV, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const Args& a) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!sm90_host::bf16_rows_map(&qmap, a.q, D, a.I, a.B * a.H) ||
      !sm90_host::bf16_rows_map(&kmap, a.k, D, a.J, a.B * a.H) ||
      !sm90_host::bf16_rows_map(&vmap, a.v, DV, a.J, a.B * a.H) ||
      !sm90_host::bf16_rows_map(&domap, a.dout, DV, a.I, a.B * a.H)) {
    return cudaErrorInvalidValue;
  }
  if constexpr (DKV) {
    if constexpr (kv_split<D, DV>()) {
      const cudaError_t err = launch_dkv<D, DV, CAUSAL, HAS_PAD, DV_ONLY>(a, qmap, kmap, vmap, domap);
      if (err != cudaSuccess) return err;
      return launch_dkv<D, DV, CAUSAL, HAS_PAD, DK_ONLY>(a, qmap, kmap, vmap, domap);
    } else {
      return launch_dkv<D, DV, CAUSAL, HAS_PAD, BOTH>(a, qmap, kmap, vmap, domap);
    }
  } else {
    auto kernel = flash_bwd_dq_wgmma_kernel<D, DV, CAUSAL, HAS_PAD>;
    const int smem = Tile<D, DV>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.I + BM - 1) / BM, a.H, a.B);
    kernel<<<grid, THREADS, smem, a.stream>>>(qmap, kmap, vmap, domap, a.pad, a.lse, a.delta,
                                              static_cast<__nv_bfloat16*>(a.dq), a.H, a.I, a.J);
    return cudaGetLastError();
  }
}

template <bool DKV, int D, int DV>
cudaError_t dispatch_mask(const Args& a, int causal) {
  if (causal) {
    return a.pad ? launch<DKV, D, DV, true, true>(a) : launch<DKV, D, DV, true, false>(a);
  }
  return a.pad ? launch<DKV, D, DV, false, true>(a) : launch<DKV, D, DV, false, false>(a);
}

template <bool DKV>
int dispatch(const Args& a, int D, int DV, int causal, int dtype) {
  if (dtype != 1) return cudaErrorInvalidValue;  // bf16 only
#define BWD_CASE(PD, PDV) \
  if (D == PD && DV == PDV) return dispatch_mask<DKV, PD, PDV>(a, causal);
  FLASH_HEAD_DIM_PAIRS(BWD_CASE)
#undef BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes; the argument lists of
// flash_attention_bwd_dq / _dkv (csrc/flash_attention_bwd.cu) with DV after
// D. q (B,H,I,D), do (B,H,I,DV), k (B,H,J,D) and v (B,H,J,DV), contiguous
// bf16 with 16-byte aligned bases; pad (B,J) uint8 or null; lse and delta
// (B,H,I) fp32; outputs bf16 of their inputs' shapes. dtype must be 1
// (bfloat16). Each returns the launch's cudaError_t (cudaErrorInvalidValue
// for another dtype or (D, DV) pair, or if a tensor map cannot be made).
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* pad, const void* lse, const void* delta,
                                            const void* dout, void* dq, int B, int H, int I,
                                            int J, int D, int DV, int causal, int dtype,
                                            void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, dq, nullptr, nullptr, B, H, I, J,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, DV, causal, dtype);
}

extern "C" int flash_attention_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                             const void* pad, const void* lse, const void* delta,
                                             const void* dout, void* dk, void* dv, int B, int H,
                                             int I, int J, int D, int DV, int causal, int dtype,
                                             void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, nullptr, dk, dv, B, H, I, J,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, DV, causal, dtype);
}
