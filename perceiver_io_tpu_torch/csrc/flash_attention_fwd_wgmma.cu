// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16
// tiles fed by TMA into wgmma. K1's route for bf16 queries with more than
// 16 rows (the latent cross-attend and the latent stack).
//
// Replaces the Pallas TPU kernel `_forward` in
// perceiver_io_tpu/ops/flash_attention.py (K1), as its other two routes do
// (csrc/flash_attention_fwd.cu, csrc/flash_attention_fwd_split.cu). Same
// function: online-softmax attention over pre-scaled queries, the
// right-aligned causal mask `col <= row + (j - i)` with kv tiles wholly above
// the shifted diagonal never loaded, an optional (b, j) key pad mask
// (1 = pad), fp32 softmax and sums, p rounded to bf16 before p.v, o (b, h, i,
// dv) in bf16 and lse (b, h, i) in fp32; a row that sees no key gets o = 0 and
// lse = MASK (K2/K3 select on that lse). v has a head dim of its own, dv (the
// DV template argument beside D; csrc/head_dims.cuh lists the pairs).
//
// What bounds it on the H100: at the serving and training shapes (i = 512
// latents, j = 512..1024 keys, d = 112) one (batch, head) does 4*i*j*d flops
// (half of them masked away by the causal bound) against (i + 2j)*d*2 bytes:
// ~200-300 flops per byte, near the bf16 tensor-core ridge (~295), so the
// card's bound sits between bytes and operations. The design keeps both
// products on wgmma with fp32 accumulators in registers, never writes the
// (i, j) scores to device memory, reads each k/v tile once per 64 query
// rows, and overlaps the TMA loads of the next tiles with the products.
//
// Schedule: one block per (64-row query tile, head, batch): one consumer
// warpgroup and one producer warp (160 threads). Two blocks fit on
// an SM (81 KB of shared memory each at d = 112), so one block's softmax
// overlaps the other's products; at i = 512, b*h*8 = 256 blocks fill the 264
// slots of 132 SMs in one wave. (With two warpgroups per block, 128 rows,
// half of a block idles when i is not a multiple of 128: chip_smoke.py's
// ragged case, i = 100, took 0.0236 ms that way and 0.0178 ms this way on an
// NVIDIA H100 80GB HBM3 at 700 W, its i = 512 cases within 3 %. A third stage
// of the k/v ring would take 113 KB a block, room for one block per SM.)
// Blocks run from the last query tile to the first, so the tiles that see the
// most keys start first. The producer loads the block's q tile once and keeps
// a ring of STAGES k/v tiles of 64 keys in flight (full / empty mbarriers),
// and writes each tile's 64-bit key mask (in range and not padded) beside it.
// The consumer warpgroup computes S = Q.K^T with wgmma m64n64k16 (both
// operands K-major from shared memory, d/16 k-steps), masks by select only on
// tiles that straddle its shifted diagonal or hold a masked key, runs the
// online softmax in the accumulator layout, packs p to bf16 in registers and
// feeds it as the A operand of O += P.V (m64n128k16 for d = 96, 112 and
// 128, m64n64k16 for d = 64), with V MN-major from shared memory.
//
// d = 112 is 224 bytes a row: a 128-byte swizzled box holds 64 bf16
// columns, so each tile is two boxes (columns 0-63 and 64-127) over a map
// whose inner extent is d. TMA zero-fills columns 112-127; S runs its
// k-steps over the 112 real columns; O's columns 112-127 stay 0 and are not
// stored. d = 96 is the same with columns 96-127 zero: S's six k-steps
// cross into the second box after four.
//
// v of its own width (the Perceiver IO masked LM: q/k d = 32, v dv = 160 in
// the encoder and 96 in the decoder). q and k take ceil(d / 64) boxes a row
// and v ceil(dv / 64); at d = 32 the one q/k box holds 32 real columns and
// TMA zero-fills the rest (S runs two k-steps). O's accumulator is 64 x
// 64 * ceil(dv / 64): at dv = 160 three boxes, O += P.V as m64n128k16 over
// the first two and m64n64k16 over the third (columns 160-191 stay 0 and are
// not stored), 96 fp32 registers a thread.
//
// d = dv = 160 (the text families at the JAX CLI's defaults): q and k take
// three boxes as v does, S runs ten k-steps (the last two in the third box,
// whose columns 160-191 TMA zero-fills); 124 KB of shared memory, one block
// an SM.
#include <cuda_bf16.h>
#include <stdint.h>

#include "head_dims.cuh"  // FLASH_HEAD_DIM_PAIRS
#include "sm90.cuh"

namespace {

constexpr int BM = 64;                   // query rows per block: one consumer warpgroup
constexpr int BN = 64;                   // keys per kv tile
constexpr int STAGES = 2;                // k/v tiles in flight
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 box
// Large-but-finite mask value, as the TPU kernel's: the lse of a dead row.
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

template <int D, int DV>
struct Tile {
  static constexpr int QK_BOXES = (D + 63) / 64;  // 64-column boxes per q or k row
  static constexpr int V_BOXES = (DV + 63) / 64;  // per v row
  static constexpr int DP = 64 * V_BOXES;         // O's accumulator width
  static constexpr int KSTEPS = D / 16;           // k-steps of S = Q.K^T
  static constexpr int QK_BYTES = QK_BOXES * BOX_BYTES;  // 64 rows of q or k
  static constexpr int V_BYTES = V_BOXES * BOX_BYTES;    // 64 rows of v
  static constexpr int SMEM =
      1024 + (1 + STAGES) * QK_BYTES + STAGES * V_BYTES + (3 * STAGES + 1) * 8;
};

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ pad,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int I,
                       int J) {
  using T = Tile<D, DV>;
  static_assert(D % 16 == 0 && D <= 192, "q/k head dim must be a multiple of 16, at most 192");
  static_assert(DV % 16 == 0 && DV <= 192, "v head dim must be a multiple of 16, at most 192");
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  uint8_t* base = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                        // [box]
  uint8_t* k_s = q_s + T::QK_BYTES;           // [stage][box]
  uint8_t* v_s = k_s + STAGES * T::QK_BYTES;  // [stage][box]
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * T::V_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* keymask = q_full + 1;  // [stage]: bit c = key c of the tile is seen

  const int tid = threadIdx.x;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bb = blockIdx.z;
  const int bh = bb * H + blockIdx.y;
  const int offset = J - I;
  int n_tiles = (J + BN - 1) / BN;  // every tile's key is within some row's causal reach
  if (CAUSAL) n_tiles = min(n_tiles, (min(row0 + BM, I) - 1 + offset) / BN + 1);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      sm90::tma_prefetch_map(&kmap);
      sm90::tma_prefetch_map(&vmap);
      sm90::mbar_arrive_expect_tx(q_full, T::QK_BYTES);
      for (int h = 0; h < T::QK_BOXES; ++h)
        sm90::tma_load_3d(q_s + h * BOX_BYTES, &qmap, q_full, h * 64, row0, bh);
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
        for (int h = 0; h < T::QK_BOXES; ++h)
          sm90::tma_load_3d(k_s + stage * T::QK_BYTES + h * BOX_BYTES, &kmap, &full[stage], h * 64,
                            t * BN, bh);
        for (int h = 0; h < T::V_BOXES; ++h)
          sm90::tma_load_3d(v_s + stage * T::V_BYTES + h * BOX_BYTES, &vmap, &full[stage], h * 64,
                            t * BN, bh);
      }
      __syncwarp();
    }
    return;
  }

  // the consumer warpgroup: query rows row0 .. row0 + 63
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_lo = row0 + warp * 16 + lane / 4;  // rows r_lo and r_lo + 8

  float acc[T::DP / 2];
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  sm90::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int col0 = t * BN;
    sm90::mbar_wait(&full[stage], (t / STAGES) & 1);
    const uint8_t* kt = k_s + stage * T::QK_BYTES;
    const uint8_t* vt = v_s + stage * T::V_BYTES;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      const int at = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      sm90::wgmma_m64n64k16_ss(s, sm90::desc_sw128(q_s + at, 16, 1024),
                               sm90::desc_sw128(kt + at, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // mask by select, only where the tile straddles the diagonal or a masked key
    const uint64_t km = keymask[stage];
    if (km != ~0ull || (CAUSAL && col0 + BN - 1 > row0 + offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = r_lo + 8 * ((i / 2) % 2);
        const bool ok = ((km >> col) & 1) && (!CAUSAL || col0 + col <= row + offset);
        if (!ok) s[i] = -INFINITY;
      }
    }

    // online softmax, rows r_lo (rr = 0) and r_lo + 8 (rr = 1); a row's 64
    // columns lie in the 4 lanes of one quad
    float alpha[2], m_use[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * rr], s[4 * c + 2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      m_use[rr] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet: exp(-inf) = 0
      alpha[rr] = __expf(m[rr] - m_use[rr]);
      m[rr] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __expf(s[i] - m_use[(i / 2) % 2]);
      rowsum[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rowsum[rr] += __shfl_xor_sync(0xffffffffu, rowsum[rr], 1);
      rowsum[rr] += __shfl_xor_sync(0xffffffffu, rowsum[rr], 2);
      l[rr] = alpha[rr] * l[rr] + rowsum[rr];
    }
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // p in bf16, straight from the accumulator layout into A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = sm90::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_mn_cols<T::DP>(acc, pa[kk], vt + kk * 2048, BOX_BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r_lo + 8 * rr;
    if (row >= I) continue;
    // a row that saw no key has l == 0: zero output and lse = MASK
    const bool live = l[rr] > 0.f;
    const float inv = live ? 1.f / l[rr] : 0.f;
    __nv_bfloat16* orow = o + ((size_t)bh * I + row) * DV;
#pragma unroll
    for (int c = 0; c < T::DP / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col < DV) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * rr] * inv, acc[4 * c + 2 * rr + 1] * inv);
      }
    }
    if (lane % 4 == 0) lse[(size_t)bh * I + row] = live ? m[rr] + logf(l[rr]) : MASK;
  }
}

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* pad, void* o,
                   float* lse, int B, int H, int I, int J, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!sm90_host::bf16_rows_map(&qmap, q, D, I, B * H) ||
      !sm90_host::bf16_rows_map(&kmap, k, D, J, B * H) ||
      !sm90_host::bf16_rows_map(&vmap, v, DV, J, B * H)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_wgmma_kernel<D, DV, CAUSAL, HAS_PAD>;
  const int smem = Tile<D, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((I + BM - 1) / BM, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(qmap, kmap, vmap, pad,
                                          static_cast<__nv_bfloat16*>(o), lse, H, I, J);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t dispatch_mask(const void* q, const void* k, const void* v, const uint8_t* pad,
                          void* o, float* lse, int B, int H, int I, int J, int causal,
                          cudaStream_t s) {
  if (causal) {
    return pad ? launch<D, DV, true, true>(q, k, v, pad, o, lse, B, H, I, J, s)
               : launch<D, DV, true, false>(q, k, v, pad, o, lse, B, H, I, J, s);
  }
  return pad ? launch<D, DV, false, true>(q, k, v, pad, o, lse, B, H, I, J, s)
             : launch<D, DV, false, false>(q, k, v, pad, o, lse, B, H, I, J, s);
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), k (B,H,J,D) and v
// (B,H,J,DV) contiguous bf16 with 16-byte aligned bases; pad (B,J) uint8 or
// null; o (B,H,I,DV) bf16; lse (B,H,I) fp32. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a (D, DV) pair it does not
// instantiate, or if a tensor map cannot be made).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* pad, void* o, void* lse, int B, int H,
                                         int I, int J, int D, int DV, int causal, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(pad);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGMMA_CASE(PD, PDV) \
  if (D == PD && DV == PDV) return dispatch_mask<PD, PDV>(q, k, v, p, o, l, B, H, I, J, causal, s);
  FLASH_HEAD_DIM_PAIRS(WGMMA_CASE)
#undef WGMMA_CASE
  return cudaErrorInvalidValue;
}
