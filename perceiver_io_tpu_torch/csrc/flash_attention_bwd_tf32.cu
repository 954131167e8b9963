// Flash attention backward for Hopper (sm_90a) in fp32 on the tensor cores:
// every product as three TF32 products (3xTF32) on mma.sync, tiles staged
// with cp.async. The `tf32x3` route of K2 (dq) and K3 (dk, dv) for fp32
// inputs; bf16 inputs take csrc/flash_attention_bwd_wgmma.cu (`wgmma`), and
// csrc/flash_attention_bwd.cu (`simt`, the CUDA-core kernels) stays as the
// earlier design, reached only by name.
//
// Replaces the Pallas TPU kernels `_backward_dq` and `_backward_dkv` in
// perceiver_io_tpu/ops/flash_attention.py, with the same function: p =
// exp(s - lse) recomputed from the forward's logsumexp over pre-scaled
// queries, ds = p * (do.v^T - delta) with delta = rowsum(o * do) from the
// caller, then
//   K2: dq = ds . k
//   K3: dv = p^T . do, dk = ds^T . q
// under the forward's masks: the right-aligned causal mask
// `col <= row + (j - i)` with tiles wholly above the shifted diagonal never
// loaded, and an optional (b, j) key pad mask (1 = pad). Masking is by
// select only: a dead row's lse is MASK, so exp(s - lse) overflows there; a
// row that sees no key gets dq = 0 exactly, a key that no row sees
// dk = dv = 0 exactly. Every sum and every output is fp32; no atomics, so
// dk and dv are deterministic.
//
// 3xTF32. A TF32 operand keeps 10 of fp32's 23 mantissa bits, so one TF32
// product per fp32 product errs by ~2^-11 relative. Each operand value x is
// split at load time into hi, x rounded to TF32 to nearest with ties away
// from zero (cvt.rna.tf32.f32's rounding for finite |x| below the rounding
// overflow, computed with two integer operations, which issue faster than
// cvt; see split()), and lo = x - hi (exact in fp32;
// the tensor core reads it truncated to TF32, as CUTLASS's 3xTF32 does), and
// each product a.b runs as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the two small
// terms first) into the fp32 accumulator: what is dropped (a_lo.b_lo and
// lo's truncation) is ~2^-21 relative, fp32's accuracy. TF32 is not turned
// on anywhere; this is an fp32-accurate product.
//
// What bounds them on the H100: per (batch, head) at the training shapes
// (i = 512 latents, j = 512..1024 keys, d = 112) K2 does 6*d flops per
// visible (query, key) pair (S, dP, dQ) and K3 8*d (S^T, dP^T, dV, dK)
// against (3i + 2j)*d and (2i + 4j)*d fp32 elements of traffic: hundreds of
// flops per byte, so both are bound by arithmetic. Each fp32 flop costs 3
// tensor-core TF32 flops: 494.7 TFLOP/s dense over 3 is ~165 TFLOP/s, where
// the CUDA cores give 67 (the simt kernels). mma.sync does not reach the
// dense TF32 rate on Hopper (wgmma does), and beside the products each
// value a thread loads from shared memory costs three ALU instructions to
// split, so these kernels run well above the 3xTF32 bound (PERF.md): the
// products take the larger share, the loads, splits and selects the rest.
// The design keeps the (i, j) probability matrix out of shared and device
// memory (p and ds stay in registers, see below), reads each staged tile
// from shared memory with no bank conflicts, skips the tiles the causal
// mask removes, and loads the next streamed tile with cp.async while this
// one is computed.
//
// Schedule: 8 warps (256 threads) per block over a 64-row tile, products on
// mma.sync.m16n8k8 (tf32 in, fp32 accumulate); thread (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8 of its warp's 16. Two warps share each
// 16-row group, each over half of the tile's 64 columns, and add their
// partial sums once at the end through shared memory (a fixed order, so the
// result stays deterministic): with one block per SM, 8 warps give each
// scheduler two warps to issue from, where 4 warps (one each) left it
// stalled on shared loads and splits (PERF.md); it also halves the S/dP
// registers, which K3's dK/dV accumulators need. Tiles are fp32 in shared
// memory with row stride d + 4; six
// tiles of 64 x (d + 4) (174 KB at d = 112, 198 KB at d = 128) allow one
// block per SM, and the double buffer hides the streamed loads. At d = dv =
// 160 six tiles would take 253 KB of the 227 a block can use: the streamed
// tiles take one stage (STAGES, 169 KB), loaded once the last is read.
//   K2: one block per (64-row query tile, head, batch), the tiles with the
//       most keys first. q and do are staged once, lse and delta read into
//       registers; k and v tiles of 64 keys stream through two cp.async
//       stages up to the tile's causal bound (last row + j - i), each with
//       its keys' pad flags. Per tile each warp computes S = Q.K^T and
//       dP = dO.V^T over its 16 rows and 32 keys (4 n-tiles), p and ds under
//       the select, then its part of dQ += dS.K; dQ (16 x d) stays in
//       registers.
//   K3: one block per (64-key tile, head, batch). k and v are staged once;
//       q and do tiles stream, with their 64 lse and delta values (4-byte
//       cp.async), from the first query tile whose causal bound reaches the
//       key tile to the last. Each warp owns 16 keys and 32 of the tile's
//       queries and computes the transposed tile S^T = K.Q^T and
//       dP^T = V.dO^T (keys x queries: the key mask is per row, lse and
//       delta per column), then its part of dV += P^T.dO and dK += dS^T.Q;
//       dK and dV (16 x d each, 112 fp32 a thread at d = 112) stay in
//       registers.
//
// Register-resident p and ds. The C fragment of an m16n8 product holds
// rows g, g + 8 at columns 2t, 2t + 1; the A fragment of the next product
// wants columns t, t + 4 of its 8-wide k-step. The sum of the second
// products (over keys in K2, queries in K3) is taken in a permuted order
// inside each k-step, k = t <-> column 2t and k = t + 4 <-> column 2t + 1,
// so the C fragment is the A fragment as it stands (no shuffle, no shared
// round trip), and the B operand is read in the same order (rows 2t and
// 2t + 1 of the k-step). The output columns of the second products are
// permuted in pairs of n-tiles (n-tile 2m column g <-> d = 16m + 2g, n-tile
// 2m + 1 <-> 16m + 2g + 1), so the two tiles' B values are one 8-byte load
// and a thread's four results in a row are one 16-byte store.
//
// Bank conflicts. One stride, d + 4, serves every tile and both ways it is
// read. Row-fragment reads (the A operands Q, dO, K, V and the B operands
// K, V of S/dP in K2, Q, dO of S^T/dP^T in K3: thread (g, t) reads row g,
// column t) hit bank 20g + t at d = 112 and 4g + t at d = 64, 128: all 32
// distinct. Column-fragment reads (the B operands of dQ, dV, dK: 8-byte
// loads of rows 2t, 2t + 1 at column 2g) hit banks 8t + 2g (+1) in each
// half-warp: distinct. d + 8 would serve the column reads unpermuted but
// conflict two ways on the row reads, hence the permutations.
//
// v and do of their own width dv (the DV template argument beside D;
// csrc/head_dims.cuh lists the pairs): S runs its k-steps over d and dP over
// dv, dQ and dK are d wide and dV dv wide (K3 at d = 32, dv = 160: 16 + 80
// fp32 a thread), and v / do tiles have the row stride dv + 4.
//
// Ragged edges (i, j not multiples of 64) are cp.async zero-fill (source
// size 0) plus the select and a store guard. cp.async copies 16 bytes, so
// q, k, v and do need 16-byte aligned bases (the wrapper checks); the
// stores of dq, dk and dv are 16 bytes too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dims.cuh"  // FLASH_HEAD_DIM_PAIRS
#include "tf32x3.cuh"  // BM, BN, THREADS, Tile, cp.async, split, mma3 and the fragment helpers

namespace {

// six tiles (K2: q, do, 2 x k, 2 x v; K3: k, v, 2 x q, 2 x do), three of q's
// and k's width and three of v's and do's, and two stages of 64-entry side
// vectors (K2: key flags; K3: lse and delta)
// (STAGES streamed stages: two where they fit, one at d = dv = 160, where
// two would take 253 KB)
template <int D, int DV, int ST>
constexpr int SMEM_OF = ((1 + ST) * (Tile<D>::FLOATS + Tile<DV>::FLOATS) + 4 * 64) * sizeof(float);
template <int D, int DV>
constexpr int STAGES = SMEM_OF<D, DV, 2> <= SMEM_LIMIT ? 2 : 1;
template <int D, int DV>
constexpr int SMEM = SMEM_OF<D, DV, STAGES<D, DV>>;

// the second column half's partial sums added into the first's (warps
// 4..7 into 0..3) through shared memory `red`, 4 x (D / 2) x 32 floats,
// lane-contiguous
template <int D>
__device__ __forceinline__ void add_halves(float (&acc)[D / 8][4], float* red, int group, int half,
                                           int lane) {
  float* r = red + group * (D / 2) * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[(4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += r[(4 * n + e) * 32];
  }
}

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ pad,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ dout, float* __restrict__ dq, int H, int I,
                           int J) {
  constexpr int S = Tile<D>::S, T = Tile<D>::FLOATS;
  constexpr int SV = Tile<DV>::S, TV = Tile<DV>::FLOATS, ST = STAGES<D, DV>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + T;
  float* k_s = do_s + TV;       // ST stages
  float* v_s = k_s + ST * T;    // ST stages
  float* ok_s = v_s + ST * TV;  // two stages of BN: 1 = key in range, not padded

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = (tid >> 5) & 3, half = tid >> 7, g = lane >> 2, t = lane & 3;
  const int c0 = 32 * half;  // this warp's 32 keys of each tile
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the tiles with the most keys first
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int bb = blockIdx.z;
  const float* kg = k + bh * (size_t)J * D;
  const float* vg = v + bh * (size_t)J * DV;
  const int offset = J - I;

  int n_tiles = (J + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (min(row0 + BM, I) - 1 + offset) / BN + 1);

  stage<D>(q_s, q + bh * (size_t)I * D, row0, I);
  stage<DV>(do_s, dout + bh * (size_t)I * DV, row0, I);
  stage<D>(k_s, kg, 0, J);
  stage<DV>(v_s, vg, 0, J);
  cp_async_commit();
  if (tid < BN) ok_s[tid] = key_ok<HAS_PAD>(pad, bb, J, tid) ? 1.f : 0.f;

  const int lr = 16 * group + g;  // this thread's rows lr and lr + 8 of the tile
  const int gr0 = row0 + lr, gr1 = gr0 + 8;
  const float lse0 = gr0 < I ? lse[bh * I + gr0] : 0.f, lse1 = gr1 < I ? lse[bh * I + gr1] : 0.f;
  const float delta0 = gr0 < I ? delta[bh * I + gr0] : 0.f;
  const float delta1 = gr1 < I ? delta[bh * I + gr1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = ST == 2 ? it & 1 : 0, col0 = it * BN;
    const bool more = it + 1 < n_tiles;
    float next_ok = 0.f;
    if (ST == 2 && more) {  // the next tile into the other stage (read two barriers ago)
      stage<D>(k_s + (cur ^ 1) * T, kg, col0 + BN, J);
      stage<DV>(v_s + (cur ^ 1) * TV, vg, col0 + BN, J);
      if (tid < BN) next_ok = key_ok<HAS_PAD>(pad, bb, J, col0 + BN + tid) ? 1.f : 0.f;
    }
    cp_async_commit();
    cp_async_wait<ST - 1>();  // this tile's group (and q, do) have landed
    __syncthreads();
    const float* kt = k_s + cur * T;
    const float* vt = v_s + cur * TV;
    const float* okt = ok_s + cur * BN;

    // S = Q.K^T and dP = dO.V^T: 16 rows x 32 keys a warp, 4 n-tiles
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    if constexpr (D == DV) {  // one loop over both products: up to 5 % faster than two (PERF.md)
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        load_a<S>(qh, ql, q_s, lr, 8 * kk, t);
        load_a<S>(oh, ol, do_s, lr, 8 * kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* kr = kt + (c0 + 8 * j + g) * S + 8 * kk + t;  // B[d][key] = k[key][d]
          const float* vr = vt + (c0 + 8 * j + g) * S + 8 * kk + t;
          mma3(s[j], qh, ql, kr[0], kr[4]);
          mma3(dp[j], oh, ol, vr[0], vr[4]);
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t qh[4], ql[4];
        load_a<S>(qh, ql, q_s, lr, 8 * kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* kr = kt + (c0 + 8 * j + g) * S + 8 * kk + t;  // B[d][key] = k[key][d]
          mma3(s[j], qh, ql, kr[0], kr[4]);
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < DV / 8; ++kk) {
        uint32_t oh[4], ol[4];
        load_a<SV>(oh, ol, do_s, lr, 8 * kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* vr = vt + (c0 + 8 * j + g) * SV + 8 * kk + t;  // B[dv][key] = v[key][dv]
          mma3(dp[j], oh, ol, vr[0], vr[4]);
        }
      }
    }

    // p = exp(s - lse) where allowed (select: a dead row's exp overflows),
    // ds = p * (dp - delta), into s
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = c0 + 8 * j + 2 * t + (e & 1);
        const int gr = e < 2 ? gr0 : gr1;
        const bool allowed = gr < I && okt[lc] != 0.f && (!CAUSAL || col0 + lc <= gr + offset);
        const float p = allowed ? expf(s[j][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = allowed ? p * (dp[j][e] - (e < 2 ? delta0 : delta1)) : 0.f;
      }
    }

    // dQ += dS.K, the sum over this warp's keys in the permuted order
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      a_from_c(ah, al, s[kk]);
      mma3_columns<D>(acc, ah, al, kt, c0 / 8 + kk, g, t);
    }

    if (ST == 2 && more && tid < BN) ok_s[(cur ^ 1) * BN + tid] = next_ok;
    __syncthreads();  // this stage is read by no one before the next copy into it
    if (ST == 1 && more) {  // one stage: the next tile once this one is read
      stage<D>(k_s, kg, col0 + BN, J);
      stage<DV>(v_s, vg, col0 + BN, J);
      if (tid < BN) ok_s[tid] = key_ok<HAS_PAD>(pad, bb, J, col0 + BN + tid) ? 1.f : 0.f;
    }
  }

  cp_async_wait<0>();
  add_halves<D>(acc, q_s, group, half, lane);  // q_s is read no more
  if (half == 0) store_rows<D>(dq + bh * (size_t)I * D, acc, gr0, gr1, I, t);
}

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const uint8_t* __restrict__ pad,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const float* __restrict__ dout, float* __restrict__ dk,
                            float* __restrict__ dv, int H, int I, int J) {
  constexpr int S = Tile<D>::S, T = Tile<D>::FLOATS;
  constexpr int SV = Tile<DV>::S, TV = Tile<DV>::FLOATS, ST = STAGES<D, DV>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + T;
  float* q_s = v_s + TV;           // ST stages
  float* do_s = q_s + ST * T;      // ST stages
  float* lse_s = do_s + ST * TV;   // two stages of BM
  float* delta_s = lse_s + 2 * BM;  // two stages of BM

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = (tid >> 5) & 3, half = tid >> 7, g = lane >> 2, t = lane & 3;
  const int c0 = 32 * half;  // this warp's 32 queries of each tile
  const int col0 = blockIdx.x * BN;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int bb = blockIdx.z;
  const float* qg = q + bh * (size_t)I * D;
  const float* dog = dout + bh * (size_t)I * DV;
  const float* lseg = lse + bh * (size_t)I;
  const float* deltag = delta + bh * (size_t)I;
  const int offset = J - I;

  const int n_tiles = (I + BM - 1) / BM;
  int t0 = 0;
  if (CAUSAL) {
    // first query tile whose last row sees col0: t*BM + BM - 1 + offset >= col0
    const int x = col0 - offset - BM + 1;
    t0 = x <= 0 ? 0 : (x + BM - 1) / BM;
  }

  auto stage_queries = [&](int stg, int row0) {
    stage<D>(q_s + stg * T, qg, row0, I);
    stage<DV>(do_s + stg * TV, dog, row0, I);
    if (tid < BM) {
      const int gr = row0 + tid;
      const bool ok = gr < I;
      cp_async4(lse_s + stg * BM + tid, lseg + (ok ? gr : 0), ok);
      cp_async4(delta_s + stg * BM + tid, deltag + (ok ? gr : 0), ok);
    }
  };
  stage<D>(k_s, k + bh * (size_t)J * D, col0, J);
  stage<DV>(v_s, v + bh * (size_t)J * DV, col0, J);
  if (t0 < n_tiles) stage_queries(0, t0 * BM);
  cp_async_commit();

  const int lk = 16 * group + g;  // this thread's keys lk and lk + 8 of the tile
  const int gk0 = col0 + lk, gk1 = gk0 + 8;
  const bool ok0 = key_ok<HAS_PAD>(pad, bb, J, gk0), ok1 = key_ok<HAS_PAD>(pad, bb, J, gk1);

  float acc_k[D / 8][4], acc_v[DV / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.f;

  for (int it = t0; it < n_tiles; ++it) {
    const int cur = ST == 2 ? (it - t0) & 1 : 0, row0 = it * BM;
    if (ST == 2 && it + 1 < n_tiles) stage_queries(cur ^ 1, row0 + BM);  // read two barriers ago
    cp_async_commit();
    cp_async_wait<ST - 1>();  // this tile's group (and k, v) have landed
    __syncthreads();
    const float* qt = q_s + cur * T;
    const float* dot = do_s + cur * TV;
    const float* lset = lse_s + cur * BM;
    const float* deltat = delta_s + cur * BM;

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    if constexpr (D == DV) {  // one loop over both products: up to 5 % faster than two (PERF.md)
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a<S>(kh, kl, k_s, lk, 8 * kk, t);
        load_a<S>(vh, vl, v_s, lk, 8 * kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* qr = qt + (c0 + 8 * j + g) * S + 8 * kk + t;  // B[d][query] = q[query][d]
          const float* dr = dot + (c0 + 8 * j + g) * S + 8 * kk + t;
          mma3(st[j], kh, kl, qr[0], qr[4]);
          mma3(dpt[j], vh, vl, dr[0], dr[4]);
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t kh[4], kl[4];
        load_a<S>(kh, kl, k_s, lk, 8 * kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* qr = qt + (c0 + 8 * j + g) * S + 8 * kk + t;  // B[d][query] = q[query][d]
          mma3(st[j], kh, kl, qr[0], qr[4]);
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < DV / 8; ++kk) {
        uint32_t vh[4], vl[4];
        load_a<SV>(vh, vl, v_s, lk, 8 * kk, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* dr = dot + (c0 + 8 * j + g) * SV + 8 * kk + t;  // B[dv][query] = do[query][dv]
          mma3(dpt[j], vh, vl, dr[0], dr[4]);
        }
      }
    }

    // p^T into st and ds^T into dpt, under the select
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lq = c0 + 8 * j + 2 * t + (e & 1);
        const int gq = row0 + lq;
        const int gk = e < 2 ? gk0 : gk1;
        const bool allowed = (e < 2 ? ok0 : ok1) && gq < I && (!CAUSAL || gk <= gq + offset);
        const float p = allowed ? expf(st[j][e] - lset[lq]) : 0.f;
        dpt[j][e] = allowed ? p * (dpt[j][e] - deltat[lq]) : 0.f;
        st[j][e] = p;
      }
    }

    // dV += P^T.dO and dK += dS^T.Q, the sums over this warp's queries in
    // the permuted order
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t ph[4], pl[4];
      a_from_c(ph, pl, st[kq]);
      mma3_columns<DV>(acc_v, ph, pl, dot, c0 / 8 + kq, g, t);
      uint32_t dh[4], dl[4];
      a_from_c(dh, dl, dpt[kq]);
      mma3_columns<D>(acc_k, dh, dl, qt, c0 / 8 + kq, g, t);
    }
    __syncthreads();  // this stage is read by no one before the next copy into it
    if (ST == 1 && it + 1 < n_tiles) stage_queries(0, row0 + BM);  // one stage: once this one is read
  }

  cp_async_wait<0>();
  add_halves<D>(acc_k, q_s, group, half, lane);  // q_s and do_s are read no more
  add_halves<DV>(acc_v, do_s, group, half, lane);
  if (half == 0) {
    store_rows<D>(dk + bh * (size_t)J * D, acc_k, gk0, gk1, J, t);
    store_rows<DV>(dv + bh * (size_t)J * DV, acc_v, gk0, gk1, J, t);
  }
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* pad;
  const float* lse;
  const float* delta;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  int B, H, I, J;
  cudaStream_t stream;
};

template <bool DKV, int D, int DV, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const Args& a) {
  constexpr int smem = SMEM<D, DV>;
  if constexpr (DKV) {
    auto kernel = flash_bwd_dkv_tf32x3_kernel<D, DV, CAUSAL, HAS_PAD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.J + BN - 1) / BN, a.H, a.B);
    kernel<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.pad, a.lse, a.delta, a.dout, a.dk, a.dv,
                                              a.H, a.I, a.J);
  } else {
    auto kernel = flash_bwd_dq_tf32x3_kernel<D, DV, CAUSAL, HAS_PAD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.I + BM - 1) / BM, a.H, a.B);
    kernel<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.pad, a.lse, a.delta, a.dout, a.dq, a.H,
                                              a.I, a.J);
  }
  return cudaGetLastError();
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
  if (dtype != 0) return cudaErrorInvalidValue;  // fp32 only
#define TF32_CASE(PD, PDV) \
  if (D == PD && DV == PDV) return dispatch_mask<DKV, PD, PDV>(a, causal);
  FLASH_HEAD_DIM_PAIRS(TF32_CASE)
#undef TF32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes; the argument lists of
// flash_attention_bwd_dq / _dkv (csrc/flash_attention_bwd.cu) with DV after
// D. q (B,H,I,D), do (B,H,I,DV), k (B,H,J,D) and v (B,H,J,DV), contiguous
// fp32 with 16-byte aligned bases; pad (B,J) uint8 or null; lse and delta
// (B,H,I) fp32; outputs fp32 of their inputs' shapes on 16-byte aligned
// bases. dtype must be 0 (float32). Each returns the launch's cudaError_t
// (cudaErrorInvalidValue for another dtype or (D, DV) pair).
extern "C" int flash_attention_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
                                             const void* pad, const void* lse, const void* delta,
                                             const void* dout, void* dq, int B, int H, int I, int J,
                                             int D, int DV, int causal, int dtype, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const uint8_t*>(pad),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(dout), static_cast<float*>(dq), nullptr, nullptr,
               B, H, I, J, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, DV, causal, dtype);
}

extern "C" int flash_attention_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                                              const void* pad, const void* lse, const void* delta,
                                              const void* dout, void* dk, void* dv, int B, int H,
                                              int I, int J, int D, int DV, int causal, int dtype,
                                              void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const uint8_t*>(pad),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(dout), nullptr, static_cast<float*>(dk),
               static_cast<float*>(dv), B, H, I, J, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, DV, causal, dtype);
}
