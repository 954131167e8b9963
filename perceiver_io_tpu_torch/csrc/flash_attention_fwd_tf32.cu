// Flash attention forward for Hopper (sm_90a) in fp32 on the tensor cores:
// both products as three TF32 products (3xTF32) on mma.sync, tiles staged
// with cp.async. The `tf32x3` route of K1 for fp32 queries of more than 16
// rows; bf16 tiles take csrc/flash_attention_fwd_wgmma.cu (`wgmma`), decode
// attends csrc/flash_attention_fwd_split.cu (`split`), and
// csrc/flash_attention_fwd.cu (`simt`, the CUDA-core kernel) stays as the
// earlier design, reached only by name.
//
// Replaces the Pallas TPU kernel `_forward` in
// perceiver_io_tpu/ops/flash_attention.py, with the same function:
// online-softmax attention over pre-scaled queries under the right-aligned
// causal mask `col <= row + (j - i)` and an optional (b, j) key pad mask
// (1 = pad); o (b, h, i, dv) and lse (b, h, i), both fp32. v has a head dim
// of its own, dv (the DV template argument beside D; csrc/head_dims.cuh
// lists the pairs): the k tiles and S's k-steps run over d, the v tiles and
// the o accumulator over dv (dv / 2 fp32 a thread). Masking is by
// select only, and a row that sees no key gets o = 0 and lse = MASK
// exactly. kv tiles wholly above the shifted diagonal are never loaded, nor
// are the leading and trailing tiles whose keys are all padded (the left
// pads of a prompt bucket): they would add exactly nothing.
//
// 3xTF32 as in csrc/flash_attention_bwd_tf32.cu (shared pieces in
// csrc/tf32x3.cuh): each operand value x is split into hi, x rounded to
// TF32 to nearest with ties away from zero, and lo = x - hi, and each
// product a.b runs as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into an fp32
// accumulator: what is dropped is ~2^-21 relative, fp32's accuracy. TF32 is
// not turned on anywhere. In S = Q.K^T the two small terms sum into their
// own accumulator, added to the big one once per kv tile: the tensor core's
// fp32 sum keeps fewer of the small terms' bits when they land on the large
// partial sums (PERF.md has the errors of both orders), and S gets eight
// independent accumulation chains a warp instead of four. The exponentials
// take the fast path (ex2.approx: a few ulps on p, the rescale factors and
// the merge weights, far inside the gates on o and lse); lse's logarithm
// stays exact.
//
// What bounds it on the H100: at the main path's shapes (i = 512 latents,
// j = 512..1024 keys, d = 112) K1 does 4*d flops per visible (query, key)
// pair against (2i + 2j)*d fp32 elements of traffic, hundreds of flops per
// byte: arithmetic bounds it. 3xTF32 spends three tensor-core TF32 flops per
// fp32 flop, 494.7 / 3 ~ 165 TFLOP/s, where the CUDA cores give 67 (the
// simt kernel). mma.sync does not reach the dense TF32 rate, and each value
// read as a B operand costs three ALU instructions to split, so the kernel
// runs above that bound (PERF.md). The design keeps the (i, j) scores and
// probabilities in registers, splits the one static operand, q, once per
// block into hi and lo tiles in shared memory (each warp then only loads its
// A fragments of S = Q.K^T), reads every tile with no bank conflicts, and
// loads the next k/v tile with cp.async while this one is computed.
//
// Schedule: one block of 8 warps per (64-row query tile, head, batch), the
// tiles with the most keys first. Thread (g, t) = (lane / 4, lane % 4) holds
// rows g and g + 8 of its warp's 16; two warps share each 16-row group, each
// over half (32) of every kv tile's 64 keys, and each keeps its own online
// softmax state: the running row max m (quad-uniform: reduced over the four
// threads of a row with shfl_xor 1, 2), this thread's part of the row sum l,
// and acc = sum p.v (16 x d, d / 2 fp32 a thread). Per kv tile each warp
// computes S = Q.K^T over its 32 keys (4 n-tiles), selects the allowed
// entries, takes the new max, rescales l and acc by exp(m_old - m_new), and
// adds P.V with p straight from the S registers (the permuted k-order of
// K2's dQ += dS.K: V is read as K2 reads K). At the end the second warp of
// each group hands (m, l, acc) to the first through shared memory, which
// merges the two states in a fixed order (so the result is deterministic)
// with weights exp(m_half - m), selected to 0 for a half that saw no key, so
// no -inf - (-inf) is ever taken; the handover goes through the v stages,
// read no more. Tiles are fp32 with row stride d + 4 (v's dv + 4): q hi
// and lo, and two stages each of k and v (178 KB at d = 112, 198 KB at
// d = 128, 118 KB at d = 32 with dv = 160): one block per SM. At d = dv =
// 160 two stages would take 252 KB of the 227 a block can use, so the k/v
// tiles take one stage (STAGES): the next tile loads once this one is read,
// and its load is not hidden (168 KB).
//
// Ragged edges (i, j not multiples of 64) are cp.async zero-fill plus the
// select and a store guard. cp.async copies 16 bytes, so q, k and v need
// 16-byte aligned bases (the wrapper checks); o's stores are 16 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dims.cuh"  // FLASH_HEAD_DIM_PAIRS
#include "tf32x3.cuh"  // BM, BN, THREADS, Tile, cp.async, split, mma3 and the fragment helpers

namespace {

// The TPU kernel's large-but-finite mask value: a dead row's lse
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

// q hi and lo, STAGES stages each of k and v, and two stages of 64 key
// flags; two k/v stages where they fit (one at d = dv = 160, where two
// would take 252 KB)
template <int D, int DV, int ST>
constexpr int SMEM_OF = (2 * Tile<D>::FLOATS + ST * (Tile<D>::FLOATS + Tile<DV>::FLOATS) + 2 * 64) * sizeof(float);
template <int D, int DV>
constexpr int STAGES = SMEM_OF<D, DV, 2> <= SMEM_LIMIT ? 2 : 1;
template <int D, int DV>
constexpr int SMEM = SMEM_OF<D, DV, STAGES<D, DV>>;

// the A fragment of rows r, r + 8 and columns k0 + t, k0 + t + 4 from tiles
// split already
template <int S>
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const uint32_t* th,
                                             const uint32_t* tl, int r, int k0, int t) {
  const int o = r * S + k0 + t;
  hi[0] = th[o];
  hi[1] = th[o + 8 * S];
  hi[2] = th[o + 4];
  hi[3] = th[o + 8 * S + 4];
  lo[0] = tl[o];
  lo[1] = tl[o + 8 * S];
  lo[2] = tl[o + 4];
  lo[3] = tl[o + 8 * S + 4];
}

// the weight of a softmax state with max `m` in a merge with max `mx`: 0
// for a state that saw no key (selected, never exp(-inf - (-inf)))
__device__ __forceinline__ float weight(float m, float mx) { return m == -INFINITY ? 0.f : __expf(m - mx); }

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ pad,
                        float* __restrict__ o, float* __restrict__ lse, int H, int I, int J) {
  constexpr int S = Tile<D>::S, T = Tile<D>::FLOATS, CH = D / 4;
  constexpr int TV = Tile<DV>::FLOATS, ST = STAGES<D, DV>;
  extern __shared__ __align__(16) float smem[];
  float* qh_s = smem;           // q's hi parts (bits), staged as fp32 first
  float* ql_s = qh_s + T;       // q's lo parts (bits)
  float* k_s = ql_s + T;        // ST stages
  float* v_s = k_s + ST * T;    // ST stages of TV
  float* ok_s = v_s + ST * TV;  // two stages of BN: 1 = key in range, not padded
  __shared__ int range_s[2];

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = (tid >> 5) & 3, half = tid >> 7, g = lane >> 2, t = lane & 3;
  const int c0 = 32 * half;  // this warp's 32 keys of each tile
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the tiles with the most keys first
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int bb = blockIdx.z;
  const float* kg = k + bh * (size_t)J * D;
  const float* vg = v + bh * (size_t)J * DV;
  const int offset = J - I;

  stage<D>(qh_s, q + bh * (size_t)I * D, row0, I);
  cp_async_commit();

  // kv tiles [begin, end): up to the tile's causal bound (last row + j - i),
  // and without the leading and trailing tiles whose keys are all padded
  int end = (J + BN - 1) / BN;
  if (CAUSAL) end = min(end, (min(row0 + BM, I) - 1 + offset) / BN + 1);
  int begin = 0;
  if (HAS_PAD) {
    if (tid == 0) range_s[0] = end, range_s[1] = -1;
    __syncthreads();
    int first = end, last = -1;
    for (int c = tid; c < min(J, end * BN); c += THREADS) {
      if (pad[(size_t)bb * J + c] == 0) {
        first = min(first, c / BN);
        last = c / BN;
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) {
      atomicMin(&range_s[0], first);
      atomicMax(&range_s[1], last);
    }
    __syncthreads();
    begin = range_s[0];
    end = min(end, range_s[1] + 1);
  }
  if (begin < end) {
    stage<D>(k_s, kg, begin * BN, J);
    stage<DV>(v_s, vg, begin * BN, J);
    if (tid < BN) ok_s[tid] = key_ok<HAS_PAD>(pad, bb, J, begin * BN + tid) ? 1.f : 0.f;
  }
  cp_async_commit();

  // q into hi and lo, once: each thread splits the chunks it copied itself
  // (its own cp.async writes are visible to it after the wait)
  cp_async_wait<1>();
  for (int idx = tid; idx < 64 * CH; idx += THREADS) {
    const int off = (idx / CH) * S + 4 * (idx - (idx / CH) * CH);
    const float4 x = *reinterpret_cast<const float4*>(qh_s + off);
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(qh_s + off) = hi;
    *reinterpret_cast<uint4*>(ql_s + off) = lo;
  }
  const uint32_t* qh = reinterpret_cast<const uint32_t*>(qh_s);
  const uint32_t* ql = reinterpret_cast<const uint32_t*>(ql_s);

  const int lr = 16 * group + g;  // this thread's rows lr and lr + 8 of the tile
  const int gr0 = row0 + lr, gr1 = gr0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = begin; it < end; ++it) {
    const int cur = ST == 2 ? (it - begin) & 1 : 0, col0 = it * BN;
    const bool more = it + 1 < end;
    float next_ok = 0.f;
    if (ST == 2 && more) {  // the next tile into the other stage (read two barriers ago)
      stage<D>(k_s + (cur ^ 1) * T, kg, col0 + BN, J);
      stage<DV>(v_s + (cur ^ 1) * TV, vg, col0 + BN, J);
      if (tid < BN) next_ok = key_ok<HAS_PAD>(pad, bb, J, col0 + BN + tid) ? 1.f : 0.f;
    }
    cp_async_commit();
    cp_async_wait<ST - 1>();  // this tile's group has landed
    __syncthreads();          // (and, the first time, every thread's q split)
    const float* kt = k_s + cur * T;
    const float* vt = v_s + cur * TV;
    const float* okt = ok_s + cur * BN;

    // S = Q.K^T: 16 rows x 32 keys a warp, 4 n-tiles; the two small terms
    // of 3xTF32 in their own accumulator, added once per tile
    float s[4][4], small[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = small[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      load_a_split<S>(ah, al, qh, ql, lr, 8 * kk, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* kr = kt + (c0 + 8 * j + g) * S + 8 * kk + t;  // B[d][key] = k[key][d]
        uint32_t h0, l0, h1, l1;
        split(kr[0], h0, l0);
        split(kr[4], h1, l1);
        mma_tf32(small[j], al, h0, h1);
        mma_tf32(small[j], ah, l0, l1);
        mma_tf32(s[j], ah, h0, h1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];

    // the select (-inf where not allowed) and this tile's row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = c0 + 8 * j + 2 * t + (e & 1);
        const int gr = e < 2 ? gr0 : gr1;
        const bool allowed = okt[lc] != 0.f && (!CAUSAL || col0 + lc <= gr + offset);
        s[j][e] = allowed ? s[j][e] : -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // rescale by exp(m_old - m_new); 1 where the max did not move (also
    // while the row has seen no key: m_old = m_new = -inf)
    const float alpha0 = m0 == n0 ? 1.f : __expf(m0 - n0);
    const float alpha1 = m1 == n1 ? 1.f : __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked entry is 0 by select (exp(-inf - m) would be NaN while
        // the row has seen no key)
        const float p = s[j][e] == -INFINITY ? 0.f : __expf(s[j][e] - (e < 2 ? n0 : n1));
        s[j][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P.V, the sum over this warp's keys in the permuted order
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      a_from_c(ph, pl, s[kk]);
      mma3_columns<DV>(acc, ph, pl, vt, c0 / 8 + kk, g, t);
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

  // the row sums over the quad
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }

  // the second half's state into the first's, through the v stages and the
  // q tiles (read no more: the barrier covers a block that ran no kv tile)
  __syncthreads();
  float* red = v_s + group * (DV / 2) * 32 + lane;     // 4 x (DV / 2) x 32 floats (< one stage), lane-contiguous
  float* ml = ql_s + (group * 32 + lane) * 4;          // (m0, m1, l0, l1) a thread
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32] = acc[n][e];
    *reinterpret_cast<float4*>(ml) = make_float4(m0, m1, l0, l1);
  }
  __syncthreads();
  if (half == 1) return;
  const float4 other = *reinterpret_cast<const float4*>(ml);
  const float mx0 = fmaxf(m0, other.x), mx1 = fmaxf(m1, other.y);
  const float wa0 = weight(m0, mx0), wb0 = weight(other.x, mx0);
  const float wa1 = weight(m1, mx1), wb1 = weight(other.y, mx1);
  const float l_0 = l0 * wa0 + other.z * wb0, l_1 = l1 * wa1 + other.w * wb1;
  // a row that saw no key has l = 0: o = 0 and lse = MASK, as on the TPU
  const float inv0 = l_0 > 0.f ? 1.f / l_0 : 0.f, inv1 = l_1 > 0.f ? 1.f / l_1 : 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    acc[n][0] = (acc[n][0] * wa0 + red[(4 * n + 0) * 32] * wb0) * inv0;
    acc[n][1] = (acc[n][1] * wa0 + red[(4 * n + 1) * 32] * wb0) * inv0;
    acc[n][2] = (acc[n][2] * wa1 + red[(4 * n + 2) * 32] * wb1) * inv1;
    acc[n][3] = (acc[n][3] * wa1 + red[(4 * n + 3) * 32] * wb1) * inv1;
  }
  store_rows<DV>(o + bh * (size_t)I * DV, acc, gr0, gr1, I, t);
  if (t == 0) {
    if (gr0 < I) lse[bh * I + gr0] = l_0 > 0.f ? mx0 + logf(l_0) : MASK;
    if (gr1 < I) lse[bh * I + gr1] = l_1 > 0.f ? mx1 + logf(l_1) : MASK;
  }
}

template <int D, int DV, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const float* q, const float* k, const float* v, const uint8_t* pad, float* o,
                   float* lse, int B, int H, int I, int J, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<D, DV, CAUSAL, HAS_PAD>;
  constexpr int smem = SMEM<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((I + BM - 1) / BM, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, pad, o, lse, H, I, J);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t dispatch_mask(const float* q, const float* k, const float* v, const uint8_t* pad, float* o,
                          float* lse, int B, int H, int I, int J, int causal, cudaStream_t s) {
  if (causal) {
    return pad ? launch<D, DV, true, true>(q, k, v, pad, o, lse, B, H, I, J, s)
               : launch<D, DV, true, false>(q, k, v, pad, o, lse, B, H, I, J, s);
  }
  return pad ? launch<D, DV, false, true>(q, k, v, pad, o, lse, B, H, I, J, s)
             : launch<D, DV, false, false>(q, k, v, pad, o, lse, B, H, I, J, s);
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), k (B,H,J,D) and v
// (B,H,J,DV) contiguous fp32 on 16-byte aligned bases; pad (B,J) uint8 or
// null; o (B,H,I,DV) fp32 on a 16-byte aligned base; lse (B,H,I) fp32.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a (D, DV)
// pair it does not instantiate).
extern "C" int flash_attention_fwd_tf32x3(const void* q, const void* k, const void* v, const void* pad,
                                          void* o, void* lse, int B, int H, int I, int J, int D,
                                          int DV, int causal, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* p = static_cast<const uint8_t*>(pad);
  float* of = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TF32_CASE(PD, PDV) \
  if (D == PD && DV == PDV) return dispatch_mask<PD, PDV>(qf, kf, vf, p, of, l, B, H, I, J, causal, s);
  FLASH_HEAD_DIM_PAIRS(TF32_CASE)
#undef TF32_CASE
  return cudaErrorInvalidValue;
}
