// Flash attention forward for Hopper (sm_90a), split over the keys: K1's
// route for decode attends (at most 16 query rows), fp32 or bf16.
//
// Replaces the Pallas TPU kernel `_forward` in
// perceiver_io_tpu/ops/flash_attention.py (K1), as its other two routes do
// (csrc/flash_attention_fwd.cu, csrc/flash_attention_fwd_wgmma.cu). Same
// function: attention over pre-scaled queries with the right-aligned causal
// mask `col <= row + (j - i)`, an optional (b, j) key pad mask (1 = pad),
// fp32 softmax and sums, p cast to v's type before p.v, o (b, h, i, dv) in
// the input type and lse (b, h, i) fp32; a row that sees no key gets o = 0
// and lse = MASK. v has a head dim of its own, dv (the DV template argument
// beside D; csrc/head_dims.cuh lists the pairs).
//
// What bounds it on the H100: at q_len = 1 each key is read once and used
// for 2*d + 2*dv flops, about 1 flop per byte, so the attend is bound by the bytes
// of k and v. One block per (query tile, head, batch), as in the tile
// kernels, would give b*h = 32 blocks for 132 SMs and idle 63 of every 64
// score products. Here the keys are cut into splits of SPLIT = 64 and the
// grid is (splits, h, b): 512 blocks at j = 1024. Each block reads its
// split's keys and values with 16-byte coalesced loads, computes the partial
// (m, l, acc) of every query row on the CUDA cores in fp32 (tensor cores buy
// nothing at a flop per byte) and writes it to scratch; a second launch
// merges the splits of each row:
//   m = max m_s,  l = sum l_s e^(m_s - m),  o = sum acc_s e^(m_s - m) / l.
// A split that no row sees is skipped: one whose keys are all padded (or past
// j) writes l = 0 without reading k or v. (Under the right-aligned causal mask
// the last row sees every key, so the causal bound alone never empties a
// split.) A split with l_s = 0 adds nothing to the merge. The split
// size does not depend on the batch, so a row's result does not either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dims.cuh"  // FLASH_HEAD_DIM_PAIRS
#include "vec16.cuh"  // unpack, store

namespace {

constexpr int SPLIT = 64;    // keys per split
constexpr int MAX_ROWS = 16;  // query rows this route takes
constexpr int THREADS = 128;
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// ROWS x D elements of a row-major (n, D) matrix from `src` row r0 on, as
// fp32 into dst with row stride `stride`; rows past n are 0. Every 16-byte
// load of the thread is issued before the first store, so they are all in
// flight at once.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* src, int r0, int n) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = D / VEC;
  constexpr int ITERS = (ROWS * PER_ROW + THREADS - 1) / THREADS;
  uint4 raw[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * VEC;
    raw[it] = idx < ROWS * PER_ROW && r0 + r < n
                  ? *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    if (idx < ROWS * PER_ROW) {
      const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * VEC;
      float vals[VEC];
      unpack(raw[it], vals);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[r * stride + c + e] = vals[e];
    }
  }
}

template <typename T, int D, int DV, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const uint8_t* __restrict__ pad, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int H, int I, int J) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  constexpr int DP = D + 1;  // odd row stride: the per-key dot products are free of bank conflicts
  extern __shared__ float smem[];
  float* q_s = smem;                   // I x D
  float* k_s = q_s + MAX_ROWS * D;     // SPLIT x DP
  float* v_s = k_s + SPLIT * DP;       // SPLIT x DV
  float* s_s = v_s + SPLIT * DV;       // I x SPLIT: scores, then p
  float* ok_s = s_s + MAX_ROWS * SPLIT;  // SPLIT: 1 = key in range and not padded

  const int tid = threadIdx.x;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int bb = blockIdx.z;
  const size_t bh = (size_t)bb * H + blockIdx.y;
  const int col0 = split * SPLIT;
  const int offset = J - I;
  // this split's partials: (m, l) per row, then acc per row
  float* ml = part_ml + ((bh * n_splits + split) * I) * 2;
  float* acc_out = part_acc + ((bh * n_splits + split) * I) * DV;

  int seen = 0;
  if (tid < SPLIT) {
    const int key = col0 + tid;
    const bool ok = key < J && (!HAS_PAD || pad[(size_t)bb * J + key] == 0);
    ok_s[tid] = ok ? 1.f : 0.f;
    seen = ok;
  }
  if (!__syncthreads_or(seen)) {  // every key padded: nothing to read
    if (tid < I) {
      ml[2 * tid] = MASK;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  stage_rows<T, D, MAX_ROWS>(q_s, D, q + bh * I * D, 0, I);
  stage_rows<T, D, SPLIT>(k_s, DP, k + bh * J * D, col0, J);
  stage_rows<T, DV, SPLIT>(v_s, DV, v + bh * J * DV, col0, J);
  __syncthreads();

  // scores: thread (key, row group), rows rg, rg + 2, ...
  {
    const int key = tid % SPLIT;
    const bool key_ok = ok_s[key] != 0.f;
    for (int row = tid / SPLIT; row < I; row += THREADS / SPLIT) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(q_s[row * D + d], k_s[key * DP + d], s);
      const bool ok = key_ok && (!CAUSAL || col0 + key <= row + offset);
      s_s[row * SPLIT + key] = ok ? s : -INFINITY;
    }
  }
  __syncthreads();

  // softmax of each row over the split: warp w takes rows w, w + 4, ...;
  // lane takes keys lane and lane + 32
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int row = warp; row < I; row += THREADS / 32) {
      const float s0 = s_s[row * SPLIT + lane], s1 = s_s[row * SPLIT + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_use = mx == -INFINITY ? 0.f : mx;  // row sees no key here: p = 0
      const float p0 = __expf(s0 - m_use), p1 = __expf(s1 - m_use);
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      s_s[row * SPLIT + lane] = round_like(p0, T());
      s_s[row * SPLIT + lane + 32] = round_like(p1, T());
      if (lane == 0) {
        ml[2 * row] = mx == -INFINITY ? MASK : mx;
        ml[2 * row + 1] = sum;
      }
    }
  }
  __syncthreads();

  // acc = p . v: thread d takes column d of every row
  for (int d = tid; d < DV; d += THREADS) {
    for (int row = 0; row < I; ++row) {
      float a = 0.f;
#pragma unroll 8
      for (int key = 0; key < SPLIT; ++key) a = fmaf(s_s[row * SPLIT + key], v_s[key * DV + d], a);
      acc_out[(size_t)row * DV + d] = a;
    }
  }
}

// One block per (row, head, batch): merges the row's splits.
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_split_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                             T* __restrict__ o, float* __restrict__ lse, int H, int I,
                             int n_splits) {
  const int row = blockIdx.x;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* ml = part_ml + bh * n_splits * I * 2;
  const float* acc = part_acc + bh * n_splits * I * DV;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + ((size_t)s * I + row) * 2;
    if (p[1] > 0.f) m = fmaxf(m, p[0]);
  }
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + ((size_t)s * I + row) * 2;
    if (p[1] > 0.f) l += p[1] * __expf(p[0] - m);
  }
  const bool live = l > 0.f;  // a row that sees no key: zero output and lse = MASK
  const float inv = live ? 1.f / l : 0.f;
  T* orow = o + (bh * I + row) * DV;
  for (int d = threadIdx.x; d < DV; d += THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* p = ml + ((size_t)s * I + row) * 2;
      if (p[1] > 0.f) a += acc[((size_t)s * I + row) * DV + d] * __expf(p[0] - m);
    }
    store(&orow[d], a * inv);
  }
  if (threadIdx.x == 0) lse[bh * I + row] = live ? m + logf(l) : MASK;
}

template <typename T, int D, int DV, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* pad, void* o,
                   float* lse, float* part_ml, float* part_acc, int B, int H, int I, int J,
                   int n_splits, cudaStream_t stream) {
  auto kernel = flash_fwd_split_kernel<T, D, DV, CAUSAL, HAS_PAD>;
  const size_t smem =
      sizeof(float) * (MAX_ROWS * D + SPLIT * (D + 1) + SPLIT * DV + MAX_ROWS * SPLIT + SPLIT);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_splits, H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pad, part_ml,
      part_acc, H, I, J);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_fwd_split_merge_kernel<T, DV><<<dim3(I, H, B), THREADS, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(o), lse, H, I, n_splits);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t dispatch_mask(const void* q, const void* k, const void* v, const uint8_t* pad,
                          void* o, float* lse, float* ml, float* acc, int B, int H, int I, int J,
                          int n, int causal, cudaStream_t s) {
  if (causal) {
    return pad ? launch<T, D, DV, true, true>(q, k, v, pad, o, lse, ml, acc, B, H, I, J, n, s)
               : launch<T, D, DV, true, false>(q, k, v, pad, o, lse, ml, acc, B, H, I, J, n, s);
  }
  return pad ? launch<T, D, DV, false, true>(q, k, v, pad, o, lse, ml, acc, B, H, I, J, n, s)
             : launch<T, D, DV, false, false>(q, k, v, pad, o, lse, ml, acc, B, H, I, J, n, s);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const uint8_t* pad,
                         void* o, float* lse, float* ml, float* acc, int B, int H, int I, int J,
                         int D, int DV, int n, int causal, cudaStream_t s) {
#define SPLIT_CASE(PD, PDV)                                                                   \
  if (D == PD && DV == PDV)                                                                   \
    return dispatch_mask<T, PD, PDV>(q, k, v, pad, o, lse, ml, acc, B, H, I, J, n, causal, s);
  FLASH_HEAD_DIM_PAIRS(SPLIT_CASE)
#undef SPLIT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D) with I <= 16, k (B,H,J,D)
// and v (B,H,J,DV), contiguous with 16-byte aligned bases; pad (B,J) uint8
// or null; o (B,H,I,DV) in the input type; lse (B,H,I) fp32; scratch part_ml
// (B,H,n_splits,I,2) and part_acc (B,H,n_splits,I,DV) fp32, with n_splits =
// ceil(J / flash_attention_fwd_split_size()). dtype: 0 = float32,
// 1 = bfloat16. Returns the launches' cudaError_t.
extern "C" int flash_attention_fwd_split(const void* q, const void* k, const void* v,
                                         const void* pad, void* o, void* lse, void* part_ml,
                                         void* part_acc, int B, int H, int I, int J, int D,
                                         int DV, int n_splits, int causal, int dtype,
                                         void* stream) {
  if (I < 1 || I > MAX_ROWS || n_splits != (J + SPLIT - 1) / SPLIT) return cudaErrorInvalidValue;
  const uint8_t* p = static_cast<const uint8_t*>(pad);
  float* l = static_cast<float*>(lse);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, p, o, l, ml, acc, B, H, I, J, D, DV, n_splits, causal, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, p, o, l, ml, acc, B, H, I, J, D, DV, n_splits,
                                       causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_fwd_split_size() { return SPLIT; }
