// Ragged paged attention for Hopper (sm_90a), split over the keys: K4's
// `split` route for decode rows (at most 16 queries a row), fp32 or bf16
// queries over pools of q's type or int8 with fp32 scales.
//
// Replaces the Pallas TPU kernel in perceiver_io_tpu/ops/ragged_attention.py
// (`_make_kernel`, :82, launched by `_launch`, :156), as the other routes do
// (csrc/ragged_paged_attention_tc.cu for window rows; the first design,
// csrc/ragged_paged_attention.cu, reached by name only). Same function:
// pre-scaled queries q (B, H, Q, D) over a flat token-major k/v pool
// (T, H, D) addressed through a block table (B, pages) and per-row lengths
// (B,); query qi of row r sits at position lengths[r] - Q + qi and sees pool
// positions pos < min(pages * bs, lengths[r] - Q + 1 + qi). fp32 softmax with
// a -1e30 running-max sentinel, masked probabilities zeroed by select, output
// acc / max(l, 1e-30) in q's type (rows with lengths <= 0 give exact zeros);
// int8 pools dequantized as int8 * scale in fp32.
//
// What bounds it on the H100: a decode row does 4*D flops per key against
// 2*D pool values read, about one flop per byte in fp32, so it is bound by
// the bytes of the live k/v pages. The first design ran one block per (head,
// row), 32 blocks for 4 slots on 132 SMs, and scored keys with 4-byte loads
// and a warp-wide butterfly per key. Here each row's key span is cut into
// splits of SPLIT = 64 keys (four 16-token pages) and the grid is
// (splits, H, B): 512 blocks for 4 rows of 1024 keys. A block looks up its
// keys' pool rows in the table once, reads every k and v row with 16-byte
// coalesced loads (4 fp32, 8 bf16 or 16 int8 values a thread), all of a
// thread's loads in flight before the first is used, dequantizes on the way
// into shared memory, computes the split's partial (m, l, acc) for each query
// in fp32 on the CUDA cores (tensor cores buy nothing at a flop per byte) and
// writes it to fp32 scratch. A split past the row's live span writes l = 0
// and reads nothing. A second launch merges each (row, head, query):
//   m = max m_s,  l = sum l_s e^(m_s - m),  o = sum acc_s e^(m_s - m) / max(l, 1e-30),
// over the splits with l_s > 0 (the others are selected out, never
// multiplied), with no atomics. The split size does not depend on the batch,
// so a row's result does not either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"  // unpack, store

namespace {

constexpr int SPLIT = 64;     // keys per split
constexpr int MAX_ROWS = 16;  // queries a row this route takes
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;  // the TPU kernel's finite sentinel

// The first `rows` (<= ROWS) rows of D values into fp32 shared memory (row
// stride `stride`), row i read from `src + off[i]` and multiplied by scale[i]
// (SCALED), or zeros where off[i] < 0. Every 16-byte load of the thread is
// issued before the first store, so they are all in flight at once.
template <typename P, int D, int ROWS, bool SCALED>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const P* __restrict__ src,
                                           const long long* off, const float* scale, int rows) {
  constexpr int VEC = 16 / sizeof(P);  // values per 16-byte load
  constexpr int PER_ROW = D / VEC;
  constexpr int ITERS = (ROWS * PER_ROW + THREADS - 1) / THREADS;
  uint4 raw[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * VEC;
    raw[it] = idx < rows * PER_ROW && off[r] >= 0
                  ? *reinterpret_cast<const uint4*>(src + off[r] + c)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    if (idx < rows * PER_ROW) {
      const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * VEC;
      float vals[VEC];
      unpack(raw[it], vals);
      const float f = SCALED ? scale[r] : 1.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[r * stride + c + e] = SCALED ? vals[e] * f : vals[e];
    }
  }
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(THREADS)
ragged_split_kernel(const T* __restrict__ q, const P* __restrict__ pk, const P* __restrict__ pv,
                    const float* __restrict__ sk, const float* __restrict__ sv,
                    const int* __restrict__ table, const int* __restrict__ lengths,
                    float* __restrict__ part_ml, float* __restrict__ part_acc, int H, int Q,
                    int pages, int bs) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int DP = D + 1;  // odd row stride: the per-key dot products are free of bank conflicts
  extern __shared__ float smem[];
  float* k_s = smem;                 // SPLIT x DP
  float* v_s = k_s + SPLIT * DP;     // SPLIT x D
  float* sk_s = v_s + SPLIT * D;     // SPLIT: k scale of each key
  float* sv_s = sk_s + SPLIT;        // SPLIT: v scale
  long long* off_s = reinterpret_cast<long long*>(sv_s + SPLIT);  // SPLIT: pool offset, -1 = none
  long long* qoff_s = off_s + SPLIT;                                // MAX_ROWS: q row offsets
  float* q_s = reinterpret_cast<float*>(qoff_s + MAX_ROWS);        // Q x D
  float* s_s = q_s + Q * D;                                         // Q x SPLIT: scores, then p

  const int tid = threadIdx.x;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int hh = blockIdx.y, r = blockIdx.z;
  const size_t rh = (size_t)r * H + hh;
  const int col0 = split * SPLIT;
  const int L = lengths[r];
  const int n_keys = max(0, min(L, pages * bs));  // the row's live span
  // this split's partials: (m, l) per query, then acc per query
  float* ml = part_ml + (rh * n_splits + split) * Q * 2;
  float* acc_out = part_acc + (rh * n_splits + split) * (size_t)Q * D;

  if (col0 >= n_keys) {  // past the live span: nothing to read
    for (int i = tid; i < Q; i += THREADS) {
      ml[2 * i] = NEG;
      ml[2 * i + 1] = 0.f;
    }
    return;
  }
  const int kc = min(SPLIT, n_keys - col0);  // live keys in this split
  if (tid < SPLIT) {  // one table lookup per key
    long long off = -1;
    float a = 1.f, b = 1.f;
    if (tid < kc) {
      const int pos = col0 + tid;
      const long long tok = (long long)table[(size_t)r * pages + pos / bs] * bs + pos % bs;
      off = (tok * H + hh) * D;
      if (QUANT) {
        a = sk[tok * H + hh];
        b = sv[tok * H + hh];
      }
    }
    off_s[tid] = off;
    sk_s[tid] = a;
    sv_s[tid] = b;
  }
  if (tid < MAX_ROWS) qoff_s[tid] = tid < Q ? (long long)(rh * Q + tid) * D : -1;
  __syncthreads();

  stage_rows<T, D, MAX_ROWS, false>(q_s, D, q, qoff_s, nullptr, Q);
  stage_rows<P, D, SPLIT, QUANT>(k_s, DP, pk, off_s, sk_s, SPLIT);
  stage_rows<P, D, SPLIT, QUANT>(v_s, D, pv, off_s, sv_s, SPLIT);
  __syncthreads();

  // query qi sees the keys below lim(qi) = L - Q + 1 + qi (and the span)
  const int lim0 = L - Q + 1 - col0;  // lim(0) in this split's key index

  // scores: thread (key, query group), queries qg, qg + 2, ...
  {
    const int key = tid % SPLIT;
    for (int i = tid / SPLIT; i < Q; i += THREADS / SPLIT) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(q_s[i * D + d], k_s[key * DP + d], s);
      s_s[i * SPLIT + key] = key < kc && key < lim0 + i ? s : NEG;
    }
  }
  __syncthreads();

  // softmax of each query over the split: warp w takes queries w, w + 4, ...;
  // lane takes keys lane and lane + 32
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int i = warp; i < Q; i += THREADS / 32) {
      const bool ok0 = lane < kc && lane < lim0 + i;
      const bool ok1 = lane + 32 < kc && lane + 32 < lim0 + i;
      const float s0 = s_s[i * SPLIT + lane], s1 = s_s[i * SPLIT + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float p0 = ok0 ? expf(s0 - mx) : 0.f;
      const float p1 = ok1 ? expf(s1 - mx) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      s_s[i * SPLIT + lane] = p0;
      s_s[i * SPLIT + lane + 32] = p1;
      if (lane == 0) {
        ml[2 * i] = mx;  // NEG where the query sees no key of this split (then l = 0)
        ml[2 * i + 1] = sum;
      }
    }
  }
  __syncthreads();

  // acc = p . v: thread d takes column d of every query
  for (int d = tid; d < D; d += THREADS) {
    for (int i = 0; i < Q; ++i) {
      float a = 0.f;
#pragma unroll 8
      for (int key = 0; key < SPLIT; ++key) a = fmaf(s_s[i * SPLIT + key], v_s[key * D + d], a);
      acc_out[(size_t)i * D + d] = a;
    }
  }
}

// One block per (query, head, row): merges the splits of that query.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ragged_split_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                          T* __restrict__ o, int H, int Q, int n_splits) {
  const int i = blockIdx.x;
  const size_t rh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* ml = part_ml + rh * n_splits * Q * 2;
  const float* acc = part_acc + rh * n_splits * Q * D;
  float m = NEG;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + ((size_t)s * Q + i) * 2;
    if (p[1] > 0.f) m = fmaxf(m, p[0]);
  }
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + ((size_t)s * Q + i) * 2;
    if (p[1] > 0.f) l += p[1] * expf(p[0] - m);
  }
  const float denom = fmaxf(l, 1e-30f);  // l = 0 (no key seen): acc = 0, o = 0
  T* orow = o + (rh * Q + i) * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* p = ml + ((size_t)s * Q + i) * 2;
      if (p[1] > 0.f) a += acc[((size_t)s * Q + i) * D + d] * expf(p[0] - m);
    }
    store(&orow[d], a / denom);
  }
}

template <int D>
constexpr size_t smem_bytes(int Q) {
  return sizeof(float) * (SPLIT * (D + 1) + SPLIT * D + 2 * SPLIT + Q * D + Q * SPLIT) +
         sizeof(long long) * (SPLIT + MAX_ROWS);
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv, const float* sk, const float* sv,
                   const int* table, const int* lengths, void* o, float* part_ml, float* part_acc,
                   int B, int H, int Q, int pages, int bs, int n_splits, cudaStream_t stream) {
  auto kernel = ragged_split_kernel<T, P, D>;
  const size_t smem = smem_bytes<D>(Q);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_splits, H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv), sk, sv, table,
      lengths, part_ml, part_acc, H, Q, pages, bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ragged_split_merge_kernel<T, D><<<dim3(Q, H, B), THREADS, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(o), H, Q, n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_pool(const void* q, const void* pk, const void* pv, const float* sk,
                          const float* sv, const int* table, const int* lengths, void* o,
                          float* ml, float* acc, int B, int H, int Q, int pages, int bs, int n,
                          int quantized, cudaStream_t s) {
  if (quantized)
    return launch<T, int8_t, D>(q, pk, pv, sk, sv, table, lengths, o, ml, acc, B, H, Q, pages, bs,
                                n, s);
  return launch<T, T, D>(q, pk, pv, sk, sv, table, lengths, o, ml, acc, B, H, Q, pages, bs, n, s);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* pk, const void* pv, const float* sk,
                         const float* sv, const int* table, const int* lengths, void* o, float* ml,
                         float* acc, int B, int H, int Q, int D, int pages, int bs, int n,
                         int quantized, cudaStream_t s) {
  switch (D) {
    case 64:
      return dispatch_pool<T, 64>(q, pk, pv, sk, sv, table, lengths, o, ml, acc, B, H, Q, pages,
                                  bs, n, quantized, s);
    case 96:
      return dispatch_pool<T, 96>(q, pk, pv, sk, sv, table, lengths, o, ml, acc, B, H, Q, pages,
                                  bs, n, quantized, s);
    case 112:
      return dispatch_pool<T, 112>(q, pk, pv, sk, sv, table, lengths, o, ml, acc, B, H, Q, pages,
                                   bs, n, quantized, s);
    case 128:
      return dispatch_pool<T, 128>(q, pk, pv, sk, sv, table, lengths, o, ml, acc, B, H, Q, pages,
                                   bs, n, quantized, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. q and o (B, H, Q, D) contiguous in q's
// type with Q <= 16; pool_k, pool_v (pages_total * block_size, H, D) in q's
// type, or int8 when quantized, with scale_k, scale_v (same rows, H) fp32
// (else null); q and the pools on 16-byte aligned bases; table (B, pages)
// int32; lengths (B,) int32; scratch part_ml (B, H, n_splits, Q, 2) and
// part_acc (B, H, n_splits, Q, D) fp32 with n_splits =
// ceil(pages * block_size / ragged_paged_attention_split_size()). dtype:
// 0 = float32, 1 = bfloat16. Returns the launches' cudaError_t.
extern "C" int ragged_paged_attention_split(const void* q, const void* pool_k, const void* pool_v,
                                            const void* scale_k, const void* scale_v,
                                            const void* table, const void* lengths, void* o,
                                            void* part_ml, void* part_acc, int B, int H, int Q,
                                            int D, int pages, int block_size, int n_splits,
                                            int dtype, int quantized, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || Q > MAX_ROWS || pages < 1 || block_size < 1 ||
      n_splits != (pages * block_size + SPLIT - 1) / SPLIT)
    return cudaErrorInvalidValue;
  if (quantized && (scale_k == nullptr || scale_v == nullptr)) return cudaErrorInvalidValue;
  const float* sk = static_cast<const float*>(scale_k);
  const float* sv = static_cast<const float*>(scale_v);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, pool_k, pool_v, sk, sv, tb, ln, o, ml, acc, B, H, Q, D, pages,
                               block_size, n_splits, quantized, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, pool_k, pool_v, sk, sv, tb, ln, o, ml, acc, B, H, Q, D,
                                       pages, block_size, n_splits, quantized, s);
  return cudaErrorInvalidValue;
}

extern "C" int ragged_paged_attention_split_size() { return SPLIT; }

// Head dims this library instantiates, for the wrapper's checks.
extern "C" int ragged_paged_attention_split_supports_head_dim(int d) {
  return d == 64 || d == 96 || d == 112 || d == 128;
}
