// Flash attention forward for Hopper (sm_90a), with Perceiver masking.
//
// Replaces the Pallas TPU kernel `_forward` in
// perceiver_io_tpu/ops/flash_attention.py (K1). Same function: blockwise
// online-softmax attention over pre-scaled queries, right-aligned causal
// mask `col <= row + (j - i)` with kv tiles wholly above the shifted
// diagonal skipped, an optional (b, j) key pad mask (1 = pad), fp32
// accumulation, and zero output for a query row that sees no key. Outputs o
// (b, h, i, d) in the input type and lse (b, h, i) fp32 (not lane-replicated).
//
// What bounds it on the H100: at the serving path's shapes (i = 512 latents,
// j = 1024 or 512 keys, d = 112) attention does ~2*i*j*d*2 flops per head
// against ~(i + 2j)*d*bytes of traffic, about 300 flops per byte in bf16 --
// at the tensor-core ridge, and far above it for the fp32 CUDA cores. So the
// kernel is bound by arithmetic. This first version spends its arithmetic on
// the CUDA cores in fp32 (no tensor cores); what the design does about the
// bound is to never write the (i, j) score matrix to device memory (scores
// and probabilities live in registers and one shared tile), to read each k/v
// tile once per 64-row query tile, and to skip the kv tiles the causal mask
// removes. Moving the two products onto wgmma is the next step.
//
// Schedule: one block of 256 threads per (64-row query tile, head, batch).
// A 16 x 16 thread grid owns a 64 x 64 score tile: thread (ty, tx) holds rows
// ty + 16*r and columns tx + 16*c (r, c < 4), so each row's reductions stay
// inside one half-warp (shuffles of width 16). The query tile stays in
// shared memory; each kv tile is staged there as fp32, the probabilities go
// through a padded shared tile into the p.v product, and the output tile
// (64 x D) lives in registers, D/16 columns per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16
// Large-but-finite mask value, as the TPU kernel's: exp(MASK - m) underflows
// to exactly 0 and MASK - MASK stays finite.
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p is cast to the value type before the p.v product, as the TPU kernel does.
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int D, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ pad, T* __restrict__ o, float* __restrict__ lse,
                 int H, int I, int J) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;    // padded row stride of the q/k tiles
  constexpr int PP = BN + 1;   // padded row stride of the probability tile
  constexpr int DC = D / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;              // BM x DP
  float* k_s = q_s + BM * DP;     // BN x DP
  float* v_s = k_s + BN * DP;     // BN x D
  float* p_s = v_s + BN * D;      // BM x PP
  float* ok_s = p_s + BM * PP;    // BN: 1 = key not padded

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const size_t bh = (size_t)bb * H + hh;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * D;
  const int offset = J - I;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int gr = row0 + r;
    q_s[r * DP + d] = gr < I ? to_float(qg[(size_t)gr * D + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (J + BN - 1) / BN;
  if (CAUSAL) {
    // last column any row of this tile may see: (last row) + offset
    const int last_row = min(row0 + BM, I) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / BN + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int col0 = t * BN;
    __syncthreads();  // previous tile's k/v/p no longer read
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int gc = col0 + c;
      const bool in = gc < J;
      k_s[c * DP + d] = in ? to_float(kg[(size_t)gc * D + d]) : 0.f;
      v_s[c * D + d] = in ? to_float(vg[(size_t)gc * D + d]) : 0.f;
    }
    if (tid < BN) {
      const int gc = col0 + tid;
      ok_s[tid] = (gc < J && (!HAS_PAD || pad[(size_t)bb * J + gc] == 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    // s = q . k^T for this thread's 4 x 4 entries
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = q_s[(ty + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    // mask, online softmax (row state replicated across the 16 tx lanes)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + ty + 16 * r;
      bool allowed[4];
      float mx = MASK;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = tx + 16 * c;
        allowed[c] = ok_s[lc] != 0.f && (!CAUSAL || col0 + lc <= gr + offset);
        if (!allowed[c]) s[r][c] = MASK;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w, 16));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = allowed[c] ? expf(s[r][c] - m_new) : 0.f;
        rowsum += p;
        p_s[(ty + 16 * r) * PP + tx + 16 * c] = round_like(p, T());
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) rowsum += __shfl_xor_sync(0xffffffffu, rowsum, w, 16);
      l_i[r] = alpha * l_i[r] + rowsum;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = p_s[(ty + 16 * r) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[n * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  T* og = o + bh * (size_t)I * D;
  float* lg = lse + bh * (size_t)I;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + ty + 16 * r;
    if (gr >= I) continue;
    // a row that saw no key has l == 0: zero output, as on the TPU
    const float safe_l = l_i[r] > 0.f ? l_i[r] : 1.f;
    const float inv = l_i[r] > 0.f ? 1.f / safe_l : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&og[(size_t)gr * D + tx + 16 * c], acc[r][c] * inv);
    if (tx == 0) lg[gr] = m_i[r] + logf(safe_l);
  }
}

template <typename T, int D, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* pad, void* o,
                   float* lse, int B, int H, int I, int J, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, CAUSAL, HAS_PAD>;
  const size_t smem =
      sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + BN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((I + BM - 1) / BM, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), pad, static_cast<T*>(o),
                                          lse, H, I, J);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_mask(const void* q, const void* k, const void* v, const uint8_t* pad,
                          void* o, float* lse, int B, int H, int I, int J, int causal,
                          cudaStream_t s) {
  if (causal) {
    return pad ? launch<T, D, true, true>(q, k, v, pad, o, lse, B, H, I, J, s)
               : launch<T, D, true, false>(q, k, v, pad, o, lse, B, H, I, J, s);
  }
  return pad ? launch<T, D, false, true>(q, k, v, pad, o, lse, B, H, I, J, s)
             : launch<T, D, false, false>(q, k, v, pad, o, lse, B, H, I, J, s);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const uint8_t* pad,
                         void* o, float* lse, int B, int H, int I, int J, int D, int causal,
                         cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_mask<T, 64>(q, k, v, pad, o, lse, B, H, I, J, causal, s);
    case 112: return dispatch_mask<T, 112>(q, k, v, pad, o, lse, B, H, I, J, causal, s);
    case 128: return dispatch_mask<T, 128>(q, k, v, pad, o, lse, B, H, I, J, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), k and v (B,H,J,D) contiguous;
// pad (B,J) uint8 or null; o (B,H,I,D) in the input type; lse (B,H,I) fp32.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* pad, void* o, void* lse, int B, int H, int I,
                                   int J, int D, int causal, int dtype, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(pad);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(q, k, v, p, o, l, B, H, I, J, D, causal, s);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(q, k, v, p, o, l, B, H, I, J, D, causal, s);
  return cudaErrorInvalidValue;
}

// Head dims this library instantiates, for the wrapper's checks.
extern "C" int flash_attention_fwd_supports_head_dim(int d) {
  return d == 64 || d == 112 || d == 128;
}
