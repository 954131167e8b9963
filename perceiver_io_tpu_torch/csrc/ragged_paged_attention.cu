// Ragged paged attention for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU kernel in perceiver_io_tpu/ops/ragged_attention.py
// (`_make_kernel` + `_launch`, public `ragged_paged_attention`). Same
// function: attention of pre-scaled, pre-rotated queries q (B, H, Q, D) over
// a flat token-major k/v pool (T, H, D), addressed through a block table
// (B, pages) int32 and per-row lengths (B,) int32. Query qi of row r sits at
// position lengths[r] - Q + qi and sees pool positions pos with
// pos + (Q - 1) - qi < lengths[r]. Online softmax in fp32 with a -1e30
// running-max sentinel, masked probabilities zeroed explicitly, output
// acc / max(l, 1e-30) in q's type: rows with lengths <= 0 give exact zeros.
// The pool is q's type, or int8 with fp32 per-(position, head) scales
// (T, H) dequantized in registers on the page being read. No output
// projection.
//
// What bounds it on the H100: the live k/v pages. A decode row (Q = 1) does
// 4*D flops per key against 2*D*bytes of k/v read: ~0.5 flop per byte in
// fp32, so it is bound by device memory. A window row (Q = 512 latents)
// reads each key once per 64-query tile and does ~4*D*Q flops per key, far
// above the ridge for the CUDA cores' fp32 rate: bound by arithmetic.
// What the design does about it: where the TPU kernel walks every page of
// the table and masks, this one loops only over the row's live pages,
// ceil(min(lengths[r], lengths[r] - Q + qi_max + 1) / block_size) of them,
// so it never reads a page past the span or past its tile's causal bound;
// idle rows read nothing. Scores never reach device memory.
//
// Two schedules:
// - decode (Q == 1): one block of 8 warps per (head, row). The warps split
//   the row's live pages round-robin; each lane owns head-dim columns
//   lane + 32c, each warp keeps its own (m, l, acc) over its pages, keys are
//   scored 8 at a time (butterfly-reduced across the warp), and the 8
//   partial softmaxes merge through shared memory at the end.
// - window (Q > 1): one block of 256 threads per (64-query tile, head, row),
//   the flash-attention forward's tile schedule (csrc/flash_attention_fwd.cu):
//   a 16 x 16 thread grid owns a 64 x 64 score tile; each 64-key tile is
//   staged in shared memory as fp32 after its pool positions are looked up
//   through the table once per key.
// Both are right and simple first: CUDA cores only, no TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;  // the TPU kernel's finite sentinel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------- decode --
constexpr int DEC_WARPS = 8;
constexpr int KC = 8;  // keys scored per butterfly round

template <typename T, typename P, int D, bool QUANT>
__global__ void __launch_bounds__(DEC_WARPS * 32)
ragged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pk, const P* __restrict__ pv,
                     const float* __restrict__ sk, const float* __restrict__ sv,
                     const int* __restrict__ table, const int* __restrict__ lengths,
                     T* __restrict__ o, int H, int pages, int bs) {
  constexpr int DC = (D + 31) / 32;  // head-dim columns per lane
  __shared__ float m_s[DEC_WARPS];
  __shared__ float l_s[DEC_WARPS];
  __shared__ float acc_s[DEC_WARPS][D];

  const int hh = blockIdx.x;
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_keys = max(0, min(lengths[r], pages * bs));
  const int n_pages = (n_keys + bs - 1) / bs;
  const int* trow = table + (size_t)r * pages;
  const T* qg = q + ((size_t)r * H + hh) * D;

  float qv[DC], acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = lane + 32 * c;
    qv[c] = d < D ? to_float(qg[d]) : 0.f;
    acc[c] = 0.f;
  }
  float m = NEG, l = 0.f;

  for (int p = warp; p < n_pages; p += DEC_WARPS) {
    const size_t t0 = (size_t)trow[p] * bs;
    const int kc = min(bs, n_keys - p * bs);  // live keys on this page
    for (int j0 = 0; j0 < kc; j0 += KC) {
      float s[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float part = 0.f;
        if (j0 + j < kc) {
          const size_t row = (t0 + j0 + j) * H + hh;
          const float scale = QUANT ? sk[row] : 1.f;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const int d = lane + 32 * c;
            if (d < D) part = fmaf(qv[c], to_float(pk[row * D + d]) * scale, part);
          }
        }
        s[j] = part;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int w = 16; w >= 1; w >>= 1) s[j] += __shfl_xor_sync(FULL, s[j], w);

      float cmax = NEG;
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j0 + j < kc) cmax = fmaxf(cmax, s[j]);
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] *= alpha;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j0 + j < kc) {
          const float pj = expf(s[j] - m_new);
          psum += pj;
          const size_t row = (t0 + j0 + j) * H + hh;
          const float scale = QUANT ? sv[row] : 1.f;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[c] = fmaf(pj, to_float(pv[row * D + d]) * scale, acc[c]);
          }
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  // merge the warps' partial softmaxes
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) acc_s[warp][d] = acc[c];
  }
  __syncthreads();
  T* og = o + ((size_t)r * H + hh) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, m_s[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = expf(m_s[w] - mx);  // 0 for warps that saw nothing (acc, l = 0 there)
      lsum = fmaf(l_s[w], f, lsum);
      a = fmaf(acc_s[w][d], f, a);
    }
    store(&og[d], a / fmaxf(lsum, 1e-30f));
  }
}

// ---------------------------------------------------------------- window --
constexpr int BM = 64;        // queries per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16

template <typename T, typename P, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
ragged_window_kernel(const T* __restrict__ q, const P* __restrict__ pk, const P* __restrict__ pv,
                     const float* __restrict__ sk, const float* __restrict__ sv,
                     const int* __restrict__ table, const int* __restrict__ lengths,
                     T* __restrict__ o, int H, int Q, int pages, int bs) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;   // padded row stride of the q/k tiles
  constexpr int PP = BN + 1;  // padded row stride of the probability tile
  constexpr int DC = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;                 // BM x DP
  float* k_s = q_s + BM * DP;        // BN x DP
  float* v_s = k_s + BN * DP;        // BN x D
  float* p_s = v_s + BN * D;         // BM x PP
  float* skc_s = p_s + BM * PP;      // BN: k scale of each key (1 when exact)
  float* svc_s = skc_s + BN;         // BN: v scale
  int* tok_s = reinterpret_cast<int*>(svc_s + BN);  // BN: pool row of each key, -1 = none

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int r = blockIdx.z;
  const int L = lengths[r];
  const int* trow = table + (size_t)r * pages;
  const T* qg = q + ((size_t)r * H + hh) * (size_t)Q * D;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int i = idx / D, d = idx - (idx / D) * D;
    const int gi = row0 + i;
    q_s[i * DP + d] = gi < Q ? to_float(qg[(size_t)gi * D + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys this tile's last query may see, within the table's span
  const int last_row = min(row0 + BM, Q) - 1;
  const int n_keys = max(0, min(min(L, L - Q + last_row + 1), pages * bs));
  const int n_tiles = (n_keys + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int col0 = t * BN;
    __syncthreads();  // previous tile's k/v/p no longer read
    if (tid < BN) {
      const int pos = col0 + tid;
      int tok = -1;
      float s_k = 1.f, s_v = 1.f;
      if (pos < n_keys) {
        tok = trow[pos / bs] * bs + pos % bs;
        if (QUANT) {
          s_k = sk[(size_t)tok * H + hh];
          s_v = sv[(size_t)tok * H + hh];
        }
      }
      tok_s[tid] = tok;
      skc_s[tid] = s_k;
      svc_s[tid] = s_v;
    }
    __syncthreads();
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int tok = tok_s[c];
      const size_t off = ((size_t)tok * H + hh) * D + d;
      k_s[c * DP + d] = tok >= 0 ? to_float(pk[off]) * skc_s[c] : 0.f;
      v_s[c * D + d] = tok >= 0 ? to_float(pv[off]) * svc_s[c] : 0.f;
    }
    __syncthreads();

    // s = q . k^T for this thread's 4 x 4 entries
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // causal bound, online softmax (row state replicated across the 16 tx lanes)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = row0 + ty + 16 * i;
      bool valid[4];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pos = col0 + tx + 16 * c;
        valid[c] = pos < n_keys && pos + (Q - 1) - gi < L;
        if (!valid[c]) s[i][c] = NEG;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w, 16));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(s[i][c] - m_new) : 0.f;
        rowsum += p;
        p_s[(ty + 16 * i) * PP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) rowsum += __shfl_xor_sync(FULL, rowsum, w, 16);
      l_i[i] = l_i[i] * alpha + rowsum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv_[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv_[i] = p_s[(ty + 16 * i) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[n * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv_[i], vv[c], acc[i][c]);
    }
  }

  T* og = o + ((size_t)r * H + hh) * (size_t)Q * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = row0 + ty + 16 * i;
    if (gi >= Q) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&og[(size_t)gi * D + tx + 16 * c], acc[i][c] / denom);
  }
}

template <typename T, typename P, int D, bool QUANT>
cudaError_t launch(const void* q, const void* pk, const void* pv, const float* sk,
                   const float* sv, const int* table, const int* lengths, void* o, int B, int H,
                   int Q, int pages, int bs, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const P* pkt = static_cast<const P*>(pk);
  const P* pvt = static_cast<const P*>(pv);
  T* ot = static_cast<T*>(o);
  if (Q == 1) {
    ragged_decode_kernel<T, P, D, QUANT><<<dim3(H, B), DEC_WARPS * 32, 0, stream>>>(
        qt, pkt, pvt, sk, sv, table, lengths, ot, H, pages, bs);
    return cudaGetLastError();
  }
  auto kernel = ragged_window_kernel<T, P, D, QUANT>;
  const size_t smem = sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1)) +
                      BN * (2 * sizeof(float) + sizeof(int));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BM - 1) / BM, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(qt, pkt, pvt, sk, sv, table, lengths, ot, H, Q, pages,
                                          bs);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_pool(const void* q, const void* pk, const void* pv, const float* sk,
                          const float* sv, const int* table, const int* lengths, void* o, int B,
                          int H, int Q, int pages, int bs, int quantized, cudaStream_t s) {
  if (quantized)
    return launch<T, int8_t, D, true>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, s);
  return launch<T, T, D, false>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs, s);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* pk, const void* pv, const float* sk,
                         const float* sv, const int* table, const int* lengths, void* o, int B,
                         int H, int Q, int D, int pages, int bs, int quantized, cudaStream_t s) {
  switch (D) {
    case 64:
      return dispatch_pool<T, 64>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs,
                                  quantized, s);
    case 112:
      return dispatch_pool<T, 112>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs,
                                   quantized, s);
    case 128:
      return dispatch_pool<T, 128>(q, pk, pv, sk, sv, table, lengths, o, B, H, Q, pages, bs,
                                   quantized, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. q and o (B, H, Q, D) contiguous in q's
// type; pool_k, pool_v (pages_total * block_size, H, D) in q's type, or int8
// when quantized, with scale_k, scale_v (same rows, H) fp32 (else null);
// table (B, pages) int32; lengths (B,) int32. dtype: 0 = float32,
// 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int ragged_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                      const void* scale_k, const void* scale_v,
                                      const void* table, const void* lengths, void* o, int B,
                                      int H, int Q, int D, int pages, int block_size, int dtype,
                                      int quantized, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || pages < 1 || block_size < 1) return cudaErrorInvalidValue;
  if (quantized && (scale_k == nullptr || scale_v == nullptr)) return cudaErrorInvalidValue;
  const float* sk = static_cast<const float*>(scale_k);
  const float* sv = static_cast<const float*>(scale_v);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, pool_k, pool_v, sk, sv, tb, ln, o, B, H, Q, D, pages,
                               block_size, quantized, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, pool_k, pool_v, sk, sv, tb, ln, o, B, H, Q, D, pages,
                                       block_size, quantized, s);
  return cudaErrorInvalidValue;
}

// Head dims this library instantiates, for the wrapper's checks.
extern "C" int ragged_paged_attention_supports_head_dim(int d) {
  return d == 64 || d == 112 || d == 128;
}
