// Flash attention backward for Hopper (sm_90a), with Perceiver masking:
// dq (K2) and dk/dv (K3).
//
// Replaces the Pallas TPU kernels `_backward_dq` and `_backward_dkv` in
// perceiver_io_tpu/ops/flash_attention.py. Same function: the probabilities
// are recomputed from the forward's logsumexp, p = exp(s - lse) with s = q.k
// over pre-scaled queries, then ds = p * (do.v - delta) with
// delta = rowsum(o * do) (computed by the caller in fp32), and
//   K2: dq = sum over keys of ds.k
//   K3: dv = sum over queries of p.do, dk = sum over queries of ds.q
// under the forward's masks: the right-aligned causal mask
// `col <= row + (j - i)`, an optional (b, j) key pad mask (1 = pad), tiles
// wholly above the shifted diagonal skipped. Masking is by select, never by
// multiplying: a row that sees no key has lse = MASK (or -inf), so exp(s -
// lse) overflows there and only the select keeps it out; such a row gets
// dq = 0 exactly, and a key that no row sees gets dk = dv = 0 exactly.
// Rounding follows the TPU kernels: p is cast to the input type before the
// dv product, ds before the dq and dk products; every sum is fp32. Outputs
// are in the input type.
//
// What bounds them on the H100: per (batch, head) at the training shapes
// (i = 512 latents, j = 512..1024 keys, d = 112) K2 does 6*d flops per
// visible (query, key) pair against (3i + 2j)*d elements of traffic and K3
// 8*d flops against (2i + 4j)*d: hundreds of flops per byte, far above the
// fp32 CUDA cores' ridge, so both are bound by arithmetic. This first
// version spends it on the CUDA cores in fp32 (no tensor cores). What the
// design does about the bound: the (i, j) probability matrix never reaches
// device memory, each staged tile is reused by all 256 threads, tiles the
// causal mask removes are never loaded, and there are no atomics (K3 owns
// its key tile, so dk/dv are deterministic). Moving the five products onto
// wgmma is the next step.
//
// Schedule (K1's layout): 256 threads as a 16 x 16 grid own a 64 x 64 tile,
// thread (ty, tx) rows ty + 16*r and columns tx + 16*c (r, c < 4). Tiles are
// staged in shared memory as fp32 with odd padded strides (D + 1, 64 + 1),
// so the row walks of the products are free of bank conflicts.
//   K2: one block per (64-row query tile, head, batch). q, do, lse and delta
//       are staged once; the loop runs over kv tiles up to the tile's causal
//       bound (last row + j - i); dq (64 x D) stays in registers, D/16
//       columns per thread.
//   K3: one block per (64-key tile, head, batch). k and v are staged once;
//       the loop runs over query tiles from the first whose causal bound
//       reaches the key tile to the last. The block computes the transposed
//       tile (keys x queries), so p and ds land in shared memory already
//       transposed for the dv and dk products; dk and dv stay in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // queries per tile
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PP = 65;        // padded row stride of the p / ds tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// the cast to the input type before a product, as the TPU kernels do
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [row0, row0 + 64) of a (rows, D) matrix into a (64, D + 1) fp32 tile,
// zeros past `limit`
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int limit) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int g = row0 + r;
    dst[r * DP + d] = g < limit ? to_float(src[(size_t)g * D + d]) : 0.f;
  }
}

template <typename T, int D, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    T* __restrict__ dq, int H, int I, int J) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // dq columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;              // BM x DP
  float* do_s = q_s + BM * DP;    // BM x DP
  float* k_s = do_s + BM * DP;    // BN x DP
  float* v_s = k_s + BN * DP;     // BN x DP
  float* ds_s = v_s + BN * DP;    // BM x PP
  float* lse_s = ds_s + BM * PP;  // BM
  float* delta_s = lse_s + BM;    // BM
  float* ok_s = delta_s + BM;     // BN: 1 = key not padded

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int bb = blockIdx.z;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * D;
  const int offset = J - I;

  stage<T, D>(q_s, q + bh * (size_t)I * D, row0, I);
  stage<T, D>(do_s, dout + bh * (size_t)I * D, row0, I);
  if (tid < BM) {
    const int gr = row0 + tid;
    lse_s[tid] = gr < I ? lse[bh * I + gr] : 0.f;
    delta_s[tid] = gr < I ? delta[bh * I + gr] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  int n_tiles = (J + BN - 1) / BN;
  if (CAUSAL) {
    const int last_row = min(row0 + BM, I) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / BN + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int col0 = t * BN;
    __syncthreads();  // the previous tile's k/v/ds are no longer read
    stage<T, D>(k_s, kg, col0, J);
    stage<T, D>(v_s, vg, col0, J);
    if (tid < BN) {
      const int gc = col0 + tid;
      ok_s[tid] = (gc < J && (!HAS_PAD || pad[(size_t)bb * J + gc] == 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    // s = q.k^T and dp = do.v^T for this thread's 4 x 4 entries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = q_s[(ty + 16 * r) * DP + d];
        dov[r] = do_s[(ty + 16 * r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = k_s[(tx + 16 * c) * DP + d];
        vv[c] = v_s[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
        }
    }

    // p = exp(s - lse) where allowed (select: a dead row's exp overflows),
    // ds = p * (dp - delta), cast to k's type for the dq product
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ty + 16 * r;
      const int gr = row0 + lr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = tx + 16 * c;
        const bool allowed =
            gr < I && ok_s[lc] != 0.f && (!CAUSAL || col0 + lc <= gr + offset);
        const float p = allowed ? expf(s[r][c] - lse_s[lr]) : 0.f;
        const float ds = allowed ? p * (dp[r][c] - delta_s[lr]) : 0.f;
        ds_s[lr * PP + lc] = round_like(ds, T());
      }
    }
    __syncthreads();

    // dq += ds . k
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = ds_s[(ty + 16 * r) * PP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[n * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

  T* dqg = dq + bh * (size_t)I * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + ty + 16 * r;
    if (gr >= I) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&dqg[(size_t)gr * D + tx + 16 * c], acc[r][c]);
  }
}

template <typename T, int D, bool CAUSAL, bool HAS_PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int I, int J) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // dk/dv columns per thread

  extern __shared__ float smem[];
  float* k_s = smem;              // BN x DP
  float* v_s = k_s + BN * DP;     // BN x DP
  float* q_s = v_s + BN * DP;     // BM x DP
  float* do_s = q_s + BM * DP;    // BM x DP
  float* pt_s = do_s + BM * DP;   // BN x PP: p transposed (keys x queries)
  float* dst_s = pt_s + BN * PP;  // BN x PP: ds transposed
  float* lse_s = dst_s + BN * PP; // BM
  float* delta_s = lse_s + BM;    // BM
  float* ok_s = delta_s + BM;     // BN: 1 = key not padded

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col0 = blockIdx.x * BN;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int bb = blockIdx.z;
  const T* qg = q + bh * (size_t)I * D;
  const T* dog = dout + bh * (size_t)I * D;
  const int offset = J - I;

  stage<T, D>(k_s, k + bh * (size_t)J * D, col0, J);
  stage<T, D>(v_s, v + bh * (size_t)J * D, col0, J);
  if (tid < BN) {
    const int gc = col0 + tid;
    ok_s[tid] = (gc < J && (!HAS_PAD || pad[(size_t)bb * J + gc] == 0)) ? 1.f : 0.f;
  }

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  const int n_tiles = (I + BM - 1) / BM;
  int t0 = 0;
  if (CAUSAL) {
    // first query tile whose last row sees col0: t*BM + BM - 1 + offset >= col0
    const int x = col0 - offset - BM + 1;
    t0 = x <= 0 ? 0 : (x + BM - 1) / BM;
  }

  for (int t = t0; t < n_tiles; ++t) {
    const int row0 = t * BM;
    __syncthreads();  // the previous tile's q/do/p/ds are no longer read
    stage<T, D>(q_s, qg, row0, I);
    stage<T, D>(do_s, dog, row0, I);
    if (tid < BM) {
      const int gr = row0 + tid;
      lse_s[tid] = gr < I ? lse[bh * I + gr] : 0.f;
      delta_s[tid] = gr < I ? delta[bh * I + gr] : 0.f;
    }
    __syncthreads();

    // s^T = k.q^T and dp^T = v.do^T: rows are keys, columns queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[r][c] = dpt[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = k_s[(ty + 16 * r) * DP + d];
        vv[r] = v_s[(ty + 16 * r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = q_s[(tx + 16 * c) * DP + d];
        dov[c] = do_s[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[r][c] = fmaf(kv[r], qv[c], st[r][c]);
          dpt[r][c] = fmaf(vv[r], dov[c], dpt[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lk = ty + 16 * r;
      const bool key_ok = ok_s[lk] != 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lq = tx + 16 * c;
        const int gr = row0 + lq;
        const bool allowed = key_ok && gr < I && (!CAUSAL || col0 + lk <= gr + offset);
        const float p = allowed ? expf(st[r][c] - lse_s[lq]) : 0.f;
        const float ds = allowed ? p * (dpt[r][c] - delta_s[lq]) : 0.f;
        pt_s[lk * PP + lq] = round_like(p, T());
        dst_s[lk * PP + lq] = round_like(ds, T());
      }
    }
    __syncthreads();

    // dv += p^T . do, dk += ds^T . q
#pragma unroll 2
    for (int m = 0; m < BM; ++m) {
      float pv[4], dsv[4], dov[DC], qv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = pt_s[(ty + 16 * r) * PP + m];
        dsv[r] = dst_s[(ty + 16 * r) * PP + m];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = do_s[m * DP + tx + 16 * c];
        qv[c] = q_s[m * DP + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[r][c] = fmaf(pv[r], dov[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsv[r], qv[c], acc_k[r][c]);
        }
    }
  }

  T* dkg = dk + bh * (size_t)J * D;
  T* dvg = dv + bh * (size_t)J * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gc = col0 + ty + 16 * r;
    if (gc >= J) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(&dkg[(size_t)gc * D + tx + 16 * c], acc_k[r][c]);
      store(&dvg[(size_t)gc * D + tx + 16 * c], acc_v[r][c]);
    }
  }
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

template <typename T, int D, bool CAUSAL, bool HAS_PAD>
cudaError_t launch_dq(const Args& a) {
  constexpr int DP = D + 1;
  auto kernel = flash_bwd_dq_kernel<T, D, CAUSAL, HAS_PAD>;
  const size_t smem = sizeof(float) * (2 * BM * DP + 2 * BN * DP + BM * PP + 2 * BM + BN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.I + BM - 1) / BM, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pad,
      a.lse, a.delta, static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.H, a.I, a.J);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL, bool HAS_PAD>
cudaError_t launch_dkv(const Args& a) {
  constexpr int DP = D + 1;
  auto kernel = flash_bwd_dkv_kernel<T, D, CAUSAL, HAS_PAD>;
  const size_t smem = sizeof(float) * (2 * BN * DP + 2 * BM * DP + 2 * BN * PP + 2 * BM + BN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.J + BN - 1) / BN, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pad,
      a.lse, a.delta, static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.I, a.J);
  return cudaGetLastError();
}

template <bool DKV, typename T, int D, bool CAUSAL, bool HAS_PAD>
cudaError_t launch(const Args& a) {
  if constexpr (DKV) {
    return launch_dkv<T, D, CAUSAL, HAS_PAD>(a);
  } else {
    return launch_dq<T, D, CAUSAL, HAS_PAD>(a);
  }
}

template <bool DKV, typename T, int D>
cudaError_t dispatch_mask(const Args& a, int causal) {
  if (causal) {
    return a.pad ? launch<DKV, T, D, true, true>(a) : launch<DKV, T, D, true, false>(a);
  }
  return a.pad ? launch<DKV, T, D, false, true>(a) : launch<DKV, T, D, false, false>(a);
}

template <bool DKV, typename T>
cudaError_t dispatch_dim(const Args& a, int D, int causal) {
  switch (D) {
    case 64: return dispatch_mask<DKV, T, 64>(a, causal);
    case 112: return dispatch_mask<DKV, T, 112>(a, causal);
    case 128: return dispatch_mask<DKV, T, 128>(a, causal);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(const Args& a, int D, int causal, int dtype) {
  if (dtype == 0) return dispatch_dim<DKV, float>(a, D, causal);
  if (dtype == 1) return dispatch_dim<DKV, __nv_bfloat16>(a, D, causal);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q and do (B,H,I,D), k and v (B,H,J,D),
// all contiguous and of one type; pad (B,J) uint8 or null; lse and delta
// (B,H,I) fp32. dtype: 0 = float32, 1 = bfloat16. Each returns the launch's
// cudaError_t.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* pad, const void* lse, const void* delta,
                                      const void* dout, void* dq, int B, int H, int I, int J,
                                      int D, int causal, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, dq, nullptr, nullptr, B, H, I, J,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, causal, dtype);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* pad, const void* lse, const void* delta,
                                       const void* dout, void* dk, void* dv, int B, int H, int I,
                                       int J, int D, int causal, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, nullptr, dk, dv, B, H, I, J,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, causal, dtype);
}

// Head dims this library instantiates, for the wrapper's checks.
extern "C" int flash_attention_bwd_supports_head_dim(int d) {
  return d == 64 || d == 112 || d == 128;
}
