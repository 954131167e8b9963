// Flash attention backward for Hopper (sm_90a) at any head dims: the `wide`
// route of K2 (dq) and K3 (dk, dv), for every (q/k head dim d, v head dim
// dv) pair that the wgmma and tf32x3 routes do not instantiate
// (csrc/head_dims.cuh), fp32 or bf16, d and dv runtime arguments.
//
// Replaces the Pallas TPU kernels `_backward_dq` and `_backward_dkv` in
// perceiver_io_tpu/ops/flash_attention.py at those widths, with the same
// function as the other routes: p = exp(s - lse) recomputed from the
// forward's logsumexp over pre-scaled queries, ds = p * (do.v^T - delta)
// with delta = rowsum(o * do) from the caller (fp32), then
//   K2: dq = ds . k
//   K3: dv = p^T . do, dk = ds^T . q
// under the forward's masks (right-aligned causal `col <= row + (j - i)`,
// an optional (b, j) key pad mask), by select only: a dead row's lse is
// MASK, so exp(s - lse) overflows there; a row that sees no key gets dq = 0
// exactly, a key that no row sees dk = dv = 0 exactly. p and ds are cast to
// the input type before their products, as on the TPU; every sum is fp32.
//
// What bounds them on the H100: at the image classifier's training cross
// attend (b = 8, one head, 512 latents over 50176 pixels, d = dv = 261) K2
// does 6 * 261 flops a visible pair and K3 8 * 261, hundreds of flops per
// byte of q, k, v and do: arithmetic bounds both. This first design runs
// them on the CUDA cores in fp32 (csrc/wide.cuh: 64 x 64 score tiles,
// head-dim steps of 32 staged columns, accumulators of at most 288
// columns a block in registers) and leaves the tensor cores to a later one.
//   K2: one block per (64-row query tile x column group of dq, key split,
//       batch x head). Per 64-key tile of its split: S = Q.K^T over d,
//       dP = dO.V^T over dv, ds under the select (rounded) through a shared
//       tile, dQ += dS.K over the group's columns. Each block writes its
//       split's fp32 partial dq; a second launch sums a row's splits in a
//       fixed order (deterministic) and casts. The split count, as K1
//       wide's, fills the card from the row tiles, groups and heads alone:
//       one head of 512 rows is 8 row tiles a batch row.
//   K3: one block per (64-key tile x part, batch x head), the parts the
//       column groups of dv and then of dk. Per 64-query tile (from the
//       first whose causal bound reaches the keys): S^T = K.Q^T over d, p^T
//       under the select, and for a dk part dP^T = V.dO^T over dv and ds^T;
//       then dV += P^T.dO or dK += dS^T.Q over the group's columns. A block
//       owns its keys and columns: no atomics, deterministic. dv = 261 and
//       d = 261 are one group each (two parts), 1024 four.
#include "wide.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         float* __restrict__ part_dq, int H, int I, int J, int D, int DV,
                         int tiles_per_split, int causal) {
  __shared__ float buf[2 * 64 * KS];  // q/k, then do/v steps of S and dP; then k steps of dQ
  __shared__ float dss[BM * PS];      // ds, rounded to k's type
  __shared__ float oks[BN];           // 1 = key in range and not padded

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_groups = wide_groups(D);
  const int row_tile = blockIdx.x / n_groups, group = blockIdx.x - row_tile * n_groups;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const size_t bh = blockIdx.z;
  const int bb = blockIdx.z / H;
  const int row0 = row_tile * BM;
  const int gw = (D + n_groups - 1) / n_groups;
  const int g0 = group * gw, gwid = min(gw, D - g0);
  const int offset = J - I;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;
  const T* dog = dout + bh * (size_t)I * DV;

  const int n_tiles = (J + BN - 1) / BN;
  const int begin = split * tiles_per_split;
  int end = min(begin + tiles_per_split, n_tiles);
  if (causal) end = min(end, (min(row0 + BM, I) - 1 + offset) / BN + 1);

  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + ty + 16 * r;
    lse_r[r] = gr < I ? lse[bh * I + gr] : 0.f;
    delta_r[r] = gr < I ? delta[bh * I + gr] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = begin; t < end; ++t) {
    const int col0 = t * BN;
    bool ok = false;
    if (tid < BN) {
      const int key = col0 + tid;
      ok = key < J && (pad == nullptr || pad[(size_t)bb * J + key] == 0);
      oks[tid] = ok ? 1.f : 0.f;
    }
    if (!__syncthreads_or(ok)) continue;  // every key of the tile masked: it adds nothing

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    score_product(s, buf, qg, row0, I, kg, col0, J, D, ty, tx);
    score_product(dp, buf, dog, row0, I, vg, col0, J, DV, ty, tx);

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = tx + 16 * c;
        const bool allowed = gr < I && oks[lc] != 0.f && (!causal || col0 + lc <= gr + offset);
        const float p = allowed ? expf(s[r][c] - lse_r[r]) : 0.f;
        const float ds = allowed ? p * (dp[r][c] - delta_r[r]) : 0.f;
        dss[(ty + 16 * r) * PS + lc] = round_like(ds, T());
      }
    }

    accumulate(acc, buf, dss, kg, D, col0, J, g0, gwid, ty, tx);
  }

  // this split's partial dq over the group's columns (zeros if it saw no key)
  const size_t part = (bh * n_splits + split) * (size_t)I;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + ty + 16 * r;
    if (gr >= I) continue;
    float* out = part_dq + (part + gr) * D + g0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < gwid) out[col] = acc[r][c];
    }
  }
}

// dq = the sum of the splits' partials, in split order, cast to the input type
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dq_wide_sum_kernel(const float* __restrict__ part_dq, T* __restrict__ dq, int I, int D,
                             int n_splits, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t per_bh = (size_t)I * D;
  const size_t bh = idx / per_bh, within = idx - bh * per_bh;
  const float* src = part_dq + bh * n_splits * per_bh + within;
  float a = 0.f;
  for (int s = 0; s < n_splits; ++s) a += src[(size_t)s * per_bh];
  store(&dq[idx], a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                          const float* __restrict__ delta, const T* __restrict__ dout,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int I, int J, int D, int DV,
                          int causal) {
  __shared__ float buf[2 * 64 * KS];  // k/q, then v/do steps of S^T and dP^T; then do or q steps
  __shared__ float pts[BN * PS];      // p^T or ds^T, rounded to q's type
  __shared__ float lse_s[BM], delta_s[BM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_gv = wide_groups(DV), n_parts = n_gv + wide_groups(D);
  const int key_tile = blockIdx.x / n_parts, part = blockIdx.x - key_tile * n_parts;
  const bool is_v = part < n_gv;  // a dv part, else a dk part
  const int width = is_v ? DV : D;
  const int groups = is_v ? n_gv : n_parts - n_gv;
  const int gw = (width + groups - 1) / groups;
  const int g0 = (is_v ? part : part - n_gv) * gw, gwid = min(gw, width - g0);
  const size_t bh = blockIdx.z;
  const int bb = blockIdx.z / H;
  const int col0 = key_tile * BN;
  const int offset = J - I;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;
  const T* dog = dout + bh * (size_t)I * DV;

  bool key_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = col0 + ty + 16 * r;
    key_ok[r] = key < J && (pad == nullptr || pad[(size_t)bb * J + key] == 0);
  }
  const int n_tiles = (I + BM - 1) / BM;
  int t0 = 0;
  if (causal) {
    // the first query tile whose last row sees col0: t*BM + BM - 1 + offset >= col0
    const int x = col0 - offset - BM + 1;
    t0 = x <= 0 ? 0 : (x + BM - 1) / BM;
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    const int row0 = t * BM;
    // (the last tile's readers of lse_s / delta_s passed the accumulation's barriers)
    if (tid < BM) {
      const int gq = row0 + tid;
      lse_s[tid] = gq < I ? lse[bh * I + gq] : 0.f;
      delta_s[tid] = gq < I ? delta[bh * I + gq] : 0.f;
    }
    float st[4][4], dpt[4][4];  // rows keys, columns queries
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[r][c] = dpt[r][c] = 0.f;
    score_product(st, buf, kg, col0, J, qg, row0, I, D, ty, tx);  // its barriers publish lse_s
    if (!is_v) score_product(dpt, buf, vg, col0, J, dog, row0, I, DV, ty, tx);

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = col0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lq = tx + 16 * c, gq = row0 + lq;
        const bool allowed = key_ok[r] && gq < I && (!causal || key <= gq + offset);
        const float p = allowed ? expf(st[r][c] - lse_s[lq]) : 0.f;
        const float x = is_v ? p : (allowed ? p * (dpt[r][c] - delta_s[lq]) : 0.f);
        pts[(ty + 16 * r) * PS + lq] = round_like(x, T());
      }
    }

    if (is_v) accumulate(acc, buf, pts, dog, DV, row0, I, g0, gwid, ty, tx);  // dV += P^T . dO
    else accumulate(acc, buf, pts, qg, D, row0, I, g0, gwid, ty, tx);        // dK += dS^T . Q
  }

  T* out = (is_v ? dv + bh * (size_t)J * DV : dk + bh * (size_t)J * D) + g0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = col0 + ty + 16 * r;
    if (key >= J) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < gwid) store(&out[(size_t)key * width + col], acc[r][c]);
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
  int B, H, I, J, D, DV, causal;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_dq(const Args& a, void* dq, float* part_dq, int n_splits, int tiles_per_split) {
  const dim3 grid((unsigned)((a.I + BM - 1) / BM * wide_groups(a.D)), n_splits, a.B * a.H);
  flash_bwd_dq_wide_kernel<T><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pad, a.lse,
      a.delta, static_cast<const T*>(a.dout), part_dq, a.H, a.I, a.J, a.D, a.DV, tiles_per_split, a.causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)a.B * a.H * a.I * a.D;
  flash_bwd_dq_wide_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
      part_dq, static_cast<T*>(dq), a.I, a.D, n_splits, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const int parts = wide_groups(a.DV) + wide_groups(a.D);
  const dim3 grid((unsigned)((a.J + BN - 1) / BN * parts), 1, a.B * a.H);
  flash_bwd_dkv_wide_kernel<T><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pad, a.lse,
      a.delta, static_cast<const T*>(a.dout), static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.I, a.J,
      a.D, a.DV, a.causal);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.B >= 1 && a.H >= 1 && a.I >= 1 && a.J >= 1 && a.D >= 1 && a.DV >= 1 && a.B * a.H <= 65535;
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), do (B,H,I,DV), k (B,H,J,D)
// and v (B,H,J,DV) contiguous, any D, DV >= 1 (no alignment needed); pad
// (B,J) uint8 or null; lse and delta (B,H,I) fp32; outputs in the input
// type of their inputs' shapes. K2 takes scratch part_dq
// (B,H,n_splits,I,D) fp32, the keys' ceil(J / 64) tiles cut into n_splits
// splits of tiles_per_split (the last may be shorter, none empty). dtype:
// 0 = float32, 1 = bfloat16. Each returns the launches' cudaError_t
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int flash_attention_bwd_dq_wide(const void* q, const void* k, const void* v, const void* pad,
                                           const void* lse, const void* delta, const void* dout, void* dq,
                                           void* part_dq, int B, int H, int I, int J, int D, int DV,
                                           int n_splits, int tiles_per_split, int causal, int dtype,
                                           void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, B, H, I, J, D, DV, causal,
               static_cast<cudaStream_t>(stream)};
  const int n_tiles = (J + BN - 1) / BN;
  if (!valid(a) || tiles_per_split < 1 || n_splits < 1 || n_splits > 65535 ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles ||
      (long long)n_splits * tiles_per_split < n_tiles) {
    return cudaErrorInvalidValue;
  }
  float* part = static_cast<float*>(part_dq);
  if (dtype == 0) return launch_dq<float>(a, dq, part, n_splits, tiles_per_split);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(a, dq, part, n_splits, tiles_per_split);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* pad,
                                            const void* lse, const void* delta, const void* dout, void* dk,
                                            void* dv, int B, int H, int I, int J, int D, int DV, int causal,
                                            int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, B, H, I, J, D, DV, causal,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_dkv<float>(a, dk, dv);
  if (dtype == 1) return launch_dkv<__nv_bfloat16>(a, dk, dv);
  return cudaErrorInvalidValue;
}
