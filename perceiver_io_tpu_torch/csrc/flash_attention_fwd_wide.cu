// Flash attention forward for Hopper (sm_90a) at any head dims: K1's `wide`
// route, for every (q/k head dim d, v head dim dv) pair that the split,
// wgmma and tf32x3 routes do not instantiate (csrc/head_dims.cuh), fp32 or
// bf16, d and dv runtime arguments (one instantiation per type).
//
// Replaces the Pallas TPU kernel `_forward` in
// perceiver_io_tpu/ops/flash_attention.py (K1) at those widths, which
// JAX's kernel takes for any head dims of at least 32 (Mosaic pads them):
// the Fourier image classifier's encoder cross attend (one head of d = dv =
// 3 + 2 * (2 * 64 + 1) = 261 over 224 * 224 = 50176 pixels at
// deepmind/vision-perceiver-fourier width, 131 on MNIST) and its decoder's
// one query over 512 latents at d = dv = 1024. Same function as the other
// routes: online-softmax attention over pre-scaled queries, the
// right-aligned causal mask `col <= row + (j - i)` with kv tiles wholly
// above the shifted diagonal skipped, an optional (b, j) key pad mask
// (1 = pad), fp32 softmax and sums, p cast to v's type before p.v, o (b, h,
// i, dv) in the input type and lse (b, h, i) fp32; a row that sees no key
// gets o = 0 and lse = MASK.
//
// What bounds it on the H100: at the image encoder's cross attend (b = 4,
// one head, 512 latents over 50176 pixels, d = dv = 261) K1 does
// 4 * 261 flops a (query, key) pair, 107 GFLOP, against 2 * 50176 * 261
// elements of k and v a batch row: ~500 flops per byte in bf16, so
// arithmetic bounds it. This first design spends it on the CUDA cores in
// fp32 (an fp32-accurate product, as the gate wants over 50176 keys) and
// leaves the tensor cores to a later design; what it does about the bound
// is to keep the scores out of device memory and to fill the card: one
// head and 512 rows make only 8 row tiles a batch row, so the keys are cut
// into splits of `tiles_per_split` 64-key tiles over the grid's y, each
// block writing the fp32 partials (m, l, acc) of its rows over its keys,
// and a second launch merges a row's splits, as the split route does:
//   m = max m_s,  l = sum l_s e^(m_s - m),  o = sum acc_s e^(m_s - m) / l.
// The caller picks the split count from the row tiles, column groups and
// heads alone (not the batch), so a row's result does not depend on the
// batch.
//
// Schedule (csrc/wide.cuh): one block of 256 threads per (64-row query
// tile x column group of v, key split, batch x head). Per 64-key tile: S =
// Q.K^T in steps of 32 head-dim columns staged in shared memory (q and k
// re-read from L2 per tile: a row of 1024 would not fit), the select and
// online softmax in registers, p (rounded to v's type) through a shared
// tile, and O += P.V over the group's columns in steps of 64. The
// accumulator holds at most GROUP = 288 columns (18 fp32 a thread): dv =
// 261 is one group, dv = 1024 four of 256, each recomputing S. A tile
// whose keys are all masked is skipped.
#include "wide.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ pad, float* __restrict__ part_ml,
                      float* __restrict__ part_acc, int H, int I, int J, int D, int DV,
                      int tiles_per_split, int causal) {
  __shared__ float buf[2 * 64 * KS];  // q/k steps of S, then v steps of O
  __shared__ float ps[BM * PS];       // p, rounded to v's type
  __shared__ float oks[BN];           // 1 = key in range and not padded

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_groups = wide_groups(DV);
  const int row_tile = blockIdx.x / n_groups, group = blockIdx.x - row_tile * n_groups;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const size_t bh = blockIdx.z;
  const int bb = blockIdx.z / H;
  const int row0 = row_tile * BM;
  const int gw = (DV + n_groups - 1) / n_groups;
  const int g0 = group * gw, gwid = min(gw, DV - g0);
  const int offset = J - I;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;

  const int n_tiles = (J + BN - 1) / BN;
  const int begin = split * tiles_per_split;
  int end = min(begin + tiles_per_split, n_tiles);
  if (causal) end = min(end, (min(row0 + BM, I) - 1 + offset) / BN + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
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

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    score_product(s, buf, qg, row0, I, kg, col0, J, D, ty, tx);

    // the select (-inf where not allowed) and the online softmax; a row's
    // state is replicated over its 16 tx lanes
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = tx + 16 * c;
        const bool allowed = oks[lc] != 0.f && (!causal || col0 + lc <= gr + offset);
        s[r][c] = allowed ? s[r][c] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w, 16));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet: every p is 0
      const float alpha = expf(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_use);  // exp(-inf) = 0 where not allowed
        sum += p;
        ps[(ty + 16 * r) * PS + tx + 16 * c] = round_like(p, T());
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w, 16);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }

    accumulate(acc, buf, ps, vg, DV, col0, J, g0, gwid, ty, tx);
  }

  // this split's partials of the group's columns; (m, l) from group 0
  const size_t part = (bh * n_splits + split) * (size_t)I;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + ty + 16 * r;
    if (gr >= I) continue;
    float* out = part_acc + (part + gr) * DV + g0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < gwid) out[col] = acc[r][c];
    }
    if (group == 0 && tx == 0) {
      part_ml[(part + gr) * 2] = l[r] > 0.f ? m[r] : MASK;
      part_ml[(part + gr) * 2 + 1] = l[r];
    }
  }
}

// One block per (row, batch x head): merges the row's splits; a split with
// l = 0 saw no key of the row and adds nothing.
template <typename T>
__global__ void __launch_bounds__(128)
flash_fwd_wide_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                            T* __restrict__ o, float* __restrict__ lse, int I, int DV, int n_splits) {
  const int row = blockIdx.x;
  const size_t bh = blockIdx.y;
  const float* ml = part_ml + bh * n_splits * (size_t)I * 2;
  const float* acc = part_acc + bh * n_splits * (size_t)I * DV;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + ((size_t)s * I + row) * 2;
    if (p[1] > 0.f) m = fmaxf(m, p[0]);
  }
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + ((size_t)s * I + row) * 2;
    if (p[1] > 0.f) l += p[1] * expf(p[0] - m);
  }
  const bool live = l > 0.f;  // a row that sees no key: zero output and lse = MASK
  const float inv = live ? 1.f / l : 0.f;
  T* orow = o + (bh * I + row) * DV;
  for (int d = threadIdx.x; d < DV; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* p = ml + ((size_t)s * I + row) * 2;
      if (p[1] > 0.f) a += acc[((size_t)s * I + row) * DV + d] * expf(p[0] - m);
    }
    store(&orow[d], a * inv);
  }
  if (threadIdx.x == 0) lse[bh * I + row] = live ? m + logf(l) : MASK;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* pad, void* o, float* lse,
                   float* part_ml, float* part_acc, int B, int H, int I, int J, int D, int DV,
                   int n_splits, int tiles_per_split, int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)((I + BM - 1) / BM * wide_groups(DV)), n_splits, B * H);
  flash_fwd_wide_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pad, part_ml,
      part_acc, H, I, J, D, DV, tiles_per_split, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_fwd_wide_merge_kernel<T><<<dim3(I, B * H), 128, 0, stream>>>(part_ml, part_acc,
                                                                      static_cast<T*>(o), lse, I, DV,
                                                                      n_splits);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), k (B,H,J,D) and v
// (B,H,J,DV) contiguous, any D, DV >= 1 (no alignment needed); pad (B,J)
// uint8 or null; o (B,H,I,DV) in the input type; lse (B,H,I) fp32; scratch
// part_ml (B,H,n_splits,I,2) and part_acc (B,H,n_splits,I,DV) fp32, with
// the keys' ceil(J / 64) tiles cut into n_splits splits of tiles_per_split
// (the last may be shorter, none empty). dtype: 0 = float32,
// 1 = bfloat16. Returns the launches' cudaError_t (cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int flash_attention_fwd_wide(const void* q, const void* k, const void* v, const void* pad,
                                        void* o, void* lse, void* part_ml, void* part_acc, int B, int H,
                                        int I, int J, int D, int DV, int n_splits, int tiles_per_split,
                                        int causal, int dtype, void* stream) {
  const int n_tiles = (J + BN - 1) / BN;
  if (B < 1 || H < 1 || I < 1 || J < 1 || D < 1 || DV < 1 || tiles_per_split < 1 || n_splits < 1 ||
      n_splits > 65535 || B * H > 65535 || (long long)(n_splits - 1) * tiles_per_split >= n_tiles ||
      (long long)n_splits * tiles_per_split < n_tiles) {
    return cudaErrorInvalidValue;
  }
  const uint8_t* p = static_cast<const uint8_t*>(pad);
  float* l = static_cast<float*>(lse);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, p, o, l, ml, acc, B, H, I, J, D, DV, n_splits, tiles_per_split, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, o, l, ml, acc, B, H, I, J, D, DV, n_splits, tiles_per_split,
                                 causal, s);
  return cudaErrorInvalidValue;
}
