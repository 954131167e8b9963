// Flash attention forward for Hopper (sm_90a) at any head dims, on the
// tensor cores: K1's `wide_mma` route, for every (q/k head dim d, v head dim
// dv) pair that the split, wgmma and tf32x3 routes do not instantiate
// (csrc/head_dims.cuh), fp32 or bf16, d and dv run-time arguments.
// csrc/flash_attention_fwd_wide.cu (`wide`, CUDA-core tiles) is the earlier
// design at those pairs, reached only by name.
//
// Replaces the Pallas TPU kernel `_forward` in
// perceiver_io_tpu/ops/flash_attention.py (K1) at those widths, with the
// same function as the other routes: online-softmax attention over
// pre-scaled queries, the right-aligned causal mask `col <= row + (j - i)`
// with key tiles wholly above the shifted diagonal skipped, an optional
// (b, j) key pad mask (1 = pad) applied by select only (a key tile whose
// keys are all masked is skipped), fp32 softmax and sums, p rounded to v's
// type before p.v as on the TPU, o (b, h, i, dv) in the input type and lse
// (b, h, i) fp32; a row that sees no key gets o = 0 exactly and lse = MASK.
//
// What bounds it on the H100. The image classifier's encoder cross attend
// (512 latents over 224 * 224 = 50176 pixels, one head, d = dv = 261) does
// 2d + 2dv flops a (query, key) pair against 2 * 50176 * 261 elements of k
// and v a batch row, ~500 flops per byte in bf16: operations bound it. So
// both products run on the tensor cores: bf16 as mma.sync.m16n8k16
// (csrc/mma_bf16.cuh), fp32 as three TF32 products per fp32 product
// (csrc/tf32x3.cuh's split and mma3: fp32-accurate, as the gate wants over
// 50176 keys; TF32 arithmetic itself stays off), and p stays in registers:
// S's C fragments are p's A fragment (bf16: packed pairs; fp32: the
// permuted k-order of csrc/tf32x3.cuh, V read to match). The decoder's one
// query over 512 latents (d = dv = 1024) reads k and v once and does little
// else: bytes bound it, so its 16-row tiles (mma's m16; a 64-row tile would
// waste 63 rows) compute the scores once for all 1024 output columns (the
// earlier design cut them into four groups over the grid, each recomputing
// S over d = 1024), and its keys are split over the grid so that a batch
// row fills the card.
//
// Staging (csrc/wide_mma.cuh, shared with K2/K3's wide_mma): no TMA, since
// d = 261 gives row strides of 522 (bf16) or 1044 (fp32) bytes. fp32 tiles
// by cp.async; bf16 whole rows, where the bases allow, as each key tile's
// contiguous span by 16-byte cp.async, laid out in shared memory while the
// next tile's span loads, else through registers at any alignment; rows
// that start on 16-byte boundaries (d = 1024) by 16-byte cp.async. Zeros
// past d and dv and past the ragged row and key edges. Tiles are padded to
// multiples of 16 columns, row stride that plus 8 (bf16) or 4 (fp32).
//
// Two schedules, one block of 8 warps each, one block an SM (no register
// cap: __launch_bounds__(256, 1)):
//   whole rows (round16(d) and round16(dv) <= GROUP = 272: the image's 261,
//     MNIST's 131): a warp holds its 16 query rows' whole output row, in an
//     accumulator of 9 or 17 column pairs fixed at compile time (144 or 272
//     columns, 72 or 136 fp32 registers a thread) so that P.V runs with no
//     guard on the column count. q is staged once a block; per key tile:
//     the key flags, k and v; S = Q.K^T over d, the select, the new max and
//     the rescale (skipped where no row's max moved), and O += P.V over dv.
//     bf16 takes 128-row query tiles: one warp on each 16 rows, over all 64
//     keys of a tile, 32 at a time, so each staged k/v tile serves 128 rows.
//     fp32 tiles take twice the bytes: 64 rows, two warps on each 16 rows
//     over half of every tile, each with its own online-softmax state (m
//     and l per row, m quad-uniform), merged at the end in a fixed order
//     through shared memory (weights exp(m_w - m), selected to 0 for a
//     state that saw no key); and its next tile's k loads (cp.async) while
//     this tile's P.V runs, its v while the next S runs. Where i <= 16, 16
//     rows: eight warps over 16 keys of a 128-key tile (bf16) or 8 of a
//     64-key tile (fp32), merged the same way.
//   column split (a wider pair, the decoder's 1024): 16-row tiles, and the
//     block's 8 warps split its output columns (each at most 272, so a block
//     holds 8 * 272 = 2176 columns; a wider v is cut into that many column
//     blocks over the grid as the registers force). Per 64-key tile each
//     warp computes S for 8 of its keys over d in CHUNK-column steps, the
//     warps exchange their row maxima (every warp then holds the same m), p
//     crosses through shared memory once for every column, and each warp
//     adds P.V over its columns, v staged in steps of 16-64 keys.
// Both write fp32 partials (m, l, acc) per key split, and a merge launch
// joins a row's splits, the weights once a row, the sums in split order:
//   m = max m_s,  l = sum l_s e^(m_s - m),  o = sum acc_s e^(m_s - m) / l.
// Past the products, the bf16 kernel's time goes to laying out the flat
// spans (one pass over each k/v tile, which the 128-row tiles share among
// twice the rows) and the merge (the partials' bytes, which whole waves of
// splits keep few).
// The plan (ops/flash_attention.py `_wide_mma_fwd_plan`; the kernel takes
// the splits from it, checks them, and derives the rest from its own
// constants) depends on (i, j, h, d, dv, type) alone, not on the batch, so
// a row's result does not depend on the batch: the row tiles, column
// blocks, heads and splits of one batch row fill whole waves of 132 blocks
// (the H100's SMs, one block each) where the keys allow. Fewer splits mean
// less partial traffic for the merge and fewer prologues (q's staging and
// the first key tile, which nothing hides).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // the bf16 products (through wide_mma.cuh)
#include "tf32x3.cuh"    // THREADS, WARPS, SMEM_LIMIT; the fp32 products (through wide_mma.cuh)
#include "vec16.cuh"     // store
#include "wide_mma.cuh"  // stride_of, group_width, staging, score, accumulate, acc_col

namespace {

constexpr int GROUP = 272;       // most output columns a warp accumulates: 17 pairs of n-tiles
constexpr int CHUNK = 64;        // head-dim columns of a staged score step in the column split
constexpr int KEYS = 64;         // keys of a tile
constexpr int KEYS_SMALL = 128;  // keys of a tile of whole rows at bf16's 16-row query tiles: 16 a warp
constexpr int ROWS_BF16 = 128;   // query rows of a tile of whole rows where i > 16: 16 a warp
constexpr int ROWS_FP32 = 64;    // (fp32 tiles take twice the bytes: two warps on each 16 rows)
constexpr int ROWS_SMALL = 16;   // query rows of a tile where i <= 16, and of every column-split tile
constexpr int PS = KEYS + 8;     // row stride of the column split's fp32 p tile: no bank conflict
// The TPU kernel's large-but-finite mask value: a dead row's lse
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

// whole rows of q, k and v are staged, and a warp holds its whole output
// row, when both widths fit one group
__host__ __device__ constexpr bool fused_of(int D, int DV) { return round16(D) <= GROUP && round16(DV) <= GROUP; }

// the query rows of a tile: 128 (bf16) or 64 (fp32) for whole rows where
// i > 16, else 16
template <typename T>
__host__ __device__ constexpr int rows_of(bool fused, int I) {
  return fused && I > ROWS_SMALL ? (IS_F32<T> ? ROWS_FP32 : ROWS_BF16) : ROWS_SMALL;
}

// the column pairs a whole row's accumulator holds, fixed at compile time
// so that P.V runs unguarded: 9 (144 columns: MNIST's 131) or 17 (272: the
// image's 261); the v tile is staged that wide. The 9-pair instantiation
// takes 168-234 registers against 17 pairs' 247-255, and its fp32 kernel
// runs 14-17 % faster at MNIST's shapes (time_k23.py --k1 on the H100)
__host__ __device__ constexpr int pairs_of(int DV) { return (DV + 15) / 16 <= 9 ? 9 : GROUP / 16; }

// the keys of a tile: 128 for bf16's 16-row tiles of whole rows (16 a warp,
// one bf16 k-step of P.V), else 64
template <typename T>
__host__ __device__ constexpr int keys_of(bool fused, int rows) {
  return fused && !IS_F32<T> && rows == ROWS_SMALL ? KEYS_SMALL : KEYS;
}

// the column blocks of a column-split output: as many as 8 warps of GROUP
// columns force
__host__ __device__ constexpr int col_blocks_of(bool fused, int DV) {
  return fused ? 1 : (DV + WARPS * GROUP - 1) / (WARPS * GROUP);
}

// the weight of a softmax state with max m in a merge with max mx: 0 for a
// state that saw no key (selected, never exp(-inf - (-inf)))
__device__ __forceinline__ float weight(float m, float mx) { return m == -INFINITY ? 0.f : __expf(m - mx); }

// whole rows' shared memory: q, k and v tiles (v 16 * pairs_of(DV)
// columns wide; their space later takes the key warps' states: acc and
// (m0, m1, l0, l1) per lane of every warp but the first of each row group),
// then the key flags, then the flat spans
template <typename T>
__host__ __device__ constexpr int fused_flags_at(int rows, int D, int DV) {
  const int keys = keys_of<T>(true, rows), sd = stride_of<T>(D), sv = stride_of<T>(16 * pairs_of(DV));
  const int tiles = (rows * sd + keys * (sd + sv)) * (int)sizeof(T);
  const int states = (WARPS - rows / 16) * (8 * pairs_of(DV) + 4) * 32 * 4;  // 2 * pairs n-tiles of 4
  return imax(tiles, states);
}

template <typename T>
__host__ __device__ constexpr int fused_smem(int rows, int D, int DV) {
  return fused_flags_at<T>(rows, D, DV) + keys_of<T>(true, rows) * 4;
}

// one lane's online-softmax step over its S fragments (rows g and g + 8):
// the select has set masked entries to -inf; the tile's row maxima mx0/mx1
// are given. Updates m and l, turns s into p (0 where masked) and returns
// the rescale factors of the row state.
template <int NK>
__device__ __forceinline__ void softmax_step(float (&s)[NK][4], float mx0, float mx1, float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1) {
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  // 1 where the max did not move (also while the row has seen no key: -inf)
  a0 = m0 == n0 ? 1.f : __expf(m0 - n0);
  a1 = m1 == n1 ? 1.f : __expf(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - (e < 2 ? n0 : n1));
      s[n][e] = p;
      if (e < 2) sum0 += p;
      else sum1 += p;
    }
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// acc *= (a0 on rows g, a1 on rows g + 8), skipped where no row of the
// warp moved its max
template <int NC>
__device__ __forceinline__ void rescale(float (&acc)[NC][4], float a0, float a1, int npairs) {
  if (!__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) return;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if ((n >> 1) < npairs) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
  }
}

__device__ __forceinline__ void quad_max(float& x0, float& x1) {
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
  }
}

__device__ __forceinline__ void quad_sum(float& x0, float& x1) {
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    x0 += __shfl_xor_sync(0xffffffffu, x0, w);
    x1 += __shfl_xor_sync(0xffffffffu, x1, w);
  }
}

// a split's partials of rows g0 and g1 (global): acc over this warp's
// columns [c0, c0 + cn) of the output, and (m, l) where `ml` (m = MASK for
// a row that saw no key)
template <typename T, int NC>
__device__ __forceinline__ void write_partials(float* __restrict__ part_ml, float* __restrict__ part_acc,
                                               size_t part, const float (&acc)[NC][4], int I, int DV, int gr0,
                                               int gr1, int c0, int cn, int npairs, int t, bool ml, float m0,
                                               float m1, float l0, float l1) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if ((n >> 1) < npairs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = acc_col<T>(n, e, t), gr = e < 2 ? gr0 : gr1;
        if (gr < I && col < cn) part_acc[(part + gr) * DV + c0 + col] = acc[n][e];
      }
    }
  }
  if (ml && t == 0) {
    if (gr0 < I) *reinterpret_cast<float2*>(part_ml + (part + gr0) * 2) = make_float2(l0 > 0.f ? m0 : MASK, l0);
    if (gr1 < I) *reinterpret_cast<float2*>(part_ml + (part + gr1) * 2) = make_float2(l1 > 0.f ? m1 : MASK, l1);
  }
}

// Whole rows: one block per (query tile, key split, batch x head); NP =
// pairs_of(DV).
template <typename T, int ROWS_T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const uint8_t* __restrict__ pad, float* __restrict__ part_ml,
                          float* __restrict__ part_acc, int H, int I, int J, int D, int DV, int tiles_per_split,
                          int causal, int flat) {
  constexpr int NKEYS = keys_of<T>(true, ROWS_T);
  constexpr int RG = ROWS_T / 16, KW = WARPS / RG;  // row groups of 16; warps on each, over its share of the keys
  // a warp's keys of a tile, taken WS at a time (S's n-tiles: NK)
  constexpr int WK = NKEYS / KW, WS = WK < 32 ? WK : 32, NK = WS / 8, NC = 2 * NP;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / KW, kw = warp - rg * KW, g = lane >> 2, t = lane & 3;
  const int split_id = blockIdx.y, n_splits = gridDim.y;
  const size_t bh = blockIdx.z;
  const int bb = blockIdx.z / H;
  const int row0 = blockIdx.x * ROWS_T, offset = J - I;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;

  const int sd = stride_of<T>(D), sv = stride_of<T>(16 * NP);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + ROWS_T * sd;
  T* vs = ks + NKEYS * sd;
  float* okf = reinterpret_cast<float*>(smem + fused_flags_at<T>(ROWS_T, D, DV));
  T* fk = reinterpret_cast<T*>(smem + fused_smem<T>(ROWS_T, D, DV));  // flat: the spans of k and v
  T* fv = fk + flat_bytes(NKEYS, D) / sizeof(T);

  const int n_tiles = (J + NKEYS - 1) / NKEYS;
  const int begin = split_id * tiles_per_split;
  int end = imin(begin + tiles_per_split, n_tiles);
  if (causal) end = imin(end, (imin(row0 + ROWS_T, I) - 1 + offset) / NKEYS + 1);

  const int gr0 = row0 + 16 * rg + g, gr1 = gr0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // the key flags of the tile at key0 (published by the barrier); true where
  // some key of the tile is unmasked
  auto flags = [&](int key0) {
    bool ok = false;
    if (tid < NKEYS) {
      ok = key_valid(pad, bb, J, key0 + tid);
      okf[tid] = ok ? 1.f : 0.f;
    }
    return __syncthreads_or(ok);
  };
  // S = Q.K^T for this warp's 16 rows x WS keys from kb, under the select
  // (-inf where not allowed), with the row maxima over the quad
  auto scores = [&](float (&s)[NK][4], int key0, int kb, float& mx0, float& mx1) {
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    score(s, qs, sd, 16 * rg, ks, sd, kb, round16(D), lane);
    mx0 = mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = kb + 8 * n + 2 * t + (e & 1);
        const bool allowed = okf[lc] != 0.f && (!causal || key0 + lc <= (e < 2 ? gr0 : gr1) + offset);
        s[n][e] = allowed ? s[n][e] : -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
    }
    quad_max(mx0, mx1);
  };
  // p, the row state and its rescale, then O += P.V over dv with p from S's
  // registers (V rows = the keys from kb)
  auto accumulate_pv = [&](float (&s)[NK][4], int kb, float mx0, float mx1) {
    float a0, a1;
    softmax_step(s, mx0, mx1, m0, m1, l0, l1, a0, a1);
    rescale(acc, a0, a1, NP);
    accumulate(acc, s, vs, sv, kb, NP, lane);
  };
  auto stage_k = [&](int key0) { stage_rows(ks, sd, kg, D, key0, NKEYS, J, 0, round16(D), D); };
  auto stage_v = [&](int key0) { stage_rows(vs, sv, vg, DV, key0, NKEYS, J, 0, round16(DV), DV); };

  // q once (published by the first tile's barriers)
  stage_rows(qs, sd, qg, D, row0, ROWS_T, I, 0, round16(D), D);
  settle<T>();
  if (WS == WK && !flat) {
    // a warp's keys in one step, tiles staged in place: the next tile's k
    // loads while this tile's P.V runs, its v while the next S runs (fp32's
    // copies are asynchronous; bf16 off the flat spans loads through
    // registers). cp.async groups: k_t, v_t, k_t+1, v_t+1, ...
    if (begin < end) stage_k(begin * NKEYS);
    cp_async_commit();
    if (begin < end) stage_v(begin * NKEYS);
    cp_async_commit();
    for (int it = begin; it < end; ++it) {
      const int key0 = it * NKEYS;
      const bool live = flags(key0);  // (the last tile's readers of the flags are done: v's barrier)
      cp_async_wait<1>();  // k_t has landed
      __syncthreads();
      float s[NK][4], mx0, mx1;
      if (live) scores(s, key0, kw * WK, mx0, mx1);
      __syncthreads();  // k_t read
      if (it + 1 < end) stage_k(key0 + NKEYS);
      cp_async_commit();
      cp_async_wait<1>();  // v_t has landed
      __syncthreads();
      if (live) accumulate_pv(s, kw * WK, mx0, mx1);
      __syncthreads();  // v_t read
      if (it + 1 < end) stage_v(key0 + NKEYS);
      cp_async_commit();
    }
    cp_async_wait<0>();
  } else {
    if constexpr (!IS_F32<T>) {
      if (flat && begin < end) {
        flat_issue(fk, kg, D, begin * NKEYS, NKEYS, J);
        flat_issue(fv, vg, DV, begin * NKEYS, NKEYS, J);
        cp_async_commit();
      }
    }
    for (int it = begin; it < end; ++it) {
      const int key0 = it * NKEYS;
      __syncthreads();  // the last tile's readers of the key tiles and flags are done
      const bool live = flags(key0);
      if constexpr (!IS_F32<T>) {
        if (flat) {  // this tile's spans have landed: lay them out, then start the next tile's
          cp_async_wait<0>();
          __syncthreads();
          if (live) {
            flat_unpack(ks, sd, fk, D, NKEYS, imin(NKEYS, J - key0));
            flat_unpack(vs, sv, fv, DV, NKEYS, imin(NKEYS, J - key0));
          }
          __syncthreads();
          if (it + 1 < end) {
            flat_issue(fk, kg, D, key0 + NKEYS, NKEYS, J);
            flat_issue(fv, vg, DV, key0 + NKEYS, NKEYS, J);
            cp_async_commit();
          }
        }
      }
      if (!live) continue;  // every key of the tile masked: it adds nothing
      if (!flat) {
        stage_k(key0);
        stage_v(key0);
        settle<T>();
        __syncthreads();
      }
      for (int kb = kw * WK; kb < (kw + 1) * WK; kb += WS) {  // this warp's keys, WS at a time
        float s[NK][4], mx0, mx1;
        scores(s, key0, kb, mx0, mx1);
        accumulate_pv(s, kb, mx0, mx1);
      }
    }
    if constexpr (!IS_F32<T>) cp_async_wait<0>();
  }
  quad_sum(l0, l1);

  // the key warps of a row group merge their states in a fixed order
  __syncthreads();  // every reader of the tiles is done: their space takes the states
  constexpr int STATE = (NC * 4 + 4) * 32;  // floats a warp's state takes, lane-contiguous
  float* states = reinterpret_cast<float*>(smem);
  if (kw > 0) {
    float* r = states + (rg * (KW - 1) + kw - 1) * STATE + lane;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[(4 * n + e) * 32] = acc[n][e];
    r[(4 * NC) * 32] = m0;
    r[(4 * NC + 1) * 32] = m1;
    r[(4 * NC + 2) * 32] = l0;
    r[(4 * NC + 3) * 32] = l1;
  }
  __syncthreads();
  if (kw > 0) return;
  for (int w = 1; w < KW; ++w) {
    const float* r = states + (rg * (KW - 1) + w - 1) * STATE + lane;
    const float om0 = r[(4 * NC) * 32], om1 = r[(4 * NC + 1) * 32];
    const float x0 = fmaxf(m0, om0), x1 = fmaxf(m1, om1);
    const float wa0 = weight(m0, x0), wb0 = weight(om0, x0), wa1 = weight(m1, x1), wb1 = weight(om1, x1);
    l0 = l0 * wa0 + r[(4 * NC + 2) * 32] * wb0;
    l1 = l1 * wa1 + r[(4 * NC + 3) * 32] * wb1;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      acc[n][0] = acc[n][0] * wa0 + r[(4 * n + 0) * 32] * wb0;
      acc[n][1] = acc[n][1] * wa0 + r[(4 * n + 1) * 32] * wb0;
      acc[n][2] = acc[n][2] * wa1 + r[(4 * n + 2) * 32] * wb1;
      acc[n][3] = acc[n][3] * wa1 + r[(4 * n + 3) * 32] * wb1;
    }
    m0 = x0;
    m1 = x1;
  }
  write_partials<T>(part_ml, part_acc, (bh * n_splits + split_id) * (size_t)I, acc, I, DV, gr0, gr1, 0, DV, NP, t,
                    true, m0, m1, l0, l1);
}

// the column split's shared memory: q and k CHUNK-column steps, p (16 x PS
// fp32), the warps' row maxima and row sums (8 x 16 fp32 each), the key
// flags; then `vk` keys of v over the block's staged columns
template <typename T>
__host__ __device__ constexpr int split_v_at() {
  return (ROWS_SMALL + KEYS) * stride_of<T>(CHUNK) * (int)sizeof(T) + (ROWS_SMALL * PS + 2 * WARPS * 16 + KEYS) * 4;
}

template <typename T>
__host__ __device__ constexpr int split_smem(int vk, int v_cols) {
  return split_v_at<T>() + vk * stride_of<T>(v_cols) * (int)sizeof(T);
}

// Column split: one block per (16-row query tile x column block, key split,
// batch x head).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide_mma_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                               const uint8_t* __restrict__ pad, float* __restrict__ part_ml,
                               float* __restrict__ part_acc, int H, int I, int J, int D, int DV, int n_cblocks,
                               int tiles_per_split, int causal, int vk) {
  constexpr int NC = GROUP / 8, E16 = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row_tile = blockIdx.x / n_cblocks, cblock = blockIdx.x - row_tile * n_cblocks;
  const int split_id = blockIdx.y, n_splits = gridDim.y;
  const size_t bh = blockIdx.z;
  const int bb = blockIdx.z / H;
  const int row0 = row_tile * ROWS_SMALL, offset = J - I;
  const int bw = group_width(DV, n_cblocks), cb0 = cblock * bw, bn = imin(bw, DV - cb0);  // the block's columns
  const int ww = group_width(bw, WARPS), w0 = warp * ww, wn = imin(ww, bn - w0);  // this warp's, in the block
  const int npairs = wn > 0 ? (wn + 15) >> 4 : 0;
  const int vcols = WARPS * ww;  // staged columns of v (zeros past the block's)
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;
  // rows on 16-byte boundaries go by 16-byte cp.async (CHUNK, bw and ww are
  // multiples of 16 columns, so every step starts on one)
  const bool qk16 = aligned16(qg) && aligned16(kg) && D % E16 == 0;
  const bool v16 = aligned16(vg) && DV % E16 == 0;

  const int sch = stride_of<T>(CHUNK), sv = stride_of<T>(vcols);
  T* qc = reinterpret_cast<T*>(smem);
  T* kc = qc + ROWS_SMALL * sch;
  float* ps = reinterpret_cast<float*>(kc + KEYS * sch);
  float* mxs = ps + ROWS_SMALL * PS;
  float* lss = mxs + WARPS * 16;
  float* okf = lss + WARPS * 16;
  T* vc = reinterpret_cast<T*>(smem + split_v_at<T>());

  const int n_tiles = (J + KEYS - 1) / KEYS;
  const int begin = split_id * tiles_per_split;
  int end = imin(begin + tiles_per_split, n_tiles);
  if (causal) end = imin(end, (imin(row0 + ROWS_SMALL, I) - 1 + offset) / KEYS + 1);

  const int gr0 = row0 + g, gr1 = gr0 + 8;
  const int lk = 8 * warp;  // this warp's 8 keys of each tile, for S
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = begin; it < end; ++it) {
    const int key0 = it * KEYS;
    __syncthreads();  // the last tile's readers of every tile are done
    bool ok = false;
    if (tid < KEYS) {
      ok = key_valid(pad, bb, J, key0 + tid);
      okf[tid] = ok ? 1.f : 0.f;
    }
    if (!__syncthreads_or(ok)) continue;  // every key of the tile masked: it adds nothing

    // S = Q.K^T: 16 rows x this warp's 8 keys, over d in CHUNK-column steps
    float s[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    for (int c0 = 0; c0 < D; c0 += CHUNK) {
      if (c0 > 0) __syncthreads();  // the last step's readers are done
      if (qk16) {
        stage_rows16(qc, sch, qg, D, row0, ROWS_SMALL, I, c0, CHUNK, D);
        stage_rows16(kc, sch, kg, D, key0, KEYS, J, c0, CHUNK, D);
      } else {
        stage_rows(qc, sch, qg, D, row0, ROWS_SMALL, I, c0, CHUNK, D);
        stage_rows(kc, sch, kg, D, key0, KEYS, J, c0, CHUNK, D);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      score(s, qc, sch, 0, kc, sch, lk, imin(CHUNK, round16(D - c0)), lane);
    }

    // the select, the tile's row maxima over every warp (each warp then
    // holds the same m), p into shared memory rounded to v's type
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lc = lk + 2 * t + (e & 1);
      const bool allowed = okf[lc] != 0.f && (!causal || key0 + lc <= (e < 2 ? gr0 : gr1) + offset);
      s[0][e] = allowed ? s[0][e] : -INFINITY;
      if (e < 2) mx0 = fmaxf(mx0, s[0][e]);
      else mx1 = fmaxf(mx1, s[0][e]);
    }
    quad_max(mx0, mx1);
    if (t == 0) {
      mxs[warp * 16 + g] = mx0;
      mxs[warp * 16 + g + 8] = mx1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mx0 = fmaxf(mx0, mxs[w * 16 + g]);
      mx1 = fmaxf(mx1, mxs[w * 16 + g + 8]);
    }
    float a0, a1;
    softmax_step(s, mx0, mx1, m0, m1, l0, l1, a0, a1);
    if constexpr (IS_F32<T>) {
      *reinterpret_cast<float2*>(ps + g * PS + lk + 2 * t) = make_float2(s[0][0], s[0][1]);
      *reinterpret_cast<float2*>(ps + (g + 8) * PS + lk + 2 * t) = make_float2(s[0][2], s[0][3]);
    } else {  // as bf16 values (exact in fp32)
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s[0][0], s[0][1]), hi = __floats2bfloat162_rn(s[0][2], s[0][3]);
      *reinterpret_cast<float2*>(ps + g * PS + lk + 2 * t) = __bfloat1622float2(lo);
      *reinterpret_cast<float2*>(ps + (g + 8) * PS + lk + 2 * t) = __bfloat1622float2(hi);
    }
    rescale(acc, a0, a1, npairs);

    // O += P.V over this warp's columns, v staged vk keys at a time
    for (int kc0 = 0; kc0 < KEYS; kc0 += vk) {
      __syncthreads();  // p written; the last step's readers of v are done
      if (v16) stage_rows16(vc, sv, vg, DV, key0 + kc0, vk, J, cb0, vcols, cb0 + bn);
      else stage_rows(vc, sv, vg, DV, key0 + kc0, vk, J, cb0, vcols, cb0 + bn);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (npairs > 0) {
        for (int k16 = 0; k16 < vk; k16 += 16) {
          float c[2][4];  // p's C fragments of keys kc0 + k16 .. + 15
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* pr = ps + g * PS + kc0 + k16 + 8 * n + 2 * t;
            const float2 x0 = *reinterpret_cast<const float2*>(pr);
            const float2 x1 = *reinterpret_cast<const float2*>(pr + 8 * PS);
            c[n][0] = x0.x;
            c[n][1] = x0.y;
            c[n][2] = x1.x;
            c[n][3] = x1.y;
          }
          accumulate(acc, c, vc + w0, sv, k16, npairs, lane);
        }
      }
    }
  }

  // the row sums: over the quad, then over the warps in order
  quad_sum(l0, l1);
  if (t == 0) {
    lss[warp * 16 + g] = l0;
    lss[warp * 16 + g + 8] = l1;
  }
  __syncthreads();
  l0 = l1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    l0 += lss[w * 16 + g];
    l1 += lss[w * 16 + g + 8];
  }
  write_partials<T>(part_ml, part_acc, (bh * n_splits + split_id) * (size_t)I, acc, I, DV, gr0, gr1, cb0 + w0, wn,
                    npairs, t, cblock == 0 && warp == 0, m0, m1, l0, l1);
}

// One block per (row, batch x head): merges the row's splits. The first
// warp takes m = max m_s and l = sum l_s e^(m_s - m) (each lane over every
// 32nd split, then a fixed shuffle tree: the same order for every row) and
// writes each split's weight e^(m_s - m) / l to shared memory, 0 for a
// split that saw no key of the row; then every thread sums its columns'
// partials in split order. A row that sees no key gets o = 0, lse = MASK.
template <typename T>
__global__ void __launch_bounds__(128)
flash_fwd_wide_mma_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                                T* __restrict__ o, float* __restrict__ lse, int I, int DV, int n_splits) {
  extern __shared__ float weights[];  // n_splits
  const int row = blockIdx.x, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + bh * n_splits * (size_t)I + row;
  const float* acc = part_acc + (bh * n_splits * (size_t)I + row) * DV;
  if (threadIdx.x < 32) {
    float m = -INFINITY;
    for (int s = lane; s < n_splits; s += 32) {
      const float2 p = ml[(size_t)s * I];
      if (p.y > 0.f) m = fmaxf(m, p.x);
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
    float l = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float2 p = ml[(size_t)s * I];
      const float w = p.y > 0.f ? expf(p.x - m) : 0.f;
      weights[s] = w;
      l += p.y * w;
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int s = lane; s < n_splits; s += 32) weights[s] *= inv;
    if (lane == 0) lse[bh * I + row] = l > 0.f ? m + logf(l) : MASK;
  }
  __syncthreads();
  T* orow = o + (bh * I + row) * DV;
  const size_t stride = (size_t)I * DV;  // from one split's partial of the row to the next's
  for (int d = threadIdx.x; d < DV; d += blockDim.x) {
    float a = 0.f;
    int s = 0;
    for (; s + 4 <= n_splits; s += 4) {  // four loads in flight
      const float x0 = acc[s * stride + d], x1 = acc[(s + 1) * stride + d];
      const float x2 = acc[(s + 2) * stride + d], x3 = acc[(s + 3) * stride + d];
      a += x0 * weights[s];
      a += x1 * weights[s + 1];
      a += x2 * weights[s + 2];
      a += x3 * weights[s + 3];
    }
    for (; s < n_splits; ++s) a += acc[s * stride + d] * weights[s];
    store(&orow[d], a);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* pad;
  float* part_ml;
  float* part_acc;
  int B, H, I, J, D, DV, n_splits, tiles_per_split, causal;
  cudaStream_t stream;
};

template <typename T, int ROWS_T, int NP>
cudaError_t launch_rows(const Args& a) {
  constexpr int NKEYS = keys_of<T>(true, ROWS_T);
  const int base = fused_smem<T>(ROWS_T, a.D, a.DV);
  const int spans = base + flat_bytes(NKEYS, a.D) + flat_bytes(NKEYS, a.DV);
  // bf16 stages k and v through flat spans where their (batch, head) slices
  // start on 16-byte boundaries and the spans fit
  const int flat = !IS_F32<T> && aligned16(a.k) && aligned16(a.v) && (long long)a.J * a.D % 8 == 0 &&
                   (long long)a.J * a.DV % 8 == 0 && spans <= SMEM_LIMIT;
  const int smem = flat ? spans : base;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wide_mma_kernel<T, ROWS_T, NP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.I + ROWS_T - 1) / ROWS_T), a.n_splits, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                            static_cast<const T*>(a.v), a.pad, a.part_ml, a.part_acc, a.H, a.I,
                                            a.J, a.D, a.DV, a.tiles_per_split, a.causal, flat);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const Args& a, int n_cblocks) {
  const int vcols = WARPS * group_width(group_width(a.DV, n_cblocks), WARPS);
  int vk = KEYS;  // the most keys of v a step whose tile fits
  while (vk > 16 && split_smem<T>(vk, vcols) > SMEM_LIMIT) vk >>= 1;
  const int smem = split_smem<T>(vk, vcols);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wide_mma_cols_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.I + ROWS_SMALL - 1) / ROWS_SMALL * n_cblocks), a.n_splits, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                            static_cast<const T*>(a.v), a.pad, a.part_ml, a.part_acc, a.H, a.I,
                                            a.J, a.D, a.DV, n_cblocks, a.tiles_per_split, a.causal, vk);
  return cudaGetLastError();
}

// whole rows: the instantiation of the query rows
template <typename T, int NP>
cudaError_t launch_fused(const Args& a) {
  constexpr int BIG = IS_F32<T> ? ROWS_FP32 : ROWS_BF16;
  return rows_of<T>(true, a.I) == ROWS_SMALL ? launch_rows<T, ROWS_SMALL, NP>(a) : launch_rows<T, BIG, NP>(a);
}

template <typename T>
cudaError_t launch(const Args& a, void* o, float* lse) {
  cudaError_t err;
  if (!fused_of(a.D, a.DV)) err = launch_cols<T>(a, col_blocks_of(false, a.DV));
  else if (pairs_of(a.DV) == 9) err = launch_fused<T, 9>(a);
  else err = launch_fused<T, GROUP / 16>(a);
  if (err != cudaSuccess) return err;
  flash_fwd_wide_mma_merge_kernel<T><<<dim3(a.I, a.B * a.H), 128, a.n_splits * sizeof(float), a.stream>>>(
      a.part_ml, a.part_acc, static_cast<T*>(o), lse, a.I, a.DV, a.n_splits);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), k (B,H,J,D) and v
// (B,H,J,DV) contiguous, any D, DV >= 1 and any alignment; pad (B,J) uint8
// or null; o (B,H,I,DV) in the input type; lse (B,H,I) fp32. The kernel
// takes its query rows, keys and column blocks from (I, D, DV, dtype):
// rows 128 (bf16) or 64 (fp32) where round16(D) and round16(DV) <= 272 and
// I > 16, else 16; column blocks 1 there, else ceil(DV / 2176). The splits
// are the plan's (ops/flash_attention.py `_wide_mma_fwd_plan`), checked
// here: the ceil(J / keys) key tiles (keys 128 for bf16's 16-row tiles of
// whole rows, else 64) cut into n_splits splits of tiles_per_split (the
// last may be shorter, none empty; n_splits <= 8192), with scratch part_ml
// (B,H,n_splits,I,2) and part_acc (B,H,n_splits,I,DV) fp32.
// dtype: 0 = float32, 1 = bfloat16. Returns the launches' cudaError_t
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int flash_attention_fwd_wide_mma(const void* q, const void* k, const void* v, const void* pad, void* o,
                                            void* lse, void* part_ml, void* part_acc, int B, int H, int I, int J,
                                            int D, int DV, int n_splits, int tiles_per_split, int causal,
                                            int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<float*>(part_ml),
               static_cast<float*>(part_acc), B, H, I, J, D, DV, n_splits, tiles_per_split, causal,
               static_cast<cudaStream_t>(stream)};
  if (B < 1 || H < 1 || I < 1 || J < 1 || D < 1 || DV < 1 || B * H > 65535 || dtype < 0 || dtype > 1) {
    return cudaErrorInvalidValue;
  }
  const bool fused = fused_of(D, DV);
  const int rows = dtype == 0 ? rows_of<float>(fused, I) : rows_of<bf16>(fused, I);
  const int keys = dtype == 0 ? keys_of<float>(fused, rows) : keys_of<bf16>(fused, rows);
  const int n_tiles = (J + keys - 1) / keys;
  if (tiles_per_split < 1 || n_splits < 1 || n_splits > 8192 ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles || (long long)n_splits * tiles_per_split < n_tiles) {
    return cudaErrorInvalidValue;
  }
  float* l = static_cast<float*>(lse);
  return dtype == 0 ? launch<float>(a, o, l) : launch<bf16>(a, o, l);
}
