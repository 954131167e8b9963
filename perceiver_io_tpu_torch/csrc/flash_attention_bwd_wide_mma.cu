// Flash attention backward for Hopper (sm_90a) at any head dims, on the
// tensor cores: the `wide_mma` route of K2 (dq) and K3 (dk, dv), for every
// (q/k head dim d, v head dim dv) pair that the wgmma and tf32x3 routes do
// not instantiate (csrc/head_dims.cuh), fp32 or bf16, d and dv run-time
// arguments. csrc/flash_attention_bwd_wide.cu (`wide`, CUDA-core tiles) is
// the earlier design at those pairs, reached only by name.
//
// Replaces the Pallas TPU kernels `_backward_dq` and `_backward_dkv` in
// perceiver_io_tpu/ops/flash_attention.py at those widths, with the same
// function as the other routes: p = exp(s - lse) recomputed from the
// forward's logsumexp over pre-scaled queries, ds = p * (do.v^T - delta)
// with delta = rowsum(o * do) from the caller (fp32), then
//   K2: dq = ds . k
//   K3: dv = p^T . do, dk = ds^T . q
// under the forward's masks (right-aligned causal `col <= row + (j - i)`,
// an optional (b, j) key pad mask), by select only: a dead row's lse is the
// mask value, so exp(s - lse) overflows there; a row that sees no key gets
// dq = 0 exactly, a key that no row sees dk = dv = 0 exactly. p and ds are
// rounded to the input type before their products, as on the TPU; every sum
// is fp32; no atomics, so every output is deterministic.
//
// What bounds them on the H100. At the image classifier's training cross
// attend (512 latents over 50176 pixels, one head, d = dv = 261) K2 does
// 4d + 2dv flops a visible (query, key) pair and K3 4d + 4dv, hundreds of
// flops per byte of q, k, v and do: operations bound both, so the products
// run on the tensor cores: bf16 as mma.sync.m16n8k16 (csrc/mma_bf16.cuh),
// fp32 as three TF32 products per fp32 product (csrc/tf32x3.cuh's split and
// mma3: fp32-accurate, TF32 arithmetic itself stays off). At the image
// decoder's one query over 512 latents (d = dv = 1024) they read k and v
// once and do little else: bytes bound them, and a 64-row query tile would
// waste 63 rows, so query tiles are 16 rows (mma's m16) where i <= 16.
// Not wgmma with TMA: TMA needs global row strides that are multiples of
// 16 bytes, and d = 261 gives 522 (bf16) or 1044 (fp32). The block stages
// its own tiles into shared memory instead, any alignment, with zeros past
// d and past the ragged row and key edges: fp32 by cp.async (every element
// is 4-byte aligned); bf16 whole rows, where the bases allow, as each
// tile's contiguous span by 16-byte cp.async, unpacked in shared memory
// while the next tile's span loads, else through registers (every other
// row of d = 261 starts on an odd element, which no 4-byte copy reaches).
// Staging, not the products, first bounded these kernels: a staged pair
// that waited on its own load cost an L2 round trip. The fragments are
// read with ldmatrix (fp32 tiles too: a 16-bit pair is one fp32 value),
// and with 8-byte loads where fp32's second products read B along k. The
// staging and one warp's products live in csrc/wide_mma.cuh, which K1's
// wide_mma forward (csrc/flash_attention_fwd_wide_mma.cu) shares.
//
// Tiles. Widths are padded to multiples of 16 columns; a tile's row stride
// is that plus 8 (bf16: an odd number of 16-byte units, so the 8 rows of an
// ldmatrix fall on 8 distinct units) or plus 4 (fp32: 4 mod 16, the tf32x3
// routes' stride, which also serves the 8-byte reads of rows 2t and 2t + 1).
// An output accumulator holds at most GROUP = 272 columns a warp (136 fp32
// registers a thread). When d and dv both fit one group (d, dv <= 272: the
// image encoder's 261, MNIST's 131), whole rows of q, k, v and do are
// staged ("fused"); a wider pair is cut into column groups over the grid,
// and the score products then stream their operands through CHUNK-column
// steps, each group computing the scores once for all of its columns.
//   K2: one block (8 warps) per (query tile x column group of dq, key
//       split, batch x head). q and do are staged once. Per key tile of its
//       split (64 keys, 128 at bf16's 16-row tiles): the key flags, k and v;
//       each warp computes S = Q.K^T and dP = dO.V^T for its 16 rows and
//       its share of the tile's keys, p and ds under the select in
//       registers, and dQ += dS.K over the group's columns with dS's C
//       fragments as the A operand as they stand (bf16: packed pairs; fp32:
//       the permuted k-order of csrc/tf32x3.cuh). The warps that share rows
//       add their sums in a fixed order through shared memory; each block
//       writes its split's fp32 partial, and a second launch sums a row's
//       splits in split order and casts. The splits (the plan, ops/
//       flash_attention.py `_wide_mma_plan`) bring the row tiles, groups,
//       heads and splits of one batch row to 264 blocks.
//   K3: one block per (64-key tile x column group, batch x head), four
//       pairs of warps on its 16-key quarters. Per query tile (from the
//       first whose causal bound reaches the keys): one warp of a pair
//       computes S^T = K.Q^T and p^T under the select, the other dP^T =
//       V.dO^T; p^T crosses to the second through shared memory (fp32,
//       lane-contiguous: no bank conflict), which forms ds^T = p^T (dP^T -
//       delta). Then the first accumulates dV += P^T.dO and the second
//       dK += dS^T.Q over the group's columns: the scores once per tile for
//       both outputs. A block owns its keys and columns.
// 8 warps a block and 205-222 KB of shared memory at d = dv = 261: one
// block an SM, no register cap (__launch_bounds__(256, 1)); 240-255
// registers, no spill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // the bf16 products (through wide_mma.cuh)
#include "tf32x3.cuh"    // THREADS, SMEM_LIMIT; the fp32 products (through wide_mma.cuh)
#include "vec16.cuh"     // store
#include "wide_mma.cuh"  // stride_of, group_width, staging, score, accumulate, acc_col

namespace {

constexpr int GROUP = 272;       // most output columns a warp accumulates: 17 pairs of n-tiles
constexpr int CHUNK = 64;        // head-dim columns of a staged score step when rows are not staged whole
constexpr int KEYS = 64;         // keys of a K3 tile, and of a K2 tile but at bf16's 16-row query tiles
constexpr int KEYS_SMALL = 128;  // keys of a K2 tile at bf16's 16-row query tiles: 16 a warp
constexpr int ROWS_BF16 = 64;    // query rows of a tile where i > 16
constexpr int ROWS_FP32 = 32;    // (fp32 tiles take twice the bytes)
constexpr int ROWS_SMALL = 16;   // query rows of a tile where i <= 16

template <typename T>
__host__ __device__ constexpr int rows_of(bool small) {
  return small ? ROWS_SMALL : (IS_F32<T> ? ROWS_FP32 : ROWS_BF16);
}

template <typename T>
__host__ __device__ constexpr int dq_keys(int rows) {
  return !IS_F32<T> && rows == ROWS_SMALL ? KEYS_SMALL : KEYS;
}

// whole rows of q, k, v and do are staged when both widths fit one group
__host__ __device__ constexpr bool fused_of(int D, int DV) {
  return round16(D) <= GROUP && round16(DV) <= GROUP;
}

// column groups: K2's over d; K3's over d and dv together (a group serves
// its columns of both)
__host__ __device__ constexpr int dq_groups_of(int D) { return (D + GROUP - 1) / GROUP; }
__host__ __device__ constexpr int dkv_groups_of(int D, int DV) { return imax(dq_groups_of(D), dq_groups_of(DV)); }

// K2's shared memory: the tiles, and where the key flags start (past the
// tiles and past the buffer that adds the warps' sums at the end)
template <typename T>
__host__ __device__ constexpr int dq_flags_at(int rows, int D, int DV, int n_groups) {
  const int keys = dq_keys<T>(rows), e = sizeof(T);
  const int tiles = fused_of(D, DV)
                        ? (rows + keys) * (stride_of<T>(D) + stride_of<T>(DV)) * e
                        : ((2 * rows + 2 * keys) * stride_of<T>(CHUNK) + keys * stride_of<T>(group_width(D, n_groups))) * e;
  const int sums = (8 - rows / 16) * (GROUP / 8) * 4 * 32 * 4;
  return imax(tiles, sums);
}

template <typename T>
__host__ __device__ constexpr int dq_smem(int rows, int D, int DV, int n_groups) {
  return dq_flags_at<T>(rows, D, DV, n_groups) + dq_keys<T>(rows) * 4;
}

// K3's: the tiles, then p^T's crossing (KEYS x rows fp32), lse and delta
template <typename T>
__host__ __device__ constexpr int dkv_tiles(int rows, int D, int DV, int n_groups) {
  const int e = sizeof(T);
  return fused_of(D, DV)
             ? (KEYS + rows) * (stride_of<T>(D) + stride_of<T>(DV)) * e
             : ((2 * KEYS + 2 * rows) * stride_of<T>(CHUNK) +
                rows * (stride_of<T>(group_width(D, n_groups)) + stride_of<T>(group_width(DV, n_groups)))) * e;
}

template <typename T>
__host__ __device__ constexpr int dkv_smem(int rows, int D, int DV, int n_groups) {
  return dkv_tiles<T>(rows, D, DV, n_groups) + (KEYS * rows + 2 * rows) * 4;
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wide_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                             const float* __restrict__ delta, const T* __restrict__ dout,
                             float* __restrict__ part_dq, int H, int I, int J, int D, int DV, int n_groups,
                             int tiles_per_split, int causal, int flat) {
  constexpr int NKEYS = dq_keys<T>(ROWS);
  constexpr int RG = ROWS / 16, KW = 8 / RG;  // row groups of 16; warps on each, over its share of the keys
  constexpr int WK = NKEYS / KW, NK = WK / 8, NC = GROUP / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / KW, kw = warp - rg * KW, g = lane >> 2, t = lane & 3;
  const int row_tile = blockIdx.x / n_groups, group = blockIdx.x - row_tile * n_groups;
  const int split_id = blockIdx.y, n_splits = gridDim.y;
  const size_t bh = blockIdx.z;
  const int bb = blockIdx.z / H;
  const int row0 = row_tile * ROWS, offset = J - I;
  const bool fused = fused_of(D, DV);
  const int gw = group_width(D, n_groups), g0 = group * gw, gn = imin(gw, D - g0);
  const int npairs = gn > 0 ? (gn + 15) >> 4 : 0;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;
  const T* dog = dout + bh * (size_t)I * DV;

  const int sd = stride_of<T>(D), sv = stride_of<T>(DV), sch = stride_of<T>(CHUNK);
  T* qs = reinterpret_cast<T*>(smem);  // fused: whole rows of q, do, k, v
  T* dos = qs + ROWS * sd;
  T* ks = dos + ROWS * sv;
  T* vs = ks + NKEYS * sd;
  T* qc = qs;  // else: CHUNK-column steps of q, do, k, v, and k's group columns (in ks)
  T* doc = qc + ROWS * sch;
  T* kc = doc + ROWS * sch;
  T* vc = kc + NKEYS * sch;
  if (!fused) ks = vc + NKEYS * sch;
  const int sk = fused ? sd : stride_of<T>(gw);
  float* okf = reinterpret_cast<float*>(smem + dq_flags_at<T>(ROWS, D, DV, n_groups));
  T* fk = reinterpret_cast<T*>(smem + dq_smem<T>(ROWS, D, DV, n_groups));  // flat: the spans of k and v
  T* fv = fk + flat_bytes(NKEYS, D) / sizeof(T);

  const int lr0 = 16 * rg + g, gr0 = row0 + lr0, gr1 = gr0 + 8;
  const float lse0 = gr0 < I ? lse[bh * I + gr0] : 0.f, lse1 = gr1 < I ? lse[bh * I + gr1] : 0.f;
  const float del0 = gr0 < I ? delta[bh * I + gr0] : 0.f, del1 = gr1 < I ? delta[bh * I + gr1] : 0.f;

  const int n_tiles = (J + NKEYS - 1) / NKEYS;
  const int begin = split_id * tiles_per_split;
  int end = imin(begin + tiles_per_split, n_tiles);
  if (causal) end = imin(end, (imin(row0 + ROWS, I) - 1 + offset) / NKEYS + 1);

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (fused) {  // published by the first tile's barriers
    stage_rows(qs, sd, qg, D, row0, ROWS, I, 0, round16(D), D);
    stage_rows(dos, sv, dog, DV, row0, ROWS, I, 0, round16(DV), DV);
    settle<T>();
  }
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
    bool ok = false;
    if (tid < NKEYS) {
      ok = key_valid(pad, bb, J, key0 + tid);
      okf[tid] = ok ? 1.f : 0.f;
    }
    const bool live = __syncthreads_or(ok);  // some key of the tile unmasked
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

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if (fused) {
      if (!flat) {
        stage_rows(ks, sd, kg, D, key0, NKEYS, J, 0, round16(D), D);
        stage_rows(vs, sv, vg, DV, key0, NKEYS, J, 0, round16(DV), DV);
        settle<T>();
        __syncthreads();
      }
      score(s, qs, sd, 16 * rg, ks, sd, kw * WK, round16(D), lane);
      score(dp, dos, sv, 16 * rg, vs, sv, kw * WK, round16(DV), lane);
    } else {
      const int steps = (imax(D, DV) + CHUNK - 1) / CHUNK;
      for (int st = 0; st < steps; ++st) {
        const int c0 = st * CHUNK;
        if (st > 0) __syncthreads();  // the last step's readers are done
        if (c0 < D) {
          stage_rows(qc, sch, qg, D, row0, ROWS, I, c0, CHUNK, D);
          stage_rows(kc, sch, kg, D, key0, NKEYS, J, c0, CHUNK, D);
        }
        if (c0 < DV) {
          stage_rows(doc, sch, dog, DV, row0, ROWS, I, c0, CHUNK, DV);
          stage_rows(vc, sch, vg, DV, key0, NKEYS, J, c0, CHUNK, DV);
        }
        settle<T>();
        __syncthreads();
        if (c0 < D) score(s, qc, sch, 16 * rg, kc, sch, kw * WK, imin(CHUNK, round16(D - c0)), lane);
        if (c0 < DV) score(dp, doc, sch, 16 * rg, vc, sch, kw * WK, imin(CHUNK, round16(DV - c0)), lane);
      }
      if (gn > 0) stage_rows(ks, sk, kg, D, key0, NKEYS, J, g0, gw, g0 + gn);  // ks was last read a tile ago
      settle<T>();
      __syncthreads();
    }

    // p and ds under the select (a dead row's exp overflows), ds into s
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = kw * WK + 8 * n + 2 * t + (e & 1);
        const int gr = e < 2 ? gr0 : gr1;
        const bool allowed = gr < I && okf[lc] != 0.f && (!causal || key0 + lc <= gr + offset);
        const float p = allowed ? expf(s[n][e] - (e < 2 ? lse0 : lse1)) : 0.f;
        s[n][e] = allowed ? p * (dp[n][e] - (e < 2 ? del0 : del1)) : 0.f;
      }
    }
    // dQ += dS . K over the group's columns (K rows = this warp's keys)
    accumulate(acc, s, ks, sk, kw * WK, npairs, lane);
  }

  // the row group's warps add their sums in a fixed order, and warp 0 of
  // each writes this split's partial dq over the group's columns (zeros if
  // the split saw no key)
  __syncthreads();  // every reader of the tiles is done: their space takes the sums
  float* sums = reinterpret_cast<float*>(smem);
  if (kw > 0) {
    float* r = sums + (rg * (KW - 1) + kw - 1) * NC * 4 * 32 + lane;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if ((n >> 1) < npairs)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[(4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (kw == 0) {
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      const float* r = sums + (rg * (KW - 1) + w - 1) * NC * 4 * 32 + lane;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        if ((n >> 1) < npairs)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += r[(4 * n + e) * 32];
    }
    float* out = part_dq + (bh * n_splits + split_id) * (size_t)I * D + g0;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if ((n >> 1) < npairs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = acc_col<T>(n, e, t), gr = e < 2 ? gr0 : gr1;
          if (gr < I && col < gn) out[(size_t)gr * D + col] = acc[n][e];
        }
      }
    }
  }
}

// dq = the sum of the splits' partials, in split order, cast to the input type
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dq_wide_mma_sum_kernel(const float* __restrict__ part_dq, T* __restrict__ dq, int I, int D,
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

template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wide_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const uint8_t* __restrict__ pad, const float* __restrict__ lse,
                              const float* __restrict__ delta, const T* __restrict__ dout, T* __restrict__ dk,
                              T* __restrict__ dv, int H, int I, int J, int D, int DV, int n_groups, int causal,
                              int flat) {
  constexpr int NQ = ROWS / 8;    // n-tiles of a warp's S^T or dP^T: its 16 keys x the tile's queries
  constexpr int NC = GROUP / 8;   // accumulator n-tiles
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int role = warp >> 2;  // 0: S^T, p^T and dV; 1: dP^T, ds^T and dK
  const int quarter = warp & 3, kr = 16 * quarter, g = lane >> 2, t = lane & 3;
  const int key_tile = blockIdx.x / n_groups, group = blockIdx.x - key_tile * n_groups;
  const size_t bh = blockIdx.y;
  const int bb = blockIdx.y / H;
  const int col0 = key_tile * KEYS, offset = J - I;
  const bool fused = fused_of(D, DV);
  const int gwk = group_width(D, n_groups), gwv = group_width(DV, n_groups);
  const int gk0 = group * gwk, gv0 = group * gwv;
  const int gk_n = imin(gwk, D - gk0), gv_n = imin(gwv, DV - gv0);  // <= 0: no columns of that output
  const int c_base = role == 0 ? gv0 : gk0, c_n = role == 0 ? gv_n : gk_n;
  const int npairs = c_n > 0 ? (c_n + 15) >> 4 : 0;
  const T* qg = q + bh * (size_t)I * D;
  const T* kg = k + bh * (size_t)J * D;
  const T* vg = v + bh * (size_t)J * DV;
  const T* dog = dout + bh * (size_t)I * DV;

  const int sd = stride_of<T>(D), sv = stride_of<T>(DV), sch = stride_of<T>(CHUNK);
  T* ks = reinterpret_cast<T*>(smem);  // fused: whole rows of k, v, q, do
  T* vs = ks + KEYS * sd;
  T* qs = vs + KEYS * sv;
  T* dos = qs + ROWS * sd;
  T* kc = ks;  // else: CHUNK-column steps of k, v, q, do; q's and do's group columns (in qs, dos)
  T* vc = kc + KEYS * sch;
  T* qc = vc + KEYS * sch;
  T* doc = qc + ROWS * sch;
  int sq = sd, sdo = sv;
  if (!fused) {
    qs = doc + ROWS * sch;
    sq = stride_of<T>(gwk);
    dos = qs + ROWS * sq;
    sdo = stride_of<T>(gwv);
  }
  float* pex = reinterpret_cast<float*>(smem + dkv_tiles<T>(ROWS, D, DV, n_groups));
  float* lse_s = pex + KEYS * ROWS;
  float* del_s = lse_s + ROWS;
  T* fq = reinterpret_cast<T*>(smem + dkv_smem<T>(ROWS, D, DV, n_groups));  // flat: the spans of q and do
  T* fdo = fq + flat_bytes(ROWS, D) / sizeof(T);

  const int lk0 = kr + g, lk1 = lk0 + 8;  // this thread's keys of the tile (rows g, g + 8 of its C fragments)
  const bool ok0 = key_valid(pad, bb, J, col0 + lk0), ok1 = key_valid(pad, bb, J, col0 + lk1);
  const bool live = __syncthreads_or(ok0 || ok1);  // some key of the tile unmasked
  const int n_tiles = (I + ROWS - 1) / ROWS;
  int t0 = 0;
  if (causal) {
    // the first query tile whose last row sees col0: t * ROWS + ROWS - 1 + offset >= col0
    const int x = col0 - offset - ROWS + 1;
    t0 = x <= 0 ? 0 : (x + ROWS - 1) / ROWS;
  }

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (live) {
    if (fused) {  // published by the first query tile's barriers
      stage_rows(ks, sd, kg, D, col0, KEYS, J, 0, round16(D), D);
      stage_rows(vs, sv, vg, DV, col0, KEYS, J, 0, round16(DV), DV);
      settle<T>();
    }
    if constexpr (!IS_F32<T>) {
      if (flat && t0 < n_tiles) {
        flat_issue(fq, qg, D, t0 * ROWS, ROWS, I);
        flat_issue(fdo, dog, DV, t0 * ROWS, ROWS, I);
        cp_async_commit();
      }
    }
    for (int it = t0; it < n_tiles; ++it) {
      const int row0 = it * ROWS;
      __syncthreads();  // the last tile's readers of the query tiles, p^T, lse and delta are done
      if (tid < ROWS) {
        const int gq = row0 + tid;
        lse_s[tid] = gq < I ? lse[bh * I + gq] : 0.f;
        del_s[tid] = gq < I ? delta[bh * I + gq] : 0.f;
      }
      float s[NQ][4];  // S^T (role 0) or dP^T (role 1): rows keys, columns queries
#pragma unroll
      for (int n = 0; n < NQ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if (fused) {
        if (flat) {  // this tile's spans have landed: lay them out, then start the next tile's
          if constexpr (!IS_F32<T>) {
            cp_async_wait<0>();
            __syncthreads();
            flat_unpack(qs, sd, fq, D, ROWS, imin(ROWS, I - row0));
            flat_unpack(dos, sv, fdo, DV, ROWS, imin(ROWS, I - row0));
            __syncthreads();
            if (it + 1 < n_tiles) {
              flat_issue(fq, qg, D, row0 + ROWS, ROWS, I);
              flat_issue(fdo, dog, DV, row0 + ROWS, ROWS, I);
              cp_async_commit();
            }
          }
        } else {
          stage_rows(qs, sd, qg, D, row0, ROWS, I, 0, round16(D), D);
          stage_rows(dos, sv, dog, DV, row0, ROWS, I, 0, round16(DV), DV);
          settle<T>();
          __syncthreads();
        }
        if (role == 0) score(s, ks, sd, kr, qs, sd, 0, round16(D), lane);
        else score(s, vs, sv, kr, dos, sv, 0, round16(DV), lane);
      } else {
        const int steps = (imax(D, DV) + CHUNK - 1) / CHUNK;
        for (int st = 0; st < steps; ++st) {
          const int c0 = st * CHUNK;
          if (st > 0) __syncthreads();  // the last step's readers are done
          if (c0 < D) {
            stage_rows(kc, sch, kg, D, col0, KEYS, J, c0, CHUNK, D);
            stage_rows(qc, sch, qg, D, row0, ROWS, I, c0, CHUNK, D);
          }
          if (c0 < DV) {
            stage_rows(vc, sch, vg, DV, col0, KEYS, J, c0, CHUNK, DV);
            stage_rows(doc, sch, dog, DV, row0, ROWS, I, c0, CHUNK, DV);
          }
          settle<T>();
          __syncthreads();
          if (role == 0 && c0 < D) score(s, kc, sch, kr, qc, sch, 0, imin(CHUNK, round16(D - c0)), lane);
          if (role == 1 && c0 < DV) score(s, vc, sch, kr, doc, sch, 0, imin(CHUNK, round16(DV - c0)), lane);
        }
        // the group's columns of q and do (last read a tile ago), published below
        if (gk_n > 0) stage_rows(qs, sq, qg, D, row0, ROWS, I, gk0, gwk, gk0 + gk_n);
        if (gv_n > 0) stage_rows(dos, sdo, dog, DV, row0, ROWS, I, gv0, gwv, gv0 + gv_n);
        settle<T>();
      }

      float* cross = pex + quarter * NQ * 4 * 32 + lane;
      if (role == 0) {  // p^T under the select (a dead row's exp overflows), to the partner warp
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lq = 8 * n + 2 * t + (e & 1), gq = row0 + lq;
            const int key = col0 + (e < 2 ? lk0 : lk1);
            const bool allowed = (e < 2 ? ok0 : ok1) && gq < I && (!causal || key <= gq + offset);
            const float p = allowed ? expf(s[n][e] - lse_s[lq]) : 0.f;
            s[n][e] = p;
            cross[(4 * n + e) * 32] = p;
          }
        }
      }
      __syncthreads();  // p^T crossed; the group tiles staged
      if (role == 1) {  // ds^T = p^T (dP^T - delta): 0 wherever p^T is
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = cross[(4 * n + e) * 32] * (s[n][e] - del_s[8 * n + 2 * t + (e & 1)]);
        accumulate(acc, s, qs, sq, 0, npairs, lane);  // dK += dS^T . Q
      } else {
        accumulate(acc, s, dos, sdo, 0, npairs, lane);  // dV += P^T . dO
      }
    }
  }

  const int width = role == 0 ? DV : D;
  T* out = (role == 0 ? dv + bh * (size_t)J * DV : dk + bh * (size_t)J * D) + c_base;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    if ((n >> 1) < npairs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = acc_col<T>(n, e, t), key = col0 + (e < 2 ? lk0 : lk1);
        if (key < J && col < c_n) store(&out[(size_t)key * width + col], acc[n][e]);
      }
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
bool flat_ok(const Args& a, int smem_with_spans) {
  return !IS_F32<T> && fused_of(a.D, a.DV) && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout) && (long long)a.I * a.D % 8 == 0 && (long long)a.I * a.DV % 8 == 0 &&
         (long long)a.J * a.D % 8 == 0 && (long long)a.J * a.DV % 8 == 0 && smem_with_spans <= SMEM_LIMIT;
}

template <typename T, int ROWS>
cudaError_t launch_dq(const Args& a, void* dq, float* part_dq, int n_groups, int n_splits, int tiles_per_split) {
  constexpr int NKEYS = dq_keys<T>(ROWS);
  const int spans = dq_smem<T>(ROWS, a.D, a.DV, n_groups) + flat_bytes(NKEYS, a.D) + flat_bytes(NKEYS, a.DV);
  const int flat = flat_ok<T>(a, spans);
  const int smem = flat ? spans : dq_smem<T>(ROWS, a.D, a.DV, n_groups);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wide_mma_kernel<T, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.I + ROWS - 1) / ROWS * n_groups), n_splits, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pad, a.lse,
      a.delta, static_cast<const T*>(a.dout), part_dq, a.H, a.I, a.J, a.D, a.DV, n_groups, tiles_per_split,
      a.causal, flat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)a.B * a.H * a.I * a.D;
  flash_bwd_dq_wide_mma_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
      part_dq, static_cast<T*>(dq), a.I, a.D, n_splits, total);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, int n_groups) {
  const int spans = dkv_smem<T>(ROWS, a.D, a.DV, n_groups) + flat_bytes(ROWS, a.D) + flat_bytes(ROWS, a.DV);
  const int flat = flat_ok<T>(a, spans);
  const int smem = flat ? spans : dkv_smem<T>(ROWS, a.D, a.DV, n_groups);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wide_mma_kernel<T, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.J + KEYS - 1) / KEYS * n_groups), a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.pad, a.lse,
      a.delta, static_cast<const T*>(a.dout), static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.I, a.J, a.D,
      a.DV, n_groups, a.causal, flat);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.B >= 1 && a.H >= 1 && a.I >= 1 && a.J >= 1 && a.D >= 1 && a.DV >= 1 && a.B * a.H <= 65535;
}

// the query tile's rows the plan passes: 16 where i <= 16, else the type's
template <typename T>
bool rows_ok(int rows, int I) {
  return rows == rows_of<T>(I <= ROWS_SMALL);
}

}  // namespace

// C interface, loaded with ctypes. q (B,H,I,D), do (B,H,I,DV), k (B,H,J,D)
// and v (B,H,J,DV) contiguous, any D, DV >= 1 and any alignment; pad (B,J)
// uint8 or null; lse and delta (B,H,I) fp32; outputs in the input type of
// their inputs' shapes. `rows` and the groups and splits are the plan's
// (ops/flash_attention.py `_wide_mma_plan`), checked here: rows 16 where
// I <= 16, else 64 (bf16) or 32 (fp32); K2's groups ceil(D / 272), K3's
// ceil(max(D, DV) / 272); K2's ceil(J / keys) key tiles (keys 128 for bf16
// at 16 rows, else 64) cut into n_splits splits of tiles_per_split (the
// last may be shorter, none empty), with scratch part_dq
// (B,H,n_splits,I,D) fp32. dtype: 0 = float32, 1 = bfloat16. Each returns
// the launches' cudaError_t (cudaErrorInvalidValue for arguments it does
// not take).
extern "C" int flash_attention_bwd_dq_wide_mma(const void* q, const void* k, const void* v, const void* pad,
                                               const void* lse, const void* delta, const void* dout, void* dq,
                                               void* part_dq, int B, int H, int I, int J, int D, int DV,
                                               int rows, int n_groups, int n_splits, int tiles_per_split,
                                               int causal, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, B, H, I, J, D, DV, causal,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a) || dtype < 0 || dtype > 1 || n_groups != dq_groups_of(D)) return cudaErrorInvalidValue;
  if (dtype == 0 ? !rows_ok<float>(rows, I) : !rows_ok<bf16>(rows, I)) return cudaErrorInvalidValue;
  const int keys = dtype == 0 ? dq_keys<float>(rows) : dq_keys<bf16>(rows);
  const int n_tiles = (J + keys - 1) / keys;
  if (tiles_per_split < 1 || n_splits < 1 || n_splits > 65535 ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles || (long long)n_splits * tiles_per_split < n_tiles) {
    return cudaErrorInvalidValue;
  }
  float* part = static_cast<float*>(part_dq);
  if (dtype == 0) {
    return rows == ROWS_SMALL ? launch_dq<float, ROWS_SMALL>(a, dq, part, n_groups, n_splits, tiles_per_split)
                              : launch_dq<float, ROWS_FP32>(a, dq, part, n_groups, n_splits, tiles_per_split);
  }
  return rows == ROWS_SMALL ? launch_dq<bf16, ROWS_SMALL>(a, dq, part, n_groups, n_splits, tiles_per_split)
                            : launch_dq<bf16, ROWS_BF16>(a, dq, part, n_groups, n_splits, tiles_per_split);
}

extern "C" int flash_attention_bwd_dkv_wide_mma(const void* q, const void* k, const void* v, const void* pad,
                                                const void* lse, const void* delta, const void* dout, void* dk,
                                                void* dv, int B, int H, int I, int J, int D, int DV, int rows,
                                                int n_groups, int causal, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(pad), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dout, B, H, I, J, D, DV, causal,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a) || dtype < 0 || dtype > 1 || n_groups != dkv_groups_of(D, DV)) return cudaErrorInvalidValue;
  if (dtype == 0 ? !rows_ok<float>(rows, I) : !rows_ok<bf16>(rows, I)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return rows == ROWS_SMALL ? launch_dkv<float, ROWS_SMALL>(a, dk, dv, n_groups)
                              : launch_dkv<float, ROWS_FP32>(a, dk, dv, n_groups);
  }
  return rows == ROWS_SMALL ? launch_dkv<bf16, ROWS_SMALL>(a, dk, dv, n_groups)
                            : launch_dkv<bf16, ROWS_BF16>(a, dk, dv, n_groups);
}
