// The pieces that K1's, K2's and K3's `wide` kernels share
// (csrc/flash_attention_fwd_wide.cu, csrc/flash_attention_bwd_wide.cu): the
// routes for every (q/k head dim d, v head dim dv) pair that no other route
// instantiates (csrc/head_dims.cuh), with d and dv runtime arguments.
//
// The score tiles are 64 x 64 on the CUDA cores in fp32, 256 threads a
// block: thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 16 r and
// columns tx + 16 c (r, c < 4) of a tile, so a row's reductions stay in one
// half-warp. The products over a head dim run in steps of KC columns staged
// in shared memory (any d: columns past it stage as 0), and an output
// accumulator holds at most GROUP columns a block (GROUP / 16 a thread, in
// registers), so an output wider than GROUP is cut into column groups over
// the grid, each recomputing the scores. The second product of each pair
// reads its B operand in chunks of VC columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"  // store

namespace {

constexpr int BM = 64;               // query rows a tile
constexpr int BN = 64;               // keys a tile
constexpr int THREADS = 256;         // 16 x 16
constexpr int KC = 32;               // head-dim columns staged per step of a score product
constexpr int KS = KC + 1;           // their row stride: odd, so column reads are free of bank conflicts
constexpr int PS = BN + 1;           // row stride of the probability tile
constexpr int VC = 64;               // columns staged per step of an accumulating product
constexpr int GROUP = 288;           // most output columns a block accumulates
constexpr int NC = GROUP / 16;       // accumulator columns a thread
constexpr int NV = (GROUP + VC - 1) / VC;  // VC-column steps over a group
// Large-but-finite mask value, as the TPU kernel's: the lse of a dead row.
constexpr float MASK = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
// p and ds are cast to the input type before their products, as on the TPU
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + 64) x columns [c0, c0 + W) of a row-major matrix of row
// stride ld into dst (row stride S) as fp32: 0 at rows >= n_rows or columns
// >= c_end. Every load of the thread is issued before the first store.
template <int W, int S, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int ld, int r0, int n_rows,
                                      int c0, int c_end) {
  constexpr int ITERS = 64 * W / THREADS;
  float vals[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int gr = r0 + idx / W, gc = c0 + idx % W;
    vals[it] = gr < n_rows && gc < c_end ? to_float(src[(size_t)gr * ld + gc]) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    dst[(idx / W) * S + idx % W] = vals[it];
  }
}

// acc[r][c] += sum over kc of a[(ty + 16 r) * KS + kc] * b[(tx + 16 c) * KS + kc]:
// one KC-column step of a 64 x 64 score product
__device__ __forceinline__ void score_step(float (&acc)[4][4], const float* a, const float* b, int ty,
                                           int tx) {
#pragma unroll 8
  for (int kc = 0; kc < KC; ++kc) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * KS + kc];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * KS + kc];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc += S = A . B^T over `depth` head-dim columns: A rows [ra, ra + 64) of
// a (na, depth) matrix, B rows [rb, rb + 64) of an (nb, depth) one, staged
// KC columns at a time through `buf` (2 * 64 * KS floats); every thread of
// the block calls it, and its first barrier guards `buf`
template <typename T>
__device__ __forceinline__ void score_product(float (&acc)[4][4], float* buf, const T* __restrict__ a,
                                              int ra, int na, const T* __restrict__ b, int rb, int nb,
                                              int depth, int ty, int tx) {
  float* as = buf;
  float* bs = buf + 64 * KS;
  for (int c0 = 0; c0 < depth; c0 += KC) {
    __syncthreads();  // the previous readers of buf are done
    stage<KC, KS>(as, a, depth, ra, na, c0, depth);
    stage<KC, KS>(bs, b, depth, rb, nb, c0, depth);
    __syncthreads();
    score_step(acc, as, bs, ty, tx);
  }
}

// acc[r][c] += sum over n of p[(ty + 16 r) * PS + n] * X[n][g0 + tx + 16 c]
// for the group's columns [g0, g0 + gwid): X rows [rx, rx + 64) of an (nx,
// ld) matrix, staged VC columns at a time through `buf` (64 * VC floats);
// every thread calls it, and its first barrier also publishes p
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[4][NC], float* buf, const float* p,
                                           const T* __restrict__ x, int ld, int rx, int nx, int g0,
                                           int gwid, int ty, int tx) {
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    if (m * VC >= gwid) break;
    __syncthreads();  // p written, the previous readers of buf done
    stage<VC, VC>(buf, x, ld, rx, nx, g0 + m * VC, g0 + gwid);
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = p[(ty + 16 * r) * PS + n];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (4 * m + cc < NC) {
          const float xv = buf[n * VC + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][4 * m + cc] = fmaf(pv[r], xv, acc[r][4 * m + cc]);
        }
      }
    }
  }
}

// the column groups of an output `width` wide: ceil(width / GROUP), of
// ceil(width / groups) columns each but the last
__host__ __device__ __forceinline__ int wide_groups(int width) { return (width + GROUP - 1) / GROUP; }

}  // namespace
