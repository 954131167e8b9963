// The pieces that the 3xTF32 flash-attention kernels share: the forward
// (csrc/flash_attention_fwd_tf32.cu, K1) and the backward
// (csrc/flash_attention_bwd_tf32.cu, K2 and K3). Each fp32 product runs as
// three TF32 products on mma.sync.m16n8k8; tiles are fp32 in shared memory,
// staged with cp.async. Those files' headers describe the scheme: the
// split into hi and lo parts, the fragment layouts, the permuted k-order
// that turns an accumulator into the next product's A fragment, and the
// d + 4 row stride that serves every read with no bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // queries per tile
constexpr int BN = 64;  // keys per tile
// two warps on each 16-row group of a 64-row tile, each over half of the
// tile's 64 columns: 8 warps
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <int D>
struct Tile {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int S = D + 4;        // row stride in floats
  static constexpr int FLOATS = 64 * S;  // one staged tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + 64) of a (rows, D) fp32 matrix into a (64, D + 4)
// tile, zeros past `limit`
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0, int limit) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const int g = row0 + r;
    const bool ok = g < limit;
    cp_async16(dst + r * Tile<D>::S + 4 * c, src + (size_t)(ok ? g : 0) * D + 4 * c, ok);
  }
}

// x = hi + lo: hi is x rounded to TF32 to nearest with ties away from zero
// (cvt.rna.tf32.f32's result for finite |x| below 2^128 (1 - 2^-12), with
// two integer operations: cvt runs slower), lo = x - hi exactly in fp32,
// which the tensor core reads truncated to TF32 (it ignores an operand's low
// 13 bits, as CUTLASS's 3xTF32 relies on). Past those values the integer
// rounding differs from cvt: a finite |x| that rounds up past the largest
// float gives hi = inf and lo = -inf, and a NaN whose payload lies in the
// low 13 bits gives hi = inf; lo is then -inf or NaN, so the product's sum
// is inf or NaN as it would be in fp32, never a finite wrong value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32, a split already, b = (b0, b1) split here: the two
// small cross terms first, then the big one
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                     float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

// the A fragment of rows r, r + 8 and columns k0 + t, k0 + t + 4 of a tile
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile, int r,
                                       int k0, int t) {
  const float* p = tile + r * S + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * S], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * S + 4], hi[3], lo[3]);
}

// the A fragment of a product summed over an accumulator's 8-column n-tile
// c, in the permuted order (k = t <-> column 2t, k = t + 4 <-> 2t + 1): c
// itself
__device__ __forceinline__ void a_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c)[4]) {
  split(c[0], hi[0], lo[0]);  // row g, column 2t
  split(c[2], hi[1], lo[1]);  // row g + 8, column 2t
  split(c[1], hi[2], lo[2]);  // row g, column 2t + 1
  split(c[3], hi[3], lo[3]);  // row g + 8, column 2t + 1
}

// acc[n] += a . tile[k-step kk], over every column pair of a (64, D + 4)
// tile read as the B operand in the permuted orders (rows 8kk + 2t and
// 8kk + 2t + 1; n-tiles 2m, 2m + 1 at columns 16m + 2g, 16m + 2g + 1)
template <int D>
__device__ __forceinline__ void mma3_columns(float (&acc)[D / 8][4], const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4], const float* tile, int kk,
                                             int g, int t) {
  constexpr int S = Tile<D>::S;
  const float* r0 = tile + (8 * kk + 2 * t) * S + 2 * g;
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    const float2 x0 = *reinterpret_cast<const float2*>(r0 + 16 * m);
    const float2 x1 = *reinterpret_cast<const float2*>(r0 + S + 16 * m);
    mma3(acc[2 * m], ahi, alo, x0.x, x1.x);
    mma3(acc[2 * m + 1], ahi, alo, x0.y, x1.y);
  }
}

// rows r and r + 8 (global g0, g1) of a (., D) output from an accumulator
// in the permuted column order: 16 bytes a row per column pair
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[D / 8][4], int g0, int g1,
                                           int limit, int t) {
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    const int c = 16 * m + 4 * t;
    if (g0 < limit)
      *reinterpret_cast<float4*>(out + (size_t)g0 * D + c) =
          make_float4(acc[2 * m][0], acc[2 * m + 1][0], acc[2 * m][1], acc[2 * m + 1][1]);
    if (g1 < limit)
      *reinterpret_cast<float4*>(out + (size_t)g1 * D + c) =
          make_float4(acc[2 * m][2], acc[2 * m + 1][2], acc[2 * m][3], acc[2 * m + 1][3]);
  }
}

template <bool HAS_PAD>
__device__ __forceinline__ bool key_ok(const uint8_t* __restrict__ pad, int bb, int J, int c) {
  return c < J && (!HAS_PAD || pad[(size_t)bb * J + c] == 0);
}

}  // namespace
