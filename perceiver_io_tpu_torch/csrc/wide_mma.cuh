// The pieces that the `wide_mma` flash-attention kernels share: K1's
// forward (csrc/flash_attention_fwd_wide_mma.cu) and K2's and K3's backward
// (csrc/flash_attention_bwd_wide_mma.cu), for every (q/k head dim d, v head
// dim dv) pair that the tile routes do not instantiate, d and dv at run
// time. They hold: the staged tiles' row strides (widths padded to
// multiples of 16 columns, plus 8 bf16 or 4 fp32 elements so that the 8 rows
// of an ldmatrix fall on distinct 16-byte units), the staging at any
// alignment (stage_rows: predicated register loads for bf16, cp.async for
// fp32; flat_issue and flat_unpack: a bf16 tile's contiguous span by
// 16-byte cp.async, laid out in shared memory; stage_rows16: 16-byte
// cp.async where every row starts on a 16-byte boundary), and one warp's
// products on mma.sync (score: A . B^T over staged columns; accumulate: C
// fragments of fp32 p or ds, rounded to the input type, times a tile read
// along k). bf16 runs mma.sync.m16n8k16 (csrc/mma_bf16.cuh), fp32 three TF32
// products per fp32 product (csrc/tf32x3.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"  // ldsm_x4, ldsm_x2, ldsm_x4_t, mma_bf16, bf16x2
#include "tf32x3.cuh"    // THREADS, split, mma3, a_from_c, cp_async_commit, cp_async_wait

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// the row stride, in elements, of a staged tile `width` columns wide
template <typename T>
__host__ __device__ constexpr int stride_of(int width) {
  return round16(width) + (IS_F32<T> ? 4 : 8);
}

// the columns of a group of an output `width` wide cut into n: group g
// covers [g * w, min((g + 1) * w, width)) with w = round16(ceil(width / n))
__host__ __device__ constexpr int group_width(int width, int n) { return round16((width + n - 1) / n); }

__device__ __forceinline__ bool key_valid(const uint8_t* __restrict__ pad, int bb, int J, int c) {
  return c < J && (pad == nullptr || pad[(size_t)bb * J + c] == 0);
}

// N bytes global -> shared, asynchronously: src_bytes of them read, the
// rest zeros (src must be a valid address even where src_bytes is 0)
template <int N>
__device__ __forceinline__ void cp_async_z(void* dst, const void* src, int src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_u32(dst)), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(shared_u32(dst)), "l"(src), "n"(N),
                 "r"(src_bytes)
                 : "memory");
  }
}

// fp32 staging copies asynchronously: its copies land before the barrier
// that publishes the tile (bf16's stage_rows has landed when it returns)
template <typename T>
__device__ __forceinline__ void settle() {
  if constexpr (IS_F32<T>) {
    cp_async_commit();
    cp_async_wait<0>();
  }
}

// one element's bits (0 where !ok), through the read-only path
__device__ __forceinline__ uint32_t load_raw(const bf16* __restrict__ p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
}

// rows [r0, r0 + n) x columns [c0, c0 + w) (w even) of a row-major matrix
// with rows of ld elements into dst (row stride s), in the input type:
// zeros at rows >= r_end or columns >= c_end. The block's threads stride
// over column pairs.
//   bf16: each pair is two element loads into registers, predicated and
//   not branched on, so that a row's alignment (d = 261 leaves every other
//   row on an odd element) costs nothing, and a thread's 16 loads of 8
//   pairs are all in flight before the first is used. (A 4-byte cp.async
//   for the pairs on a 4-byte boundary measured no faster.)
//   fp32: every element is 4-byte aligned, so each pair is one 8-byte
//   cp.async where its source allows, else two 4-byte ones, all in flight
//   at once; settle<float>() waits for them.
__device__ __forceinline__ void stage_rows(bf16* dst, int s, const bf16* __restrict__ src, int ld, int r0, int n,
                                           int r_end, int c0, int w, int c_end) {
  constexpr int U = 8;
  const int pairs = w >> 1, total = n * pairs;
  const int dr = THREADS / pairs, dc = THREADS - dr * pairs;
  int r = threadIdx.x / pairs;
  int c = threadIdx.x - r * pairs;
  for (int base = threadIdx.x; base < total; base += U * THREADS) {
    uint32_t lo[U], hi[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r0 + r, col = c0 + 2 * c;
      const bool row_ok = base + u * THREADS < total && row < r_end;
      const bf16* p = src + (size_t)row * ld + col;
      lo[u] = load_raw(p, row_ok && col < c_end);
      hi[u] = load_raw(p + 1, row_ok && col + 1 < c_end);
      at[u] = r * s + 2 * c;
      c += dc;
      r += dr;
      if (c >= pairs) {
        c -= pairs;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < total) *reinterpret_cast<uint32_t*>(dst + at[u]) = lo[u] | (hi[u] << 16);
  }
}

__device__ __forceinline__ void stage_rows(float* dst, int s, const float* __restrict__ src, int ld, int r0, int n,
                                           int r_end, int c0, int w, int c_end) {
  const int pairs = w >> 1, total = n * pairs;
  const int dr = THREADS / pairs, dc = THREADS - dr * pairs;
  int r = threadIdx.x / pairs;
  int c = threadIdx.x - r * pairs;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int row = r0 + r, col = c0 + 2 * c;
    const int k = row >= r_end || col >= c_end ? 0 : col + 1 < c_end ? 2 : 1;  // elements to read
    const float* p = src + (size_t)row * ld + col;
    float* d = dst + r * s + 2 * c;
    if (!(reinterpret_cast<uintptr_t>(p) & 7)) {
      cp_async_z<8>(d, k ? p : src, 4 * k);
    } else {
      cp_async_z<4>(d, k ? p : src, k ? 4 : 0);
      cp_async_z<4>(d + 1, k == 2 ? p + 1 : src, k == 2 ? 4 : 0);
    }
    c += dc;
    r += dr;
    if (c >= pairs) {
      c -= pairs;
      ++r;
    }
  }
}

// bf16 tiles of whole rows (the fused staging) where the matrices' bases
// and (batch, head) slices start on 16-byte boundaries: rows [r0, r0 + n)
// of a row-major (., ld) matrix are one contiguous span, which 16-byte
// cp.asyncs copy into `flat` (r0 is a multiple of 16, so the span starts on
// a boundary) while the block computes on the previous tile; the caller
// commits. flat_unpack then lays the span out as a tile (row stride s,
// zeros past ld columns and past the span's rows), 8 columns a thread: five
// 4-byte shared reads, a byte permute where the row starts on an odd
// element, one 16-byte store.
__device__ __forceinline__ void flat_issue(bf16* flat, const bf16* __restrict__ src, int ld, int r0, int n,
                                           int r_end) {
  const int bytes = imax(0, imin(n, r_end - r0)) * ld * 2;
  const char* g = reinterpret_cast<const char*>(src + (size_t)r0 * ld);
  char* f = reinterpret_cast<char*>(flat);
  for (int i = threadIdx.x * 16; i < bytes; i += THREADS * 16) cp_async_z<16>(f + i, g + i, imin(16, bytes - i));
}

__device__ __forceinline__ void flat_unpack(bf16* dst, int s, const bf16* flat, int ld, int n, int rows) {
  const int units = round16(ld) >> 3, total = n * units;
  const int dr = THREADS / units, dc = THREADS - dr * units;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(flat);
  int r = threadIdx.x / units;
  int u = threadIdx.x - r * units;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int c = 8 * u, valid = ld - c;  // columns of this unit inside the row
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && valid > 0) {
      const int f = r * ld + c;  // the span's element at (r, c)
      const uint32_t* x = words + (f >> 1);
      const uint32_t sel = (f & 1) ? 0x5432u : 0x3210u;
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = __byte_perm(x[k], x[k + 1], sel);
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = 2 * k >= valid ? 0u : 2 * k + 1 >= valid ? o[k] & 0xffffu : o[k];
      out = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(dst + r * s + c) = out;
    u += dc;
    r += dr;
    if (u >= units) {
      u -= units;
      ++r;
    }
  }
}

// the bytes of one span buffer: n rows of ld bf16, and room for the words
// flat_unpack reads past the span's end
__host__ __device__ constexpr int flat_bytes(int n, int ld) { return round16(n * ld * 2) + 32; }

// acc[n] += A . B^T over `depth` staged columns (a multiple of 16): A the
// 16 rows from ra of tile a (row stride sa), B the NT * 8 rows from rb of
// tile b; one warp
template <int NT>
__device__ __forceinline__ void score(float (&acc)[NT][4], const bf16* a, int sa, int ra, const bf16* b, int sb,
                                      int rb, int depth, int lane) {
  const bf16* pa = a + (ra + (lane & 15)) * sa + ((lane >> 4) << 3);
  const bf16* pb = b + (rb + (lane & 7) + ((lane >> 4) << 3)) * sb + (((lane >> 3) & 1) << 3);
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, pa + k0);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, pb + np * 16 * sb + k0);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
    if constexpr (NT % 2 == 1) {  // the last n-tile alone: lanes 0..15 give its two matrices' rows
      uint32_t bf[2];
      ldsm_x2(bf, pb + (NT - 1) * 8 * sb + k0);
      mma_bf16(acc[NT - 1], af, bf[0], bf[1]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void score(float (&acc)[NT][4], const float* a, int sa, int ra, const float* b,
                                      int sb, int rb, int depth, int lane) {
  const float* pa = a + (ra + (lane & 7) + (((lane >> 3) & 1) << 3)) * sa + ((lane >> 4) << 2);
  const float* pb = b + (rb + (lane & 7) + ((lane >> 4) << 3)) * sb + (((lane >> 3) & 1) << 2);
  for (int k0 = 0; k0 < depth; k0 += 8) {
    uint32_t ar[4], ahi[4], alo[4];
    ldsm_x4(ar, pa + k0);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(ar[e]), ahi[e], alo[e]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t br[4];
      ldsm_x4(br, pb + np * 16 * sb + k0);
      mma3(acc[2 * np], ahi, alo, __uint_as_float(br[0]), __uint_as_float(br[1]));
      mma3(acc[2 * np + 1], ahi, alo, __uint_as_float(br[2]), __uint_as_float(br[3]));
    }
    if constexpr (NT % 2 == 1) {
      uint32_t br[2];
      ldsm_x2(br, pb + (NT - 1) * 8 * sb + k0);
      mma3(acc[NT - 1], ahi, alo, __uint_as_float(br[0]), __uint_as_float(br[1]));
    }
  }
}

// acc += C . B over the columns of `npairs` pairs of n-tiles: C the warp's
// 16 x (KT * 8) fp32 fragments (p or ds), rounded to the input type as the
// A operand, B the KT * 8 rows from rb of a tile stored (k, n)
template <int KT, int NC>
__device__ __forceinline__ void accumulate(float (&acc)[NC][4], const float (&c)[KT][4], const bf16* b, int sb,
                                           int rb, int npairs, int lane) {
  static_assert(KT % 2 == 0, "bf16 sums over k in steps of 16");
  const bf16* pb = b + (rb + (lane & 7) + (((lane >> 3) & 1) << 3)) * sb + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t af[4] = {bf16x2(c[2 * kk][0], c[2 * kk][1]), bf16x2(c[2 * kk][2], c[2 * kk][3]),
                            bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]), bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      if (np < npairs) {
        uint32_t bf[4];
        ldsm_x4_t(bf, pb + kk * 16 * sb + np * 16);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// fp32: the sum over each C n-tile in the permuted k-order of
// csrc/tf32x3.cuh (k = t <-> column 2t, k = t + 4 <-> 2t + 1; B rows 2t and
// 2t + 1 of the k-step), output columns permuted in pairs of n-tiles
// (n-tile 2m column g <-> 16m + 2g, n-tile 2m + 1 <-> 16m + 2g + 1)
template <int KT, int NC>
__device__ __forceinline__ void accumulate(float (&acc)[NC][4], const float (&c)[KT][4], const float* b, int sb,
                                           int rb, int npairs, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ah[4], al[4];
    a_from_c(ah, al, c[kk]);
    const float* r0 = b + (rb + 8 * kk + 2 * t) * sb + 2 * g;
#pragma unroll
    for (int m = 0; m < NC / 2; ++m) {
      if (m < npairs) {
        const float2 x0 = *reinterpret_cast<const float2*>(r0 + 16 * m);
        const float2 x1 = *reinterpret_cast<const float2*>(r0 + sb + 16 * m);
        mma3(acc[2 * m], ah, al, x0.x, x1.x);
        mma3(acc[2 * m + 1], ah, al, x0.y, x1.y);
      }
    }
  }
}

// the output column of accumulator element e of n-tile n
template <typename T>
__device__ __forceinline__ int acc_col(int n, int e, int t) {
  if constexpr (IS_F32<T>) return 16 * (n >> 1) + 4 * t + 2 * (e & 1) + (n & 1);
  return 8 * n + 2 * t + (e & 1);
}

// bf16 stages whole rows through flat spans (flat_issue) where the inputs'
// (batch, head) slices start on 16-byte boundaries and the spans fit
__host__ __device__ inline bool aligned16(const void* p) { return !(reinterpret_cast<uintptr_t>(p) & 15); }

// rows [r0, r0 + n) x columns [c0, c0 + w) of a row-major matrix with rows
// of ld elements into dst (row stride s), as stage_rows, by 16-byte
// cp.async: for matrices whose rows and c0 start on 16-byte boundaries
// (ld and c0 multiples of 16 bytes' elements, the base aligned), w a
// multiple of those elements; zeros at rows >= r_end or columns >= c_end.
// The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_rows16(T* dst, int s, const T* __restrict__ src, int ld, int r0, int n,
                                             int r_end, int c0, int w, int c_end) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
  const int units = w / E, total = n * units;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int r = idx / units, u = idx - r * units;
    const int row = r0 + r, col = c0 + u * E;
    const int bytes = row < r_end ? imax(0, imin(E, c_end - col)) * (int)sizeof(T) : 0;
    cp_async_z<16>(dst + r * s + u * E, bytes ? src + (size_t)row * ld + col : src, bytes);
  }
}

}  // namespace
