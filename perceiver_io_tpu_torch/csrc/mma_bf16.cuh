// The bf16 tensor-core pieces of mma.sync (csrc/flash_attention_bwd_wide_mma.cu):
// ldmatrix loads of 8 x 8 tiles of 16-bit values from shared memory, plain
// and transposed, and the m16n8k16 bf16 product with an fp32 accumulator.
// The fp32 counterpart (three TF32 products per fp32 product) is
// csrc/tf32x3.cuh.
//
// Fragments of mma.m16n8k16 (thread (g, t) = (lane / 4, lane % 4)):
//   A (16 x 16, row): a0 = row g, columns 2t, 2t + 1; a1 = row g + 8; a2 =
//     row g, columns 2t + 8, 2t + 9; a3 = row g + 8, those columns;
//   B (16 x 8, col): b0 = k 2t, 2t + 1 at n = g; b1 = k 2t + 8, 2t + 9;
//   C (16 x 8, fp32): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8.
// So the C fragments of two neighbouring n-tiles, packed to bf16 pairs, are
// the A fragment of a product summed over their 16 columns as they stand.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices of 16-bit values: lanes 8m .. 8m + 7 give the 16-byte
// row addresses of matrix m; thread (g, t) receives row g, values 2t and
// 2t + 1 of each. A 16-bit pair is one fp32 value too: on an fp32 tile,
// thread (g, t) receives row g, column t of each 8 x 4 matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_u32(p))
               : "memory");
}

// two matrices (lanes 0..15 give the addresses)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(shared_u32(p))
               : "memory");
}

// four matrices, each transposed: thread (g, t) receives rows 2t and 2t + 1
// of column g
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_u32(p))
               : "memory");
}

// c += a . b on the tensor cores, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
