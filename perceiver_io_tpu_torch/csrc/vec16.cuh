// 16-byte vectors of the split and tensor-core kernels (K1's `split`,
// csrc/flash_attention_fwd_split.cu; K4's `split` and `tc`,
// csrc/ragged_paged_attention_split.cu and csrc/ragged_paged_attention_tc.cu):
// the values of one 16-byte load as fp32, and a typed store of an fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 4 fp32, 8 bf16 or 16 int8 values of a 16-byte load, as fp32 (a bf16
// is the high half of the fp32 with the same value; an int8 converts
// exactly).
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[16]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[4 * i + b] = static_cast<float>(static_cast<int8_t>(words[i] >> (8 * b)));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace
