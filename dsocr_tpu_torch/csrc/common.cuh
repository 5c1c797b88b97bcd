// Shared helpers for the hand-written Hopper kernels of dsocr_tpu_torch.
//
// Every kernel reads its operands in their storage type and computes in
// f32; outputs are rounded to their storage type with round-to-nearest-
// even, the same rounding as the JAX reference's `astype`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsocr {

// dtype codes shared with the Python wrappers (ops/kernels/_lib.py)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace dsocr
