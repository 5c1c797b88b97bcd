// Shared helpers for the hand-written Hopper kernels of dsocr_tpu_torch.
//
// Every kernel reads its operands in their storage type and computes in
// f32; outputs are rounded to their storage type with round-to-nearest-
// even, the same rounding as the JAX reference's `astype`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// ---- cp.async: global → shared copies that run while the block computes ----
// N = 16 bypasses L1 (.cg); 4 and 8 go through it (.ca takes those sizes).
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The largest of 16, 8 and 4 bytes that divides every given size and
// address, or 0 where none does (then copies go byte by byte).
inline int copy_chunk(std::initializer_list<unsigned long long> sizes_and_addrs) {
  for (int c = 16; c >= 4; c /= 2) {
    bool ok = true;
    for (unsigned long long x : sizes_and_addrs) ok = ok && x % c == 0;
    if (ok) return c;
  }
  return 0;
}

// The block copies `bytes` contiguous bytes from src to dst (shared) in
// pieces of `chunk` bytes (see copy_chunk): by cp.async for 16, 8 and 4,
// which the caller commits and waits for; by plain loads and stores for 0.
__device__ __forceinline__ void stage_bytes(void* dst, const void* src, int bytes, int chunk,
                                            int tid, int nthreads) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  switch (chunk) {
    case 16:
      for (int o = tid * 16; o < bytes; o += nthreads * 16) cp_async<16>(d + o, s + o);
      break;
    case 8:
      for (int o = tid * 8; o < bytes; o += nthreads * 8) cp_async<8>(d + o, s + o);
      break;
    case 4:
      for (int o = tid * 4; o < bytes; o += nthreads * 4) cp_async<4>(d + o, s + o);
      break;
    default:
      for (int o = tid; o < bytes; o += nthreads) d[o] = s[o];
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2.approx(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
