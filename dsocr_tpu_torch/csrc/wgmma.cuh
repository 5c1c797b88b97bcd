// Hopper building blocks shared by the tensor-core kernels: the 128-byte
// swizzle, wgmma matrix descriptors and synchronisation, mbarriers and TMA
// tensor loads (sm_90a).
#pragma once

#include "common.cuh"

namespace dsocr {

// element (r, c) of a [64][128] bf16 tile in the 128-byte swizzle wgmma
// reads: two column halves of 64 (8 KB apart), rows of 128 bytes whose
// 16-byte pieces are permuted by r % 8 (8-row groups 1024 bytes apart)
__device__ __forceinline__ int sw128_off(int r, int c) {
  return (c >> 6) * 64 * 64 + r * 64 + ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// ---- wgmma: the warpgroup's 64 × N products, operands read by the tensor
// cores straight from shared memory through matrix descriptors ----
// Descriptor of an operand in the 128-byte swizzle (1024-byte aligned
// atoms of 8 rows): `lbo` is the byte step between atoms along N when B is
// read transposed (unused otherwise), `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem, unsigned lbo, unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;  // base offset 0
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers that an async wgmma writes: reads and writes of them stay on
// this side of the wait that precedes this point
// (accumulators: not read or copied before the wait; A operands: their
// registers not reused before it)
template <int R>
__device__ __forceinline__ void fence_regs(float (&x)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[r][e])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(unsigned (&x)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[r][e])::"memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) become
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 × 128, f32; this warp's 16 rows in 16 C fragments) += a (64 × 16,
// bf16, K-major in shared memory) · b (16 × 128, bf16, K-major in shared
// memory, i.e. 128 rows of B each holding the 16 K values), both through
// descriptors
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

// ---- mbarriers (shared::cta, 8 bytes each) ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// the barriers' initialisation becomes visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---- TMA: one thread copies a 2-D box of a tensor map into shared
// memory; the copy's bytes complete a transaction on `bar`. Coordinates
// are (inner, outer) elements; the box's parts past the tensor's edges
// arrive as zeros. ----
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tensor_map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

}  // namespace dsocr
