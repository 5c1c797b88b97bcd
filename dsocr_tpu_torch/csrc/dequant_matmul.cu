// Q8_0 dequantize-matmul of the routed experts (in-major layout).
//
// Replaces q8_gather_matmul and q8_gather_matmul_layered (expert_kernel),
// in dsocr_tpu/ops/pallas/dequant_matmul.py. The C entry sends the dense
// sweeps (no expert index: q8_dense_experts_layered and
// q8_dense_experts_perx_layered) to expert_sweep.cu's body. The row layout
// (q8_matmul, q8_matmul_layered) is row_matmul.cu's. See
// ops/kernels/dequant_matmul.py for what bounds them on the H100.
//
// Numerics are the reference's: w = bf16(f32(code) * scale) rounded once
// per element, x rounded to bf16, f32 accumulation on the tensor cores
// (WMMA bf16 16x16x16). bf16 x bf16 products are exact in f32, so only
// the summation order differs from the plain twins.
#include <mma.h>

#include "quant_decode.cuh"

namespace dsocr {
namespace q8 {

using namespace nvcuda;

constexpr int QB = 32;  // values per Q8_0 block (one scale each)
constexpr int THREADS = 128;

__device__ __forceinline__ __nv_bfloat16 bf16_of(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 bf16_of(__nv_bfloat16 v) { return v; }

// ---- in-major layout: grouped out[g] = bf16(x_g) @ dequant(codes[e_g]) ----
// Group g multiplies R rows of x, starting at x + g * xg_stride, by expert
// e_g = idx[g] (gather) or g (dense sweeps) and writes out[g] [R, M].
// Grid (M / 128, groups, R / 16). Each step is one Q8 block: 32 K-rows of
// the 128-column W tile, one scale per column. Thread (warp, lane) owns
// columns 4 lane .. 4 lane + 3 and rows warp + 4 i; it dequantizes its
// prefetched codes into shared memory, then loads the next block's codes
// into registers while the warps run WMMA on this one (each warp owns 32
// output columns). An expert index outside [0, E) writes zeros.
template <typename XT>
__global__ void __launch_bounds__(THREADS)
    expert_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int R, int K, int M, int E, long long xg_stride) {
  constexpr int BR = 16, BN = 128, BK = QB;
  constexpr int LDX = BK + 8, LDW = BN + 8, LDC = BN + 4;
  __shared__ __align__(128) __nv_bfloat16 xs[BR * LDX];
  __shared__ __align__(128) __nv_bfloat16 ws[BK * LDW];
  __shared__ __align__(128) float cs[BR * LDC];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.y, m0 = blockIdx.x * BN, r0 = blockIdx.z * BR;
  const int e = idx ? idx[g] : g;
  float* og = out + (size_t)g * R * M;
  if (e < 0 || e >= E) {
    for (int i = tid; i < BR * BN; i += THREADS) {
      const int r = r0 + i / BN, m = m0 + i % BN;
      if (r < R && m < M) og[(size_t)r * M + m] = 0.f;
    }
    return;
  }
  const int8_t* W = codes + (size_t)e * K * M;
  const float* S = scales + (size_t)e * (K / QB) * M;
  const XT* xg = x + (size_t)g * xg_stride;

  const int c4 = lane * 4, m = m0 + c4;
  const bool live = m < M;  // M % 4 == 0: the four columns are live together
  char4 q[8];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = make_char4(0, 0, 0, 0);
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      q[i] = *reinterpret_cast<const char4*>(W + (size_t)(warp + 4 * i) * M + m);
    s = *reinterpret_cast<const float4*>(S + m);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat16* dst = ws + (warp + 4 * i) * LDW + c4;
      dst[0] = bf16_of((float)q[i].x * s.x);
      dst[1] = bf16_of((float)q[i].y * s.y);
      dst[2] = bf16_of((float)q[i].z * s.z);
      dst[3] = bf16_of((float)q[i].w * s.w);
    }
    for (int i = tid; i < BR * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r * LDX + c] =
          (r0 + r < R) ? bf16_of(xg[(size_t)(r0 + r) * K + k0 + c]) : bf16_of(0.f);
    }
    __syncthreads();
    if (live && k0 + BK < K) {
      const size_t k1 = (size_t)k0 + BK;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        q[i] = *reinterpret_cast<const char4*>(W + (k1 + warp + 4 * i) * M + m);
      s = *reinterpret_cast<const float4*>(S + (k1 / QB) * M + m);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + kk, LDX);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ws + kk * LDW + warp * 32 + f * 16, LDW);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(cs + warp * 32 + f * 16, acc[f], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BR * BN; i += THREADS) {
    const int r = r0 + i / BN, c = i % BN;
    if (r < R && m0 + c < M) og[(size_t)r * M + m0 + c] = cs[(i / BN) * LDC + c];
  }
}

template <typename XT>
cudaError_t launch_expert(const void* x, const void* codes, const void* scales, const void* idx,
                          void* out, int groups, int R, int K, int M, int E, long long xg_stride,
                          cudaStream_t st) {
  const dim3 grid((M + 127) / 128, groups, (R + 15) / 16);
  expert_kernel<XT><<<grid, THREADS, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), R, K, M, E, xg_stride);
  return cudaGetLastError();
}

}  // namespace q8
}  // namespace dsocr

extern "C" int dsocr_expert_sweep(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                  void* out, int E, int R, int K, int M, long long xg_stride, int x_dtype,
                                  void* stream);

// idx null: the dense sweeps (group g multiplies expert g), on
// expert_sweep.cu's body; else the gather tier on expert_kernel
extern "C" int dsocr_q8_expert_matmul(const void* x, const void* codes, const void* scales,
                                      const void* idx, void* out, int groups, int R, int K,
                                      int M, int E, long long xg_stride, int x_dtype,
                                      void* stream) {
  using namespace dsocr;
  if (K % q8::QB != 0 || M % 4 != 0 || groups > 65535 || (R + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (idx == nullptr) {
    if (groups > E) return (int)cudaErrorInvalidValue;
    return dsocr_expert_sweep(kQ8, x, codes, scales, nullptr, out, groups, R, K, M, xg_stride, x_dtype, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)q8::launch_expert<float>(x, codes, scales, idx, out, groups, R, K, M, E,
                                           xg_stride, st);
    case kBF16:
      return (int)q8::launch_expert<__nv_bfloat16>(x, codes, scales, idx, out, groups, R, K, M,
                                                   E, xg_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
