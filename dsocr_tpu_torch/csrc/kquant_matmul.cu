// K-quant (Q4_K, Q6_K) dequantize-matmul of the routed experts (in-major
// layout).
//
// Replaces, in dsocr_tpu/ops/pallas/kquant_matmul.py, q4k_gather_matmul,
// q4k_gather_matmul_layered, q6k_gather_matmul and
// q6k_gather_matmul_layered (expert_kernel). The C entries send the dense
// sweeps (no expert index: q4k_dense_experts_layered,
// q4k_dense_experts_perx_layered and their q6k_ counterparts) to
// expert_sweep.cu's body. The row layout (q4k_matmul, q6k_matmul and their
// _layered forms) is row_matmul.cu's. See ops/kernels/kquant_matmul.py for
// the layouts and for what bounds them on the H100.
//
// The kernel is a template over a decode policy (Q4K, Q6K in
// quant_decode.cuh), which loads one thread's share of a 32-K-row step and
// decodes it; the tiling, staging and tensor-core work are one body for
// both formats. Numerics are the reference's (quant_decode.cuh): the
// weight rounded to bf16 once per element, x rounded to bf16, f32
// accumulation on the tensor cores (WMMA bf16 16x16x16). bf16 x bf16
// products are exact in f32, so only the summation order differs from the
// plain twins.
#include <mma.h>

#include "quant_decode.cuh"

namespace dsocr {
namespace kq {

using namespace nvcuda;

constexpr int THREADS = 128;

__device__ __forceinline__ __nv_bfloat16 bf16_of(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 bf16_of(__nv_bfloat16 v) { return v; }

// ---- in-major layout: grouped out[g] = bf16(x_g) @ dequant(W[e_g]) ----
// Group g multiplies R rows of x, starting at x + g * xg_stride, by expert
// e_g = idx[g] (gather) or g (dense sweeps) and writes out[g] [R, M].
// Grid (M / 128, groups, R / 16). Each step is 32 K-rows of the 128-column
// W tile (Q4_K one scale row, Q6_K two). Thread (warp, lane) owns columns
// 4 lane .. 4 lane + 3 and byte rows warp + 4 i (K-rows 2 (warp + 4 i) and
// the one after); it dequantizes its prefetched step into shared memory,
// then loads the next step's codes (and highs), scales (and mins) into
// registers while the warps run WMMA on this one (each warp owns 32 output
// columns). Codes come in as one 4-byte vector per thread and byte row,
// 128 contiguous bytes per warp. An expert index outside [0, E) writes
// zeros.
template <class P, typename XT>
__global__ void __launch_bounds__(THREADS)
    expert_kernel(const XT* __restrict__ x, P w, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int R, int K, int M, int E, long long xg_stride) {
  constexpr int BR = 16, BN = 128, BK = 32;
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
  const XT* xg = x + (size_t)g * xg_stride;

  const int c4 = lane * 4, m = m0 + c4;
  const bool live = m < M;  // M % 4 == 0: the four columns are live together
  typename P::Cols q = {};
  if (live) q = w.cols(e, K, M, 0, warp, m);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 2 * (warp + 4 * i);  // the byte row's even K-row
      uint2 lo, hi;  // four columns of the even and the odd K-row
      lo.x = bf16_pair(P::value(q, i, 0, 0), P::value(q, i, 1, 0));
      lo.y = bf16_pair(P::value(q, i, 2, 0), P::value(q, i, 3, 0));
      hi.x = bf16_pair(P::value(q, i, 0, 1), P::value(q, i, 1, 1));
      hi.y = bf16_pair(P::value(q, i, 2, 1), P::value(q, i, 3, 1));
      *reinterpret_cast<uint2*>(ws + kr * LDW + c4) = lo;
      *reinterpret_cast<uint2*>(ws + (kr + 1) * LDW + c4) = hi;
    }
#pragma unroll
    for (int it = 0; it < BR * BK / THREADS; ++it) {  // unrolled: the x loads are in flight together
      const int i = tid + it * THREADS, r = i / BK, c = i % BK;
      xs[r * LDX + c] =
          (r0 + r < R) ? bf16_of(xg[(size_t)(r0 + r) * K + k0 + c]) : bf16_of(0.f);
    }
    __syncthreads();
    if (live && k0 + BK < K) q = w.cols(e, K, M, k0 + BK, warp, m);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + kk, LDX);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, ws + kk * LDW + warp * 32 + f * 16, LDW);
        wmma::mma_sync(acc[f], a, bf, acc[f]);
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

template <class P, typename XT>
cudaError_t launch_expert(const void* x, P w, const void* idx, void* out, int groups, int R, int K,
                          int M, int E, long long xg_stride, cudaStream_t st) {
  const dim3 grid((M + 127) / 128, groups, (R + 15) / 16);
  expert_kernel<P, XT><<<grid, THREADS, 0, st>>>(static_cast<const XT*>(x), w,
                                                 static_cast<const int32_t*>(idx),
                                                 static_cast<float*>(out), R, K, M, E, xg_stride);
  return cudaGetLastError();
}

extern "C" int dsocr_expert_sweep(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                  void* out, int E, int R, int K, int M, long long xg_stride, int x_dtype,
                                  void* stream);

inline int sweep_entry(const void* x, const Q4K& w, void* out, int E, int R, int K, int M,
                       long long xg_stride, int x_dtype, void* stream) {
  return dsocr_expert_sweep(kQ4K, x, w.codes, w.scales, w.mins, out, E, R, K, M, xg_stride, x_dtype, stream);
}
inline int sweep_entry(const void* x, const Q6K& w, void* out, int E, int R, int K, int M,
                       long long xg_stride, int x_dtype, void* stream) {
  return dsocr_expert_sweep(kQ6K, x, w.codes, w.highs, w.scales, out, E, R, K, M, xg_stride, x_dtype, stream);
}

template <class P>
int expert_entry(const void* x, P w, const void* idx, void* out, int groups, int R, int K, int M,
                 int E, long long xg_stride, int x_dtype, void* stream) {
  if (K % 256 != 0 || M % 4 != 0 || groups > 65535 || (R + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (idx == nullptr) {  // the dense sweeps (group g multiplies expert g): expert_sweep.cu
    if (groups > E) return (int)cudaErrorInvalidValue;
    return sweep_entry(x, w, out, groups, R, K, M, xg_stride, x_dtype, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)launch_expert<P, float>(x, w, idx, out, groups, R, K, M, E, xg_stride, st);
    case kBF16:
      return (int)launch_expert<P, __nv_bfloat16>(x, w, idx, out, groups, R, K, M, E, xg_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace kq
}  // namespace dsocr

using dsocr::Q4K;
using dsocr::Q6K;

static Q4K q4k_of(const void* codes, const void* scales, const void* mins) {
  return {static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
          static_cast<const float*>(mins)};
}

static Q6K q6k_of(const void* codes, const void* highs, const void* scales) {
  return {static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(highs),
          static_cast<const float*>(scales)};
}

extern "C" int dsocr_q4k_expert_matmul(const void* x, const void* codes, const void* scales,
                                       const void* mins, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  return dsocr::kq::expert_entry(x, q4k_of(codes, scales, mins), idx, out, groups, R, K, M, E,
                                 xg_stride, x_dtype, stream);
}

extern "C" int dsocr_q6k_expert_matmul(const void* x, const void* codes, const void* highs,
                                       const void* scales, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  return dsocr::kq::expert_entry(x, q6k_of(codes, highs, scales), idx, out, groups, R, K, M, E,
                                 xg_stride, x_dtype, stream);
}
