// Q4_K dequantize-matmul: the plain projections and the lm_head (row
// layout) and the routed experts (in-major layout).
//
// Replace q4k_matmul and q4k_matmul_layered (row_kernel), and
// q4k_gather_matmul, q4k_gather_matmul_layered, q4k_dense_experts_layered
// and q4k_dense_experts_perx_layered (expert_kernel), all in
// dsocr_tpu/ops/pallas/kquant_matmul.py. See ops/kernels/kquant_matmul.py
// for the layouts and for what bounds them on the H100.
//
// Layout: two 4-bit codes per byte, adjacent K values, the even k in the
// low nibble; per 32 K values one f32 scale s = d·sc and one f32 min
// b = dmin·m. Row layout: codes [M, K/2], scales and mins [M, K/32].
// In-major layout: codes [E, K/2, M], scales and mins [E, K/32, M].
//
// Numerics are the reference's: w = bf16(f32(q) * s - b) rounded once per
// element, x rounded to bf16, f32 accumulation on the tensor cores (WMMA
// bf16 16x16x16). q * s is exact in f32 (a 4-bit code times d·sc, an f16
// value times a 6-bit integer: at most 21 significant bits), so the fused
// multiply-add below rounds exactly where the reference's separate product
// and difference do. bf16 x bf16 products are exact in f32, so only the
// summation order differs from the plain twins.
#include <mma.h>

#include "common.cuh"

namespace dsocr {
namespace q4k {

using namespace nvcuda;

constexpr int SUB = 32;  // K values per sub-block (one scale, one min)
constexpr int THREADS = 128;

__device__ __forceinline__ __nv_bfloat16 bf16_of(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 bf16_of(__nv_bfloat16 v) { return v; }

__device__ __forceinline__ float deq(uint32_t code, float s, float b) {
  return fmaf(static_cast<float>(code), s, -b);  // q * s exact: one rounding, as q*s - b
}

// Both values of one code byte as a bf16 pair: the low nibble (even k) in
// the low half, which is the lower address in shared memory.
__device__ __forceinline__ uint32_t deq_pair(uint32_t byte, float s, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(deq(byte & 0xFu, s, b), deq(byte >> 4, s, b));
  return *reinterpret_cast<uint32_t*>(&p);
}

// ---- row layout: out[N, M] = bf16(x[N, K]) @ dequant(W[M, K])^T ----
// A block owns a BM x BN output tile; its four warps form a WM x WN grid
// and each holds FM x FN 16x16 accumulators. Every K step stages 64
// values: bf16(x) rows and the dequantized W rows, both k-contiguous in
// shared memory, so W is read as a col-major B operand. Thread t owns one
// 32-value sub-block of the W tile per step (row t / 2, half t % 2): one
// 16-byte load of codes, one scale, one min. The next step's are loaded
// into registers while the tensor cores run this one. K % 256 == 0, so no
// step is partial; rows and columns past N and M are zero-filled and
// stores are masked.
template <typename XT, int WM, int WN, int FM, int FN>
__global__ void __launch_bounds__(THREADS)
    row_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scales, const float* __restrict__ mins,
               float* __restrict__ out, int N, int K, int M) {
  static_assert(WM * WN * 32 == THREADS, "four warps");
  constexpr int BM = WM * FM * 16, BN = WN * FN * 16, BK = 64;
  static_assert(BN * (BK / SUB) == THREADS, "one sub-block per thread per step");
  constexpr int LDS = BK + 8;  // bf16 per shared row (rows stay 16-byte aligned)
  constexpr int LDC = BN + 4;
  __shared__ __align__(128) __nv_bfloat16 xs[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 ws[BN * LDS];
  __shared__ __align__(128) float cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const int KB = K / SUB;

  const int wr = tid / 2, wc = (tid % 2) * SUB, m = m0 + wr;
  const bool live = m < M;
  const uint8_t* wrow = codes + (size_t)m * (K / 2);
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  float s = 0.f, b = 0.f;
  if (live) {
    q = *reinterpret_cast<const uint4*>(wrow + wc / 2);
    s = scales[(size_t)m * KB + wc / SUB];
    b = mins[(size_t)m * KB + wc / SUB];
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK, n = n0 + r;
      xs[r * LDS + c] = n < N ? bf16_of(x[(size_t)n * K + k0 + c]) : bf16_of(0.f);
    }
    {
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
      __nv_bfloat16* dst = ws + wr * LDS + wc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 4 code bytes = 8 values = one 16-byte store
        uint4 v;
        v.x = deq_pair(words[i] & 0xFFu, s, b);
        v.y = deq_pair((words[i] >> 8) & 0xFFu, s, b);
        v.z = deq_pair((words[i] >> 16) & 0xFFu, s, b);
        v.w = deq_pair(words[i] >> 24, s, b);
        *reinterpret_cast<uint4*>(dst + 8 * i) = v;  // a dead row holds zeros (s = b = 0)
      }
    }
    __syncthreads();
    if (live && k0 + BK < K) {
      const int k1 = k0 + BK + wc;
      q = *reinterpret_cast<const uint4*>(wrow + k1 / 2);
      s = scales[(size_t)m * KB + k1 / SUB];
      b = mins[(size_t)m * KB + k1 / SUB];
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], xs + (wm * FM + i) * 16 * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(bf[j], ws + (wn * FN + j) * 16 * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm * FM + i) * 16 * LDC + (wn * FN + j) * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, n = n0 + r, mm = m0 + c;
    if (n < N && mm < M) out[(size_t)n * M + mm] = cs[r * LDC + c];
  }
}

template <typename XT>
cudaError_t launch_row(const void* x, const void* codes, const void* scales, const void* mins,
                       void* out, int N, int K, int M, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  const float* bp = static_cast<const float*>(mins);
  float* op = static_cast<float*>(out);
  if (N <= 16) {  // decode and the lm_head: 16 x 64 tiles, one fragment per warp
    row_kernel<XT, 1, 4, 1, 1><<<dim3((M + 63) / 64, (N + 15) / 16), THREADS, 0, st>>>(
        xp, cp, sp, bp, op, N, K, M);
  } else {  // prefill: 64 x 64 tiles, 2 x 2 fragments per warp
    row_kernel<XT, 2, 2, 2, 2><<<dim3((M + 63) / 64, (N + 63) / 64), THREADS, 0, st>>>(
        xp, cp, sp, bp, op, N, K, M);
  }
  return cudaGetLastError();
}

// ---- in-major layout: grouped out[g] = bf16(x_g) @ dequant(W[e_g]) ----
// Group g multiplies R rows of x, starting at x + g * xg_stride, by expert
// e_g = idx[g] (gather) or g (dense sweeps) and writes out[g] [R, M].
// Grid (M / 128, groups, R / 16). Each step is one sub-block: 32 K-rows
// (16 code-byte rows) of the 128-column W tile, one scale and one min per
// column. Thread (warp, lane) owns columns 4 lane .. 4 lane + 3 and byte
// rows warp + 4 i (K-rows 2 (warp + 4 i) and the one after); it
// dequantizes its prefetched codes into shared memory, then loads the
// next sub-block's codes, scales and mins into registers while the warps
// run WMMA on this one (each warp owns 32 output columns). An expert
// index outside [0, E) writes zeros.
template <typename XT>
__global__ void __launch_bounds__(THREADS)
    expert_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, const float* __restrict__ mins,
                  const int32_t* __restrict__ idx, float* __restrict__ out, int R, int K, int M,
                  int E, long long xg_stride) {
  constexpr int BR = 16, BN = 128, BK = SUB, BYTE_ROWS = SUB / 2;
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
  const uint8_t* W = codes + (size_t)e * (K / 2) * M;
  const float* S = scales + (size_t)e * (K / SUB) * M;
  const float* B = mins + (size_t)e * (K / SUB) * M;
  const XT* xg = x + (size_t)g * xg_stride;

  const int c4 = lane * 4, m = m0 + c4;
  const bool live = m < M;  // M % 4 == 0: the four columns are live together
  uchar4 q[BYTE_ROWS / 4];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f), b = s;
#pragma unroll
  for (int i = 0; i < BYTE_ROWS / 4; ++i) q[i] = make_uchar4(0, 0, 0, 0);
  if (live) {
#pragma unroll
    for (int i = 0; i < BYTE_ROWS / 4; ++i)
      q[i] = *reinterpret_cast<const uchar4*>(W + (size_t)(warp + 4 * i) * M + m);
    s = *reinterpret_cast<const float4*>(S + m);
    b = *reinterpret_cast<const float4*>(B + m);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BYTE_ROWS / 4; ++i) {
      const int kr = 2 * (warp + 4 * i);  // the byte row's even K-row
      uint2 lo, hi;  // four columns of the even (low nibbles) and the odd K-row
      __nv_bfloat162 p;  // neighbouring columns have their own scale and min
      p = __floats2bfloat162_rn(deq(q[i].x & 0xFu, s.x, b.x), deq(q[i].y & 0xFu, s.y, b.y));
      lo.x = *reinterpret_cast<uint32_t*>(&p);
      p = __floats2bfloat162_rn(deq(q[i].z & 0xFu, s.z, b.z), deq(q[i].w & 0xFu, s.w, b.w));
      lo.y = *reinterpret_cast<uint32_t*>(&p);
      p = __floats2bfloat162_rn(deq(q[i].x >> 4, s.x, b.x), deq(q[i].y >> 4, s.y, b.y));
      hi.x = *reinterpret_cast<uint32_t*>(&p);
      p = __floats2bfloat162_rn(deq(q[i].z >> 4, s.z, b.z), deq(q[i].w >> 4, s.w, b.w));
      hi.y = *reinterpret_cast<uint32_t*>(&p);
      *reinterpret_cast<uint2*>(ws + kr * LDW + c4) = lo;
      *reinterpret_cast<uint2*>(ws + (kr + 1) * LDW + c4) = hi;
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
      for (int i = 0; i < BYTE_ROWS / 4; ++i)
        q[i] = *reinterpret_cast<const uchar4*>(W + (k1 / 2 + warp + 4 * i) * M + m);
      s = *reinterpret_cast<const float4*>(S + (k1 / SUB) * M + m);
      b = *reinterpret_cast<const float4*>(B + (k1 / SUB) * M + m);
    }
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

template <typename XT>
cudaError_t launch_expert(const void* x, const void* codes, const void* scales, const void* mins,
                          const void* idx, void* out, int groups, int R, int K, int M, int E,
                          long long xg_stride, cudaStream_t st) {
  const dim3 grid((M + 127) / 128, groups, (R + 15) / 16);
  expert_kernel<XT><<<grid, THREADS, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(mins),
      static_cast<const int32_t*>(idx), static_cast<float*>(out), R, K, M, E, xg_stride);
  return cudaGetLastError();
}

}  // namespace q4k
}  // namespace dsocr

extern "C" int dsocr_q4k_matmul(const void* x, const void* codes, const void* scales,
                                const void* mins, void* out, int N, int K, int M, int x_dtype,
                                void* stream) {
  using namespace dsocr;
  if (K % 256 != 0 || (N + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)q4k::launch_row<float>(x, codes, scales, mins, out, N, K, M, st);
    case kBF16:
      return (int)q4k::launch_row<__nv_bfloat16>(x, codes, scales, mins, out, N, K, M, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dsocr_q4k_expert_matmul(const void* x, const void* codes, const void* scales,
                                       const void* mins, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  using namespace dsocr;
  if (K % 256 != 0 || M % 4 != 0 || groups > 65535 || (R + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)q4k::launch_expert<float>(x, codes, scales, mins, idx, out, groups, R, K, M, E,
                                            xg_stride, st);
    case kBF16:
      return (int)q4k::launch_expert<__nv_bfloat16>(x, codes, scales, mins, idx, out, groups, R,
                                                    K, M, E, xg_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
