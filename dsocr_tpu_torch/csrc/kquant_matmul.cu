// K-quant (Q4_K, Q6_K) dequantize-matmul: the plain projections and the
// lm_head (row layout) and the routed experts (in-major layout).
//
// Replace, in dsocr_tpu/ops/pallas/kquant_matmul.py, q4k_matmul,
// q4k_matmul_layered, q6k_matmul and q6k_matmul_layered (row_kernel), and
// q4k_gather_matmul, q4k_gather_matmul_layered, q4k_dense_experts_layered,
// q4k_dense_experts_perx_layered and their six q6k_ counterparts
// (expert_kernel). See ops/kernels/kquant_matmul.py for the layouts and
// for what bounds them on the H100.
//
// Both kernels are templates over a decode policy (Q4K, Q6K below), which
// loads one thread's share of a 32-value step and decodes it; the tiling,
// staging and tensor-core work are one body for both formats.
//
// Layouts, adjacent K values per byte, the first in the low bits:
//  Q4_K  codes (4 bits, two per byte); per 32 K values an f32 scale
//        s = d·sc and an f32 min b = dmin·m; w = q·s − b.
//        Row: codes [M, K/2], scales and mins [M, K/32].
//        In-major: codes [E, K/2, M], scales and mins [E, K/32, M].
//  Q6_K  codes (the low 4 bits, two per byte), highs (the 2-bit high parts,
//        four per byte); per 16 K values an f32 scale s = d·sc;
//        w = (q − 32)·s. Row: codes [M, K/2], highs [M, K/4], scales
//        [M, K/16]. In-major: [E, K/2, M], [E, K/4, M], [E, K/16, M].
//
// Numerics are the reference's: w = bf16 of the f32 weight, rounded once
// per element; x rounded to bf16; f32 accumulation on the tensor cores
// (WMMA bf16 16x16x16). Q4_K: q·s is exact in f32 (a 4-bit code times an
// f16 value times a 6-bit integer: at most 21 significant bits), so the
// fused multiply-add rounds exactly where the reference's separate
// product and difference do. Q6_K: (q − 32)·s can need 25 bits, so it is
// formed as the reference forms it: an exact f32 difference, then one
// rounded product. bf16 x bf16 products are exact in f32, so only the
// summation order differs from the plain twins.
#include <mma.h>

#include "common.cuh"

namespace dsocr {
namespace kq {

using namespace nvcuda;

constexpr int THREADS = 128;

__device__ __forceinline__ __nv_bfloat16 bf16_of(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 bf16_of(__nv_bfloat16 v) { return v; }

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {  // lo at the lower address
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t field(uint32_t word, int shift, uint32_t mask) {
  return (word >> shift) & mask;
}

// ---- decode policies ----
// Row: one thread's 32 values k0 .. k0 + 31 of one W row; value(r, v) is
// value v of them in f32. Cols: one thread's four columns m .. m + 3 over
// one 32-K-row step of an expert, the K-rows 2 (warp + 4 i) and the one
// after, i = 0..3; value(c, i, col, odd) is that of the odd-th K-row of
// byte row i in column col. A zero Row or Cols (dead rows and columns)
// decodes to ±0.

struct Q4K {
  static constexpr int SUB = 32;  // K values per scale and min
  const uint8_t* codes;
  const float* scales;
  const float* mins;

  struct Row {
    uint4 q;
    float s, b;
  };
  __device__ __forceinline__ Row row(size_t m, int K, int k0) const {
    return {*reinterpret_cast<const uint4*>(codes + m * (K / 2) + k0 / 2),
            scales[m * (K / SUB) + k0 / SUB], mins[m * (K / SUB) + k0 / SUB]};
  }
  static __device__ __forceinline__ float value(const Row& r, int v) {
    const uint32_t word = v < 8 ? r.q.x : v < 16 ? r.q.y : v < 24 ? r.q.z : r.q.w;
    return fmaf(static_cast<float>(field(word, 4 * (v % 8), 0xFu)), r.s, -r.b);
  }

  struct Cols {
    uint32_t q[4];
    float4 s, b;
  };
  __device__ __forceinline__ Cols cols(int e, int K, int M, int k0, int warp, int m) const {
    Cols c;
    const uint8_t* W = codes + (size_t)e * (K / 2) * M + (size_t)(k0 / 2) * M + m;
#pragma unroll
    for (int i = 0; i < 4; ++i) c.q[i] = *reinterpret_cast<const unsigned*>(W + (size_t)(warp + 4 * i) * M);
    const size_t srow = (size_t)e * (K / SUB) * M + (size_t)(k0 / SUB) * M + m;
    c.s = *reinterpret_cast<const float4*>(scales + srow);
    c.b = *reinterpret_cast<const float4*>(mins + srow);
    return c;
  }
  static __device__ __forceinline__ float value(const Cols& c, int i, int col, int odd) {
    const float s = col == 0 ? c.s.x : col == 1 ? c.s.y : col == 2 ? c.s.z : c.s.w;
    const float b = col == 0 ? c.b.x : col == 1 ? c.b.y : col == 2 ? c.b.z : c.b.w;
    return fmaf(static_cast<float>(field(c.q[i], 8 * col + 4 * odd, 0xFu)), s, -b);
  }
};

struct Q6K {
  static constexpr int SUB = 16;  // K values per scale
  const uint8_t* codes;
  const uint8_t* highs;
  const float* scales;

  static __device__ __forceinline__ float deq(uint32_t lo, uint32_t hi, float s) {
    return (static_cast<float>(lo | (hi << 4)) - 32.f) * s;  // exact difference, one rounding
  }

  struct Row {  // 16 bytes of low nibbles, 8 of highs, two scales
    uint4 q;
    uint2 h;
    float2 s;
  };
  __device__ __forceinline__ Row row(size_t m, int K, int k0) const {
    return {*reinterpret_cast<const uint4*>(codes + m * (K / 2) + k0 / 2),
            *reinterpret_cast<const uint2*>(highs + m * (K / 4) + k0 / 4),
            *reinterpret_cast<const float2*>(scales + m * (K / SUB) + k0 / SUB)};
  }
  static __device__ __forceinline__ float value(const Row& r, int v) {
    const uint32_t word = v < 8 ? r.q.x : v < 16 ? r.q.y : v < 24 ? r.q.z : r.q.w;
    return deq(field(word, 4 * (v % 8), 0xFu), field(v < 16 ? r.h.x : r.h.y, 2 * (v % 16), 0x3u),
               v < 16 ? r.s.x : r.s.y);
  }

  // Byte row warp + 4 i holds K-rows 2 (warp + 4 i) and the one after:
  // their highs sit in highs byte row (warp + 4 i) / 2 at bits 4 (warp % 2)
  // and 4 (warp % 2) + 2, and their scale in the step's scale row i / 2.
  struct Cols {
    uint32_t q[4], h[4];  // h: each byte shifted to the thread's two highs
    float4 s[2];
  };
  __device__ __forceinline__ Cols cols(int e, int K, int M, int k0, int warp, int m) const {
    Cols c;
    const uint8_t* W = codes + (size_t)e * (K / 2) * M + (size_t)(k0 / 2) * M + m;
    const uint8_t* H = highs + (size_t)e * (K / 4) * M + (size_t)(k0 / 4) * M + m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c.q[i] = *reinterpret_cast<const unsigned*>(W + (size_t)(warp + 4 * i) * M);
      c.h[i] = (*reinterpret_cast<const unsigned*>(H + (size_t)((warp + 4 * i) / 2) * M) >> (4 * (warp % 2))) &
               0x0F0F0F0Fu;
    }
    const float* S = scales + (size_t)e * (K / SUB) * M + (size_t)(k0 / SUB) * M + m;
    c.s[0] = *reinterpret_cast<const float4*>(S);
    c.s[1] = *reinterpret_cast<const float4*>(S + M);
    return c;
  }
  static __device__ __forceinline__ float value(const Cols& c, int i, int col, int odd) {
    const float4 s4 = c.s[i / 2];
    const float s = col == 0 ? s4.x : col == 1 ? s4.y : col == 2 ? s4.z : s4.w;
    return deq(field(c.q[i], 8 * col + 4 * odd, 0xFu), field(c.h[i], 8 * col + 2 * odd, 0x3u), s);
  }
};

// ---- row layout: out[N, M] = bf16(x[N, K]) @ dequant(W[M, K])^T ----
// A block owns a BM x BN output tile; its four warps form a WM x WN grid
// and each holds FM x FN 16x16 accumulators. Every K step stages 64
// values: bf16(x) rows and the dequantized W rows, both k-contiguous in
// shared memory, so W is read as a col-major B operand. Thread t owns 32
// values of the W tile per step (row t / 2, half t % 2): Q4_K one 16-byte
// load of codes, one scale and one min; Q6_K 16 bytes of codes, 8 of
// highs and two scales. The next step's are loaded into registers while
// the tensor cores run this one. K % 256 == 0, so no step is partial; rows
// and columns past N and M are zero-filled and stores are masked.
template <class P, typename XT, int WM, int WN, int FM, int FN>
__global__ void __launch_bounds__(THREADS)
    row_kernel(const XT* __restrict__ x, P w, float* __restrict__ out, int N, int K, int M) {
  static_assert(WM * WN * 32 == THREADS, "four warps");
  constexpr int BM = WM * FM * 16, BN = WN * FN * 16, BK = 64, STEP = 32;
  static_assert(BN * (BK / STEP) == THREADS, "32 values per thread per step");
  constexpr int LDS = BK + 8;  // bf16 per shared row (rows stay 16-byte aligned)
  constexpr int LDC = BN + 4;
  __shared__ __align__(128) __nv_bfloat16 xs[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 ws[BN * LDS];
  __shared__ __align__(128) float cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;

  const int wr = tid / 2, wc = (tid % 2) * STEP, m = m0 + wr;
  const bool live = m < M;
  typename P::Row q = {};
  if (live) q = w.row(m, K, wc);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    static_assert(BM * BK % THREADS == 0, "whole x tiles");
#pragma unroll 8
    for (int it = 0; it < BM * BK / THREADS; ++it) {  // unrolled: the x loads are in flight together
      const int idx = tid + it * THREADS, r = idx / BK, c = idx % BK, n = n0 + r;
      xs[r * LDS + c] = n < N ? bf16_of(x[(size_t)n * K + k0 + c]) : bf16_of(0.f);
    }
    {
      __nv_bfloat16* dst = ws + wr * LDS + wc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 8 values = one 16-byte store
        uint4 v;
        v.x = bf16_pair(P::value(q, 8 * i + 0), P::value(q, 8 * i + 1));
        v.y = bf16_pair(P::value(q, 8 * i + 2), P::value(q, 8 * i + 3));
        v.z = bf16_pair(P::value(q, 8 * i + 4), P::value(q, 8 * i + 5));
        v.w = bf16_pair(P::value(q, 8 * i + 6), P::value(q, 8 * i + 7));
        *reinterpret_cast<uint4*>(dst + 8 * i) = v;  // a dead row holds zeros
      }
    }
    __syncthreads();
    if (live && k0 + BK < K) q = w.row(m, K, k0 + BK + wc);
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

template <class P, typename XT>
cudaError_t launch_row(const void* x, P w, void* out, int N, int K, int M, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  float* op = static_cast<float*>(out);
  if (N <= 16) {  // decode and the lm_head: 16 x 64 tiles, one fragment per warp
    row_kernel<P, XT, 1, 4, 1, 1><<<dim3((M + 63) / 64, (N + 15) / 16), THREADS, 0, st>>>(xp, w, op, N, K, M);
  } else {  // prefill: 64 x 64 tiles, 2 x 2 fragments per warp
    row_kernel<P, XT, 2, 2, 2, 2><<<dim3((M + 63) / 64, (N + 63) / 64), THREADS, 0, st>>>(xp, w, op, N, K, M);
  }
  return cudaGetLastError();
}

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

template <class P>
int row_entry(const void* x, P w, void* out, int N, int K, int M, int x_dtype, void* stream) {
  if (K % 256 != 0 || (N + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)launch_row<P, float>(x, w, out, N, K, M, st);
    case kBF16:
      return (int)launch_row<P, __nv_bfloat16>(x, w, out, N, K, M, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class P>
int expert_entry(const void* x, P w, const void* idx, void* out, int groups, int R, int K, int M,
                 int E, long long xg_stride, int x_dtype, void* stream) {
  if (K % 256 != 0 || M % 4 != 0 || groups > 65535 || (R + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
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

using dsocr::kq::Q4K;
using dsocr::kq::Q6K;

static Q4K q4k_of(const void* codes, const void* scales, const void* mins) {
  return {static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
          static_cast<const float*>(mins)};
}

static Q6K q6k_of(const void* codes, const void* highs, const void* scales) {
  return {static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(highs),
          static_cast<const float*>(scales)};
}

extern "C" int dsocr_q4k_matmul(const void* x, const void* codes, const void* scales,
                                const void* mins, void* out, int N, int K, int M, int x_dtype,
                                void* stream) {
  return dsocr::kq::row_entry(x, q4k_of(codes, scales, mins), out, N, K, M, x_dtype, stream);
}

extern "C" int dsocr_q4k_expert_matmul(const void* x, const void* codes, const void* scales,
                                       const void* mins, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  return dsocr::kq::expert_entry(x, q4k_of(codes, scales, mins), idx, out, groups, R, K, M, E,
                                 xg_stride, x_dtype, stream);
}

extern "C" int dsocr_q6k_matmul(const void* x, const void* codes, const void* highs,
                                const void* scales, void* out, int N, int K, int M, int x_dtype,
                                void* stream) {
  return dsocr::kq::row_entry(x, q6k_of(codes, highs, scales), out, N, K, M, x_dtype, stream);
}

extern "C" int dsocr_q6k_expert_matmul(const void* x, const void* codes, const void* highs,
                                       const void* scales, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  return dsocr::kq::expert_entry(x, q6k_of(codes, highs, scales), idx, out, groups, R, K, M, E,
                                 xg_stride, x_dtype, stream);
}
