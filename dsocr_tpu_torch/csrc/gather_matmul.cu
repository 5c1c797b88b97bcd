// Expert-gather matmul over a float expert stack:
// out[n, :] = x[n, :] @ w[idx[n], :, :], accumulated in f32.
//
// Replaces gather_matmul (dsocr_tpu/ops/pallas/gather_matmul.py:62). See
// ops/kernels/gather_matmul.py for what bounds it on the H100.
//
// A block owns one row n and a tile of 128 output columns. It loads its
// own idx[n], stages the x row in shared memory (2048 values a pass, so
// any H fits) and streams w[idx[n]]'s [H, 128] slab along the contiguous
// I axis: lane l of each warp owns columns c0 + l + 32 j (j < 4), so a
// warp reads 32 neighbouring elements per load, and warp w takes the
// rows h = w, w + 8, ... of the slab. The eight warps' partial sums meet
// in shared memory and are added in warp order: the summation order is
// fixed, so two launches give the same bits. Columns past I are masked;
// an index outside [0, E) reads nothing and writes a zero row.
#include "common.cuh"

namespace dsocr {
namespace gm {

constexpr int WARPS = 8;
constexpr int COLS = 4;            // columns per lane
constexpr int TILE = 32 * COLS;    // output columns per block
constexpr int XCHUNK = 2048;       // x values staged per pass

template <typename XT, typename WT>
__global__ void __launch_bounds__(WARPS * 32)
    gather_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                  const int32_t* __restrict__ idx, float* __restrict__ out, int H, int I,
                  int E) {
  __shared__ float xs[XCHUNK];
  __shared__ float part[WARPS][TILE];
  const int n = blockIdx.x;
  const int c0 = blockIdx.y * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = idx[n];
  bool live[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) live[j] = c0 + lane + 32 * j < I;
  float acc[COLS] = {0.f, 0.f, 0.f, 0.f};
  if (e >= 0 && e < E) {  // the same for every thread of the block
    const WT* we = w + (size_t)e * H * I + c0 + lane;
    const XT* xn = x + (size_t)n * H;
    for (int h0 = 0; h0 < H; h0 += XCHUNK) {
      const int hn = min(XCHUNK, H - h0);
      __syncthreads();  // the previous pass has read xs
      for (int i = threadIdx.x; i < hn; i += WARPS * 32) xs[i] = to_f32(xn[h0 + i]);
      __syncthreads();
#pragma unroll 4
      for (int h = warp; h < hn; h += WARPS) {
        const float xv = xs[h];
        const WT* row = we + (size_t)(h0 + h) * I;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          if (live[j]) acc[j] = fmaf(xv, to_f32(row[32 * j]), acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) part[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  if (threadIdx.x < TILE && c0 + (int)threadIdx.x < I) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += part[k][threadIdx.x];
    out[(size_t)n * I + c0 + threadIdx.x] = s;
  }
}

template <typename XT, typename WT>
cudaError_t launch(const void* x, const void* w, const void* idx, void* out, int N, int H,
                   int I, int E, cudaStream_t st) {
  const dim3 grid(N, (I + TILE - 1) / TILE);
  gather_kernel<XT, WT><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), H, I, E);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w, const void* idx, void* out,
                       int N, int H, int I, int E, cudaStream_t st) {
  switch (w_dtype) {
    case kF32:
      return launch<XT, float>(x, w, idx, out, N, H, I, E, st);
    case kBF16:
      return launch<XT, __nv_bfloat16>(x, w, idx, out, N, H, I, E, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace gm
}  // namespace dsocr

extern "C" int dsocr_gather_matmul(const void* x, const void* w, const void* idx, void* out,
                                   int N, int H, int I, int E, int x_dtype, int w_dtype,
                                   void* stream) {
  using namespace dsocr;
  if (N <= 0 || I <= 0) return (int)cudaSuccess;
  if (H < 0 || (I + gm::TILE - 1) / gm::TILE > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)gm::dispatch_w<float>(w_dtype, x, w, idx, out, N, H, I, E, st);
    case kBF16:
      return (int)gm::dispatch_w<__nv_bfloat16>(w_dtype, x, w, idx, out, N, H, I, E, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
