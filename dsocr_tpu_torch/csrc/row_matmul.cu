// Dequantize-matmul over packed row-layout weights: the plain projections
// and the lm_head, out[N, M] = bf16(x[N, K]) @ dequant(W[M, K])ᵀ in f32.
//
// Replaces, in dsocr_tpu/ops/pallas/, dequant_matmul.py's q8_matmul and
// q8_matmul_layered and kquant_matmul.py's q4k_matmul, q4k_matmul_layered,
// q6k_matmul and q6k_matmul_layered. Every kernel here is a template over
// the format's decode policy (quant_decode.cuh: Q8, Q4K, Q6K), so one body
// serves all three formats; the numerics are the reference's: each weight
// rounded to bf16 once, x in bf16 (the wrapper rounds f32 x), products
// summed in f32 on the tensor cores. bf16 × bf16 products are exact in
// f32, so only the summation order differs from the plain twins, and no
// kernel uses atomics: two launches give the same bits.
//
// What bounds them on the H100, and what the design does about it:
//
// - Decode (N ≤ 16: 16 slots, one request, the lm_head) is device-memory
//   bytes: qkv's 4.9 MB of Q8_0 codes take 1.5 µs at 3.35 TB/s, the
//   lm_head's 165 MB 49 µs. gemv_kernel keeps bytes in flight on every SM:
//   a warp owns 16 W rows and streams them in steps of 128 K values, each
//   thread loading 32 values of two rows as 16-byte vectors (GV_DEPTH
//   steps in flight) and dequantizing them in registers straight into the
//   A fragments of mma.sync m16n8k16: W never passes through shared memory.
//   K is permuted inside a step (thread t's 32 values sit in the K slots
//   mma assigns to t), and the x rows, staged once per block as bf16 in
//   shared memory, are read with the same permutation, so each B fragment
//   is one 8-byte load. A block's eight warps split its 16·wm W rows (wm
//   warps) and K (8 / wm warps, summed through shared memory in warp
//   order); ops/kernels/row_matmul.py's row_plan takes wm = 1 where the
//   grid would otherwise fall short of two blocks per SM. Codes become
//   floats by a byte permute or an OR into a float's mantissa and one
//   subtraction, never I2F, which runs at a quarter of the FP32 rate.
//   Splitting K across the blocks of a cluster (a reduction through
//   distributed shared memory) measured slower at every decode shape
//   (PERF.md).
//
// - Prefill (N > 16) is tensor-core work: qkv at N 16384 is 161 GFLOP,
//   ≥ 0.163 ms at 989 TFLOP/s, and its f32 output 252 MB (75 µs at 3.35
//   TB/s). Two passes: dequant_kernel writes W once as bf16 [M, K] into a
//   workspace (qkv: 4.9 MB read, 9.8 MB written, a few µs, bit for bit the
//   twin's dequant), then gemm_kernel, one plain bf16 GEMM body for every
//   format: C = A · Bᵀ with A = x [N, K] and B = W [M, K], both K-major,
//   wgmma's native layout. A block owns 128 rows of x × 256 rows of W. One
//   producer thread keeps a 4-stage shared-memory ring full with TMA
//   (64 K values a stage: one 128-byte swizzle row per operand row, the
//   layout wgmma's descriptors read), against mbarriers with expected
//   transaction bytes; two consumer warpgroups each run wgmma m64n128k16
//   twice per 16 K values on 64 rows of x, both operands read from shared
//   memory, f32 accumulators (128 a thread) in registers, and release a
//   stage as soon as the next one's products are issued. setmaxnreg moves
//   registers from the producer warpgroup to the consumers. TMA fills rows
//   past N and M and K columns past K with zeros; the epilogue stores
//   8 bytes at a time straight from the accumulators' layout, masked at the
//   edges.
#include <cuda.h>

#include "quant_decode.cuh"
#include "wgmma.cuh"

namespace dsocr {
namespace row {

// ---------------------------------------------------------------- decode
constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = 32 * GV_WARPS;
constexpr int GV_STEP = 128;      // K values of one warp step: 4 threads × 32
constexpr int GV_DEPTH = 2;       // steps of codes a warp keeps in flight

// d += a · b: mma.sync m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid ceil(M / (16 wm)); NT n8 tiles hold the N ≤ 8 NT rows of x. Warp w
// owns W rows m0 + 16 (w % wm) .. + 15 and the K steps w / wm, + 8 / wm,
// ... Thread (g = lane / 4, t = lane % 4) loads W rows m0 + g and
// m0 + g + 8, K values 32 t .. 32 t + 31 of each step; in the step's j-th
// mma (j = 0..7) its values 4 j .. 4 j + 3 fill the K slots 2t, 2t+1 (A
// registers 0, 1) and 2t+8, 2t+9 (A registers 2, 3), and x row 8 n + g
// supplies the same four K values as B.
template <class P, int NT>
__global__ void __launch_bounds__(GV_THREADS)
    gemv_kernel(const __nv_bfloat16* __restrict__ x, P w, float* __restrict__ out, int N, int K,
                int M, int wm) {
  constexpr int NP = 8 * NT;
  extern __shared__ __align__(16) unsigned char gv_smem[];
  const int ksteps = (K + GV_STEP - 1) / GV_STEP;
  const int KX = ksteps * GV_STEP, LDX = KX + 8;  // x rows 16 bytes apart mod 128: fewer bank conflicts
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(gv_smem);        // [NP][LDX]
  float* red = reinterpret_cast<float*>(gv_smem + (size_t)NP * LDX * 2);  // [warps][16][NP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wk = GV_WARPS / wm, mt = warp % wm, kg = warp / wm;
  const int mb0 = blockIdx.x * wm * 16;  // the block's first W row
  const size_t ma = (size_t)mb0 + mt * 16 + g, mb = ma + 8;
  const bool live_a = ma < (size_t)M, live_b = mb < (size_t)M;

  using Row = typename P::Row;
  auto load = [&](int step, Row& a, Row& b) {
    const int k = step * GV_STEP + 32 * t;
    a = Row{};
    b = Row{};
    if (k < K) {  // K % 32 == 0: a thread's 32 values are live together
      if (live_a) a = w.row(ma, K, k);
      if (live_b) b = w.row(mb, K, k);
    }
  };
  // GV_DEPTH steps of the warp's codes in flight: ring slot d holds step
  // s + d·wk, and takes step s + (d + GV_DEPTH)·wk once it is multiplied
  Row ra[GV_DEPTH], rb[GV_DEPTH];
#pragma unroll
  for (int d = 0; d < GV_DEPTH; ++d) load(kg + d * wk, ra[d], rb[d]);  // in flight while x is staged

  for (int idx = tid; idx < NP * (KX / 8); idx += GV_THREADS) {
    const int r = idx / (KX / 8), c = (idx % (KX / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < N && c < K) v = *reinterpret_cast<const uint4*>(x + (size_t)r * K + c);
    *reinterpret_cast<uint4*>(xs + r * LDX + c) = v;
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int s = kg; s < ksteps; s += GV_DEPTH * wk) {
#pragma unroll
    for (int d = 0; d < GV_DEPTH; ++d) {
      const int sd = s + d * wk;
      if (sd >= ksteps) break;
      const __nv_bfloat16* xk = xs + g * LDX + sd * GV_STEP + 32 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned a[4];
        a[0] = bf16_pair(P::value(ra[d], 4 * j), P::value(ra[d], 4 * j + 1));
        a[1] = bf16_pair(P::value(rb[d], 4 * j), P::value(rb[d], 4 * j + 1));
        a[2] = bf16_pair(P::value(ra[d], 4 * j + 2), P::value(ra[d], 4 * j + 3));
        a[3] = bf16_pair(P::value(rb[d], 4 * j + 2), P::value(rb[d], 4 * j + 3));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 b = *reinterpret_cast<const uint2*>(xk + 8 * n * LDX + 4 * j);
          mma_16816(acc[n], a, b.x, b.y);
        }
      }
      load(sd + GV_DEPTH * wk, ra[d], rb[d]);  // zeros past K
    }
  }

  // C fragments: acc[n] = rows g, g + 8 of the warp's 16 W rows × x rows
  // 8 n + 2 t, + 1; summed over the block's K groups in warp order
  float* rw = red + warp * 16 * NP;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    rw[g * NP + c] = acc[n][0];
    rw[g * NP + c + 1] = acc[n][1];
    rw[(g + 8) * NP + c] = acc[n][2];
    rw[(g + 8) * NP + c + 1] = acc[n][3];
  }
  __syncthreads();
  const int rows = 16 * wm;
  for (int idx = tid; idx < NP * rows; idx += GV_THREADS) {
    const int n = idx / rows, ml = idx % rows, r = ml % 16;
    float sum = 0.f;
    for (int k = 0; k < wk; ++k) sum += red[((k * wm + ml / 16) * 16 + r) * NP + n];
    if (n < N && mb0 + ml < M) out[(size_t)n * M + mb0 + ml] = sum;
  }
}

template <class P, int NT>
cudaError_t launch_gemv(const __nv_bfloat16* x, P w, float* out, int N, int K, int M, int wm,
                        cudaStream_t st) {
  const int kx = (K + GV_STEP - 1) / GV_STEP * GV_STEP;
  const size_t smem = (size_t)8 * NT * (kx + 8) * 2 + (size_t)GV_WARPS * 16 * 8 * NT * 4;
  auto kernel = gemv_kernel<P, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + 16 * wm - 1) / (16 * wm), GV_THREADS, smem, st>>>(x, w, out, N, K, M, wm);
  return cudaGetLastError();
}

// --------------------------------------------------------------- prefill
// One thread decodes 32 values of one W row into the bf16 workspace.
template <class P>
__global__ void __launch_bounds__(256) dequant_kernel(P w, __nv_bfloat16* __restrict__ ws, int K, int M) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int cpr = K / 32;
  if (i >= (size_t)M * cpr) return;
  const size_t m = i / cpr;
  const int k0 = (int)(i % cpr) * 32;
  const typename P::Row r = w.row(m, K, k0);
  uint4* dst = reinterpret_cast<uint4*>(ws + m * K + k0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v;
    v.x = bf16_pair(P::value(r, 8 * q + 0), P::value(r, 8 * q + 1));
    v.y = bf16_pair(P::value(r, 8 * q + 2), P::value(r, 8 * q + 3));
    v.z = bf16_pair(P::value(r, 8 * q + 4), P::value(r, 8 * q + 5));
    v.w = bf16_pair(P::value(r, 8 * q + 6), P::value(r, 8 * q + 7));
    dst[q] = v;
  }
}

constexpr int GM_BR = 128;     // rows of x a block: two consumer warpgroups of 64
constexpr int GM_BK = 64;      // K values a stage: one 128-byte swizzle row
constexpr int GM_NSUB = 2;     // 128-row W sub-tiles a block: 256 rows of W
constexpr int GM_BM = 128 * GM_NSUB;
constexpr int GM_STAGES = 4;
constexpr int GM_THREADS = 384;  // producer warpgroup + two consumers
constexpr int GM_MIN_BLOCKS = 1;   // blocks an SM holds (registers: 232 · 256 + 40 · 128)
constexpr int GM_PRODUCER_REGS = 40, GM_CONSUMER_REGS = 232;
constexpr int GM_A_BYTES = GM_BR * GM_BK * 2;
constexpr int GM_STAGE_BYTES = GM_A_BYTES + GM_BM * GM_BK * 2;

constexpr size_t gemm_smem_bytes() {
  return 1024 + (size_t)GM_STAGES * GM_STAGE_BYTES + 2 * GM_STAGES * sizeof(uint64_t);
}

// Grid (ceil(M / 256), ceil(N / 128)): block (bx, by) writes out rows
// 128 by .. + 127 (x rows) and columns 256 bx .. + 255 (W rows).
__global__ void __launch_bounds__(GM_THREADS, GM_MIN_BLOCKS)
    gemm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                float* __restrict__ out, int N, int K, int M) {
  extern __shared__ unsigned char gm_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + GM_STAGES * GM_STAGE_BYTES);
  uint64_t* empty = full + GM_STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.y * GM_BR, m0 = blockIdx.x * GM_BM;
  const int ktiles = (K + GM_BK - 1) / GM_BK;
  if (tid == 0) {
    for (int s = 0; s < GM_STAGES; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrival, plus the stage's TMA bytes
      mbar_init(&empty[s], 8);    // each consumer warp, once its products are done
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GM_PRODUCER_REGS) : "memory");
    if (tid == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % GM_STAGES;
        mbar_wait(&empty[s], ((kt / GM_STAGES) & 1) ^ 1);  // the first round passes
        mbar_arrive_expect_tx(&full[s], GM_STAGE_BYTES);
        unsigned char* st = base + s * GM_STAGE_BYTES;
        tma_load_2d(st, &tx, &full[s], kt * GM_BK, n0);
        tma_load_2d(st + GM_A_BYTES, &tw, &full[s], kt * GM_BK, m0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(GM_CONSUMER_REGS) : "memory");
  const int c = wg - 1, lane = tid % 32, w4 = (tid % 128) / 32;
  float acc[GM_NSUB][16][4];
#pragma unroll
  for (int j = 0; j < GM_NSUB; ++j)
#pragma unroll
    for (int f = 0; f < 16; ++f) acc[j][f][0] = acc[j][f][1] = acc[j][f][2] = acc[j][f][3] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % GM_STAGES;
    mbar_wait(&full[s], (kt / GM_STAGES) & 1);
    const unsigned char* st = base + s * GM_STAGE_BYTES;
    const unsigned char* a_st = st + c * 64 * 128;  // this warpgroup's 64 rows of x
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {  // 32 bytes into the swizzled rows
      const uint64_t da = wgmma_desc_sw128(a_st + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < GM_NSUB; ++j) {
        wgmma_m64n128k16_ss(acc[j], da,
                            wgmma_desc_sw128(st + GM_A_BYTES + j * 128 * 128 + kk * 32, 16, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // this stage's products run on; the previous stage's are done
#pragma unroll
    for (int j = 0; j < GM_NSUB; ++j) fence_regs(acc[j]);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % GM_STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < GM_NSUB; ++j) fence_regs(acc[j]);

  // acc[j][f]: rows g, g + 8 of the warp's 16, columns 8 f + 2 t, + 1 of
  // sub-tile j
  const int g = lane / 4, t = lane % 4;
  const bool pairs = M % 2 == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = n0 + c * 64 + w4 * 16 + g + 8 * h;
    if (r >= N) continue;
    float* orow = out + (size_t)r * M;
#pragma unroll
    for (int j = 0; j < GM_NSUB; ++j) {
#pragma unroll
      for (int f = 0; f < 16; ++f) {
        const int col = m0 + j * 128 + 8 * f + 2 * t;
        const float v0 = acc[j][f][2 * h], v1 = acc[j][f][2 * h + 1];
        if (pairs && col + 1 < M) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < M) orow[col] = v0;
          if (col + 1 < M) orow[col + 1] = v1;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a [rows, K] bf16 row-major tensor read in boxes of `box_rows` × 64 K
// values, 128-byte swizzled; zeros past the edges
inline bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)GM_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P>
cudaError_t launch_prefill(const __nv_bfloat16* x, P w, __nv_bfloat16* ws, float* out, int N, int K, int M,
                           cudaStream_t st) {
  const size_t chunks = (size_t)M * (K / 32);
  dequant_kernel<P><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(w, ws, K, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw;
  if (!bf16_map(&tx, x, N, K, GM_BR) || !bf16_map(&tw, ws, M, K, GM_BM)) return cudaErrorInvalidValue;
  constexpr size_t smem = gemm_smem_bytes();
  err = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + GM_BM - 1) / GM_BM, (N + GM_BR - 1) / GM_BR);
  gemm_kernel<<<grid, GM_THREADS, smem, st>>>(tx, tw, out, N, K, M);
  return cudaGetLastError();
}

template <class P>
cudaError_t run(const void* x, P w, void* ws, void* out, int N, int K, int M, int wm, cudaStream_t st) {
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  float* op = static_cast<float*>(out);
  if (ws != nullptr) return launch_prefill(xp, w, static_cast<__nv_bfloat16*>(ws), op, N, K, M, st);
  if (wm != 1 && wm != 2 && wm != 4 && wm != 8) return cudaErrorInvalidValue;
  if (N <= 8) return launch_gemv<P, 1>(xp, w, op, N, K, M, wm, st);
  if (N <= 16) return launch_gemv<P, 2>(xp, w, op, N, K, M, wm, st);
  return cudaErrorInvalidValue;
}

}  // namespace row
}  // namespace dsocr

// out [N, M] f32 = x [N, K] bf16 @ dequant(W [M, K])ᵀ for the format `fmt`
// (QFormat): Q8_0 parts (codes, scales, -), Q4_K (codes, scales, mins),
// Q6_K (codes, highs, scales). With a workspace `ws` (bf16 [M, K]) the
// prefill path (dequant pass + wgmma GEMM), else the decode GEMV with wm
// warps of 16 rows a block.
extern "C" int dsocr_row_matmul(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                void* ws, void* out, int N, int K, int M, int wm, void* stream) {
  using namespace dsocr;
  if (N < 1 || M < 1 || K < 32 || (K % (fmt == kQ8 ? 32 : 256)) != 0) return (int)cudaErrorInvalidValue;
  if ((N + row::GM_BR - 1) / row::GM_BR > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kQ8:
      return (int)row::run(x, Q8{static_cast<const int8_t*>(p0), static_cast<const float*>(p1)}, ws, out,
                           N, K, M, wm, st);
    case kQ4K:
      return (int)row::run(x,
                           Q4K{static_cast<const uint8_t*>(p0), static_cast<const float*>(p1),
                               static_cast<const float*>(p2)},
                           ws, out, N, K, M, wm, st);
    case kQ6K:
      return (int)row::run(x,
                           Q6K{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
                               static_cast<const float*>(p2)},
                           ws, out, N, K, M, wm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
