// The Q8_0 routed-expert chain in one kernel: for every expert e,
// gate+up → silu(gate)·up → down → weighted by the dense routing map,
// with no [E, N, 2·MI] activation in device memory.
//
// Replaces q8_moe_megafused_layered (dsocr_tpu/ops/pallas/dequant_matmul.py
// :629). See ops/kernels/dequant_matmul.py for what bounds it on the H100.
//
// Design. A cluster of two blocks on neighbouring SMs serves one expert
// (grid 2·E: 128 blocks for 64 experts on 132 SMs). Block r of the cluster
//   1. computes inter[:, r·MI/2 .. (r+1)·MI/2) = bf16(silu(x @ Wg) · (x @ Wu))
//      into its shared memory, gate and up columns streamed side by side;
//   2. reads the peer's half of inter through distributed shared memory,
//      so both hold all of inter [N, MI];
//   3. computes the down columns [r·H/2, (r+1)·H/2) and writes
//      partial[e, n, h] = w[e, n] · (inter @ Wd)[n, h] in f32.
// A second kernel sums partial over e in expert order, so the result is
// the same bits on every launch (an atomicAdd over experts would reorder
// the f32 sum from launch to launch).
//
// Both phases stream int8 code tiles of 64 K-rows (two Q8_0 blocks, one
// scale row each) × 128 columns through a 5-stage cp.async ring (45 KB in
// flight per SM, the memory parallelism one block per SM needs), then per
// tile: dequantize into shared memory as bf16(f32(code) · scale), and
// multiply on the tensor cores (WMMA bf16 16x16x16, f32 accumulate; one
// 16-column fragment per warp, one fragment per 16 rows of x). x is
// rounded to bf16 when it is staged, inter is bf16: the reference's
// roundings.
#include <cooperative_groups.h>
#include <mma.h>

#include "common.cuh"

namespace dsocr {
namespace mf {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int QB = 32;          // values per Q8_0 block (one scale each)
constexpr int KT = 64;          // K rows per tile: two Q8_0 blocks
constexpr int TN = 128;         // tile columns: eight 16-column fragments
constexpr int THREADS = 256;    // eight warps, one fragment each
constexpr int STAGES = 5;       // tiles in flight
constexpr int CLUSTER = 2;      // blocks per expert
constexpr int LDW = TN + 8;     // bf16 per row of the dequantized tile
constexpr int LDC = TN + 4;     // f32 per row of the accumulator staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ __nv_bfloat16 bf16_of(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 bf16_of(__nv_bfloat16 v) { return v; }

// One phase's weight: in-major codes [K, M] and scales [K/32, M] of one
// expert. Tile columns map to matrix columns in N_SEG segments of SEG_W:
// tile column c of chunk j is column start[c / SEG_W] + j·SEG_W + c % SEG_W,
// live while j·SEG_W + c % SEG_W < width. Gate+up uses two segments of 64
// (gate columns, then the matching up columns), down one of 128.
template <int SEG_W, int N_SEG>
struct Phase {
  const int8_t* codes;
  const float* scales;
  int M, K;  // row length, rows (a multiple of 32)
  int width, start0, start1;

  __device__ int chunks() const { return (width + SEG_W - 1) / SEG_W; }
  __device__ int steps() const { return (K + KT - 1) / KT; }  // tiles per chunk
  __device__ int col(int j, int c) const {
    const int seg = c / SEG_W, cc = c % SEG_W;
    if (seg >= N_SEG || j * SEG_W + cc >= width) return -1;
    return (seg ? start1 : start0) + j * SEG_W + cc;
  }
};

struct Smem {
  int8_t* ring_c;        // [STAGES][KT][TN] codes
  float* ring_s;         // [STAGES][KT / QB][TN] scales
  __nv_bfloat16* w_s;    // [KT][LDW] the dequantized tile
  float* c_s;            // [ROWS][LDC]
  __nv_bfloat16* x_s;    // [ROWS][H + 8] bf16(x), zero rows past N
  __nv_bfloat16* i_s;    // [ROWS][MI + 8] inter
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ inline size_t smem_bytes(int rows, int H, int MI) {
  return align128((size_t)STAGES * KT * TN) + align128((size_t)STAGES * (KT / QB) * TN * 4) +
         align128((size_t)KT * LDW * 2) + align128((size_t)rows * LDC * 4) +
         align128((size_t)rows * (H + 8) * 2) + align128((size_t)rows * (MI + 8) * 2);
}

// Tile (chunk j, K step k) into ring slot `slot`: 64 rows × 128 columns of
// codes (two 16-byte copies per thread) and the step's two scale rows;
// dead columns, and rows past K, are not copied.
template <typename Ph>
__device__ __forceinline__ void issue_tile(const Ph& ph, int slot, int j, int k, const Smem& s,
                                           int tid) {
  const int r0 = k * KT, rows = min(KT, ph.K - r0);
  const int c = (tid % 8) * 16;
  const int m = ph.col(j, c);
  if (m >= 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = tid / 8 + half * 32;
      if (row < rows) {
        cp_async16(s.ring_c + ((size_t)slot * KT + row) * TN + c,
                   ph.codes + ((size_t)r0 + row) * ph.M + m);
      }
    }
  }
  if (tid < (KT / QB) * (TN / 4)) {
    const int srow = tid / (TN / 4), sc = (tid % (TN / 4)) * 4;
    const int ms = ph.col(j, sc);
    if (ms >= 0 && srow * QB < rows) {
      cp_async16(s.ring_s + ((size_t)slot * (KT / QB) + srow) * TN + sc,
                 ph.scales + ((size_t)r0 / QB + srow) * ph.M + ms);
    }
  }
}

template <typename Ph>
__device__ __forceinline__ void issue_prologue(const Ph& ph, const Smem& s, int tid) {
  const int KS = ph.steps(), T = ph.chunks() * KS;
  int j = 0, k = 0;
#pragma unroll 1
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < T) issue_tile(ph, t, j, k, s, tid);
    cp_async_commit();
    if (++k == KS) {
      k = 0;
      ++j;
    }
  }
}

// Streams a phase's tiles through the ring (its prologue already issued)
// and multiplies a_s [ROWS][lda] (bf16) by each chunk's columns. At the end
// of chunk j, the accumulators land in c_s and `epilogue(j)` runs on the
// whole block.
template <int NT, typename Ph, typename Epilogue>
__device__ __forceinline__ void stream_phase(const Ph& ph, const __nv_bfloat16* a_s, int lda,
                                             const Smem& s, int tid, Epilogue epilogue) {
  const int warp = tid / 32;
  const int KS = ph.steps(), T = ph.chunks() * KS;
  const int c = (tid % 8) * 16;  // this thread's dequant columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int rt = 0; rt < NT; ++rt) wmma::fill_fragment(acc[rt], 0.f);

  int ij = (STAGES - 1) / KS, ik = (STAGES - 1) % KS;  // the tile issued next
  int j = 0, k = 0;                                    // the tile consumed
  int m_dq = ph.col(0, c), m_mma = ph.col(0, warp * 16);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (t + STAGES - 1 < T) issue_tile(ph, (t + STAGES - 1) % STAGES, ij, ik, s, tid);
    cp_async_commit();
    if (++ik == KS) {
      ik = 0;
      ++ij;
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t is in its slot, for every thread's copies
    const int slot = t % STAGES;
    const int rows = min(KT, ph.K - k * KT);
    if (m_dq >= 0) {  // dequantize: thread (row, row + 32) × 16 columns
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tid / 8 + half * 32;
        if (row >= rows) continue;
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(s.w_s + row * LDW + c);
        const int4 raw =
            *reinterpret_cast<const int4*>(s.ring_c + ((size_t)slot * KT + row) * TN + c);
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
        const float* sc = s.ring_s + ((size_t)slot * (KT / QB) + half) * TN + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dst[i] = __floats2bfloat162_rn((float)q[2 * i] * sc[2 * i],
                                         (float)q[2 * i + 1] * sc[2 * i + 1]);
        }
      }
    }
    __syncthreads();
    if (m_mma >= 0) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        if (kk >= rows) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, s.w_s + kk * LDW + warp * 16, LDW);
#pragma unroll
        for (int rt = 0; rt < NT; ++rt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, a_s + (size_t)rt * 16 * lda + k * KT + kk, lda);
          wmma::mma_sync(acc[rt], afrag, bfrag, acc[rt]);
        }
      }
    }
    if (k == KS - 1) {  // chunk j is complete
#pragma unroll
      for (int rt = 0; rt < NT; ++rt) {
        wmma::store_matrix_sync(s.c_s + rt * 16 * LDC + warp * 16, acc[rt], LDC,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[rt], 0.f);
      }
      __syncthreads();
      epilogue(j);
    }
    if (++k == KS) {
      k = 0;
      ++j;
      m_dq = ph.col(j, c);
      m_mma = ph.col(j, warp * 16);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next phase
}

// Grid 2·E in clusters of two; NT = ceil(N / 16) row tiles (N ≤ 32).
template <typename XT, int NT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    megafused_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                     const int8_t* __restrict__ gu_codes, const float* __restrict__ gu_scales,
                     const int8_t* __restrict__ dn_codes, const float* __restrict__ dn_scales,
                     float* __restrict__ partial, int N, int H, int MI) {
  constexpr int ROWS = NT * 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int ldx = H + 8, ldi = MI + 8;
  const int SL = MI / CLUSTER, HS = H / CLUSTER;  // this block's inter and output columns

  Smem s;
  unsigned char* p = smem_raw;
  s.ring_c = reinterpret_cast<int8_t*>(p);
  p += align128((size_t)STAGES * KT * TN);
  s.ring_s = reinterpret_cast<float*>(p);
  p += align128((size_t)STAGES * (KT / QB) * TN * 4);
  s.w_s = reinterpret_cast<__nv_bfloat16*>(p);
  p += align128((size_t)KT * LDW * 2);
  s.c_s = reinterpret_cast<float*>(p);
  p += align128((size_t)ROWS * LDC * 4);
  s.x_s = reinterpret_cast<__nv_bfloat16*>(p);
  p += align128((size_t)ROWS * ldx * 2);
  s.i_s = reinterpret_cast<__nv_bfloat16*>(p);

  const Phase<64, 2> gu{gu_codes + (size_t)e * H * 2 * MI,
                        gu_scales + (size_t)e * (H / QB) * 2 * MI, 2 * MI, H,
                        SL, rank * SL, MI + rank * SL};
  issue_prologue(gu, s, tid);  // the first tiles fly while x is staged
  for (int i = tid; i < ROWS * H; i += THREADS) {
    const int r = i / H, c = i % H;
    s.x_s[r * ldx + c] = (r < N) ? bf16_of(x[(size_t)r * H + c]) : bf16_of(0.f);
  }
  __syncthreads();

  // 1. inter columns [rank·SL, (rank+1)·SL): chunk j holds gate in tile
  //    columns [0, 64) and the matching up columns in [64, 128)
  stream_phase<NT>(gu, s.x_s, ldx, s, tid, [&](int j) {
    for (int i = tid; i < ROWS * 64; i += THREADS) {
      const int r = i / 64, c = i % 64;
      if (j * 64 + c >= SL) continue;
      const float g = s.c_s[r * LDC + c], u = s.c_s[r * LDC + 64 + c];
      s.i_s[r * ldi + rank * SL + j * 64 + c] = bf16_of(g / (1.f + expf(-g)) * u);
    }
  });

  const Phase<TN, 1> dn{dn_codes + (size_t)e * MI * H, dn_scales + (size_t)e * (MI / QB) * H, H,
                        MI, HS, rank * HS, 0};
  issue_prologue(dn, s, tid);  // overlaps the exchange below

  // 2. every block of the cluster holds its inter slice: copy the peers'
  cluster.sync();
  for (int peer = 0; peer < CLUSTER; ++peer) {
    if (peer == rank) continue;
    const __nv_bfloat16* src = cluster.map_shared_rank(s.i_s, peer);
    const int vec = SL / 8;  // 16-byte vectors per row
    for (int i = tid; i < ROWS * vec; i += THREADS) {
      const int r = i / vec, c = peer * SL + (i % vec) * 8;
      *reinterpret_cast<int4*>(s.i_s + r * ldi + c) =
          *reinterpret_cast<const int4*>(src + r * ldi + c);
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its inter

  // 3. output columns [rank·HS, (rank+1)·HS), weighted by w[e, n]
  stream_phase<NT>(dn, s.i_s, ldi, s, tid, [&](int j) {
    for (int i = tid; i < ROWS * TN; i += THREADS) {
      const int r = i / TN, c = i % TN;
      if (r >= N || j * TN + c >= HS) continue;
      const int h = rank * HS + j * TN + c;
      partial[((size_t)e * N + r) * H + h] = w[(size_t)e * N + r] * s.c_s[r * LDC + c];
    }
  });
}

// out[i] = Σ_e partial[e][i], in expert order.
__global__ void combine_kernel(const float* __restrict__ partial, float* __restrict__ out, int E,
                               int NH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NH) return;
  float acc = 0.f;
  for (int e = 0; e < E; ++e) acc += partial[(size_t)e * NH + i];
  out[i] = acc;
}

template <typename XT, int NT>
cudaError_t launch(const void* x, const void* w, const void* guc, const void* gus,
                   const void* dnc, const void* dns, void* partial, int N, int H, int MI, int E,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(NT * 16, H, MI);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(megafused_kernel<XT, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  megafused_kernel<XT, NT><<<E * CLUSTER, THREADS, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const float*>(w), static_cast<const int8_t*>(guc),
      static_cast<const float*>(gus), static_cast<const int8_t*>(dnc),
      static_cast<const float*>(dns), static_cast<float*>(partial), N, H, MI);
  return cudaGetLastError();
}

}  // namespace mf
}  // namespace dsocr

// x [N, H] (f32 or bf16), w [E, N] f32, gate+up codes [E, H, 2·MI] int8 and
// scales [E, H/32, 2·MI] f32, down codes [E, MI, H] and scales
// [E, MI/32, H]; partial [E, N, H] f32 scratch → out [N, H] f32.
extern "C" int dsocr_q8_moe_megafused(const void* x, const void* w, const void* gu_codes,
                                      const void* gu_scales, const void* dn_codes,
                                      const void* dn_scales, void* partial, void* out, int N,
                                      int H, int MI, int E, int x_dtype, void* stream) {
  using namespace dsocr;
  // H and MI split in two 16-column multiples: each a multiple of 32
  if (N < 1 || N > 32 || E < 1 || H % mf::QB != 0 || MI % mf::QB != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const bool two = N > 16;
  if (x_dtype == kF32) {
    err = two ? mf::launch<float, 2>(x, w, gu_codes, gu_scales, dn_codes, dn_scales, partial, N, H,
                                     MI, E, st)
              : mf::launch<float, 1>(x, w, gu_codes, gu_scales, dn_codes, dn_scales, partial, N, H,
                                     MI, E, st);
  } else if (x_dtype == kBF16) {
    err = two ? mf::launch<__nv_bfloat16, 2>(x, w, gu_codes, gu_scales, dn_codes, dn_scales,
                                             partial, N, H, MI, E, st)
              : mf::launch<__nv_bfloat16, 1>(x, w, gu_codes, gu_scales, dn_codes, dn_scales,
                                             partial, N, H, MI, E, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int NH = N * H;
  mf::combine_kernel<<<(NH + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                       static_cast<float*>(out), E, NH);
  return (int)cudaGetLastError();
}
