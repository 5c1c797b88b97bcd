// Expert-gather matmul over a float expert stack:
// out[n, :] = x[n, :] @ w[idx[n], :, :] → [N, I] f32, for x [N, H] and
// w [E, H, I], each f32 or bf16, and idx [N] int32.
//
// Replaces gather_matmul (dsocr_tpu/ops/pallas/gather_matmul.py:62,
// pallas_call at :86). See ops/kernels/gather_matmul.py for its bound.
//
// What bounds it on the H100: device-memory bytes. Each selected expert's
// [H, I] slab must be read once; each weight then takes part in one
// product per selection of its expert (at most 16 a read here), far below
// the ~295 operations a byte where the tensor cores would be the limit.
// What the design does about it:
//
// - Blocks group the selections by expert themselves, from idx
//   (plan_rows; no host sort, no sync). Grid (selections × column tiles of
//   BN = 128, ks): block (g, tile) serves expert e = idx[g] if the
//   selections of e below g number a multiple of BR = 16 (g leads a task).
//   Its task is the next 16 selections of e from g on, their x rows
//   gathered into the ring and their output rows scattered back by
//   selection; the other blocks return at once. So a slab's column tile
//   crosses device memory once per 16 selections of its expert, not once
//   per selection.
// - The slab streams through a ring of stages of 16 KB of W (BK = 64 K
//   rows of bf16 or 32 of f32, by 128 columns; 3 stages for a bf16 stack, 2
//   for f32, each measured faster at the full width's shapes), each with
//   the task's x rows at those K rows, filled by 16-byte cp.async copies (8
//   or 4 bytes where a row's bytes or the pointer allow no more, plain
//   loads where not even 4), zero past H, I and the task's rows; one
//   barrier a stage, so the next stage's loads are in flight while this
//   one is used.
// - Where few experts are selected, a cluster of ks blocks splits each
//   task's K stages and adds its blocks' sums in rank order through
//   distributed shared memory: ks KSPLIT_MIN at least, doubled up to
//   KSPLIT_MAX while min(N, E) experts' tiles would still fit one wave of
//   resident blocks (the launch reads no idx, so it cannot count the
//   distinct experts), each block keeping SPLIT_MIN_STAGES stages.
// - bf16 x with bf16 w runs on mma.sync.m16n8k16 with W as A (16 output
//   columns a tile, its fragments by ldmatrix.trans from the stage) and
//   the task's x rows as B (two n8 tiles): bf16 products are exact in f32
//   and the sums are f32. Warp w owns the columns 32 w .. 32 w + 31 (two
//   m16 tiles) over every K row of the stage. Any f32 operand runs on
//   FFMA, products and sums in f32 as the reference's dot_general: neither
//   operand is rounded to bf16, and TF32 would need three products a
//   weight (3xTF32) to keep f32. FFMA keeps up: at most 16 FMAs a weight,
//   4 a byte of f32 slab, against the card's ~10 FMAs per byte of
//   device-memory bandwidth. There warp w takes a quarter of the stage's K
//   rows (a lane 4 columns × the task's 16 rows), which finishes a stage
//   sooner than a warp taking all of them (measured), and the warps' sums
//   are added in warp order through shared memory.
// - Rows of a stage are XOR-swizzled in 16-byte pieces by their row, so
//   ldmatrix's eight rows hit eight distinct groups of banks.
// - Each sum runs over K in a fixed order (a thread's K rows in turn, then
//   the warps', then the cluster's blocks in rank order), so two launches
//   give the same bits; and no sum crosses rows (the mma's columns are
//   independent), so a row's bits depend on H, the dtypes and ks alone, not
//   on which other selections share its expert.
// - An index outside [0, E) reads nothing and writes a zero row.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "expert_sweep.cuh"  // mma_16816, cp_async_zfill

namespace dsocr {
namespace gm {
// internal linkage: the launch's static set-up stays this library's own
// where several builds of it are loaded into one process
namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;         // output columns a block
constexpr int BR = 16;          // selections a task
constexpr int W_STAGE = 16384;  // bytes of W a ring stage
constexpr int STAGES_BF16 = 3, STAGES_F32 = 2;  // ring stages, by the stack's type
constexpr int MIN_BLOCKS = 3;   // blocks an SM holds
constexpr int KSPLIT_MIN = 2, KSPLIT_MAX = 8;
constexpr int SPLIT_MIN_STAGES = 2;
constexpr int RS = BN + 4;  // floats a row of the epilogue's sums

template <typename WT>
__host__ __device__ constexpr int bk() {  // K rows a stage
  return W_STAGE / (BN * (int)sizeof(WT));
}

template <typename WT>
__host__ __device__ constexpr int stages() {
  return sizeof(WT) == 2 ? STAGES_BF16 : STAGES_F32;
}

template <typename XT, typename WT>
__host__ __device__ constexpr int stage_bytes() {
  return W_STAGE + BR * bk<WT>() * (int)sizeof(XT);
}

template <typename XT, typename WT>
constexpr size_t smem_bytes() {  // the ring, and the epilogue's sums laid over it once consumed
  return std::max((size_t)stages<WT>() * stage_bytes<XT, WT>(), sizeof(float) * WARPS * BR * RS);
}

struct Args {
  const void* x;
  const void* w;
  const int32_t* idx;
  float* out;
  int N, H, I, E;
  int ks;          // blocks of a cluster that split K
  int wvec, xvec;  // bytes a copy of W's and x's rows: 16, 8 or 4 by cp.async; 0 element by element
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the place of byte b of row r in a stage plane of RB-byte rows: its
// 16-byte piece flipped by the row (mask + 1 pieces a group)
template <int RB>
__device__ __forceinline__ int swz(int r, int b) {
  constexpr int mask = (RB / 16 < 8 ? RB / 16 : 8) - 1;
  return r * RB + 16 * ((b >> 4) ^ (r & mask)) + (b & 15);
}

// ROWS rows of RB bytes into a stage plane: row r from src(r) (null: zeros),
// its first `live` bytes, zeros after, in V-byte cp.async pieces
template <int ROWS, int RB, int V, class Src>
__device__ __forceinline__ void copy_pieces(unsigned char* dst, Src src, int live, const void* any) {
  constexpr int P = RB / V, TOTAL = ROWS * P;
#pragma unroll 8
  for (int i = threadIdx.x; i < TOTAL; i += THREADS) {
    const int r = i / P, b = V * (i % P);
    const unsigned char* s = src(r);
    const bool ok = s != nullptr && b < live;
    sweep::cp_async_zfill<V>(dst + swz<RB>(r, b), ok ? s + b : any, ok);
  }
}

template <int ROWS, int RB, typename T, class Src>
__device__ __forceinline__ void copy_rows(unsigned char* dst, Src src, int live, int vec, const void* any) {
  switch (vec) {
    case 16:
      copy_pieces<ROWS, RB, 16>(dst, src, live, any);
      break;
    case 8:
      copy_pieces<ROWS, RB, 8>(dst, src, live, any);
      break;
    case 4:
      copy_pieces<ROWS, RB, 4>(dst, src, live, any);
      break;
    default: {  // rows or pointer off a 4-byte boundary: plain loads, done before the stage is read
      using U = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
      constexpr int P = RB / (int)sizeof(T);
      for (int i = threadIdx.x; i < ROWS * P; i += THREADS) {
        const int r = i / P, b = (int)sizeof(T) * (i % P);
        const unsigned char* s = src(r);
        *reinterpret_cast<U*>(dst + swz<RB>(r, b)) =
            s != nullptr && b < live ? *reinterpret_cast<const U*>(s + b) : U(0);
      }
    }
  }
}

// The task's plan, built by each block from idx: block (g, ...) serves
// expert e = idx[g] if the selections g' < g of e number a multiple of BR
// (g leads), else it returns at once. The leader's task is the next BR
// selections g'' >= g of e in ascending order: rows_x holds the element
// offset of each one's x row, rows_o its output row, -1 past them. Returns
// the task's rows, or 0 where g does not lead. idx is read once, in chunks
// of THREADS, one entry a thread: a block-wide count of the selections of
// e below g, and a warp vote and a prefix count over the votes for those
// from g on.
__device__ int plan_rows(const Args& a, int e, int g, long long* rows_x, int* rows_o, unsigned* vote) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < BR) rows_x[tid] = rows_o[tid] = -1;
  int below = 0, listed = 0;  // selections of e below g; from g on, in the chunks done
  for (int j0 = 0; j0 < a.N && (j0 < g || listed < BR); j0 += THREADS) {
    const int j = j0 + tid;
    const bool hit = j < a.N && a.idx[j] == e;
    const unsigned mask = __ballot_sync(0xffffffffu, hit && j >= g);
    if (lane == 0) vote[warp] = mask;
    below += __syncthreads_count(hit && j < g);  // a barrier too: the votes are in
    int pos = listed + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      const int c = __popc(vote[q]);
      if (q < warp) pos += c;
      listed += c;
    }
    if (hit && j >= g && pos < BR) {
      rows_x[pos] = (long long)j * a.H;
      rows_o[pos] = j;
    }
    __syncthreads();  // the votes are read before the next chunk's
  }
  return below % BR ? 0 : min(listed, BR);
}

__device__ __forceinline__ void store_out(const Args& a, int row, int col, float4 v) {
  float* o = a.out + (size_t)row * a.I + col;
  if (a.I % 4 == 0) {
    *reinterpret_cast<float4*>(o) = v;
  } else {
    const float s[4] = {v.x, v.y, v.z, v.w};
    for (int c = 0; c < 4 && col + c < a.I; ++c) o[c] = s[c];
  }
}

__device__ __forceinline__ void add4(float4& v, const float* p) {
  const float4 y = *reinterpret_cast<const float4*>(p);
  v.x += y.x;
  v.y += y.y;
  v.z += y.z;
  v.w += y.w;
}

// four weights at K row r of a stage, the lane's columns 4 lane .. + 3
__device__ __forceinline__ void w4(float (&v)[4], const unsigned char* ws, int r, int lane, float) {
  const float4 q = *reinterpret_cast<const float4*>(ws + swz<BN * 4>(r, 16 * lane));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void w4(float (&v)[4], const unsigned char* ws, int r, int lane, __nv_bfloat16) {
  const uint2 q = *reinterpret_cast<const uint2*>(ws + swz<BN * 2>(r, 8 * lane));
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

// x row n of a stage (XB bytes) at K rows k .. k + 3 (every lane the same: a broadcast)
template <int XB>
__device__ __forceinline__ void x4(float (&v)[4], const unsigned char* xs, int n, int k, float) {
  const float4 q = *reinterpret_cast<const float4*>(xs + swz<XB>(n, 4 * k));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <int XB>
__device__ __forceinline__ void x4(float (&v)[4], const unsigned char* xs, int n, int k, __nv_bfloat16) {
  const uint2 q = *reinterpret_cast<const uint2*>(xs + swz<XB>(n, 2 * k));
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) gather_kernel(const Args a) {
  constexpr bool MMA = sizeof(XT) == 2 && sizeof(WT) == 2;
  constexpr int BK = bk<WT>(), STAGES = stages<WT>();
  constexpr int WB = BN * (int)sizeof(WT);  // bytes of a W row in a stage
  constexpr int XB = BK * (int)sizeof(XT);  // bytes of an x row in a stage
  constexpr int SB = stage_bytes<XT, WT>();
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ long long rows_x[BR];
  __shared__ int rows_o[BR];
  __shared__ unsigned vote[WARPS];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles = (a.I + BN - 1) / BN;
  const int sel = blockIdx.x / tiles, m0 = blockIdx.x % tiles * BN, rank = blockIdx.z;
  const int e = a.idx[sel];
  if (e < 0 || e >= a.E) {  // the selection's row is zeros
    for (int m = m0 + tid; rank == 0 && m < min(m0 + BN, a.I); m += THREADS) a.out[(size_t)sel * a.I + m] = 0.f;
    return;
  }
  const int rows = plan_rows(a, e, sel, rows_x, rows_o, vote);
  if (rows == 0) return;  // another selection of e leads this one's task

  const int ktiles = (a.H + BK - 1) / BK, per = (ktiles + a.ks - 1) / a.ks;
  const int kt_begin = min(ktiles, rank * per), kt_end = min(ktiles, kt_begin + per);
  const size_t wld = (size_t)a.I * sizeof(WT);  // bytes between K rows of the slab
  const unsigned char* wtile =
      static_cast<const unsigned char*>(a.w) + ((size_t)e * a.H * a.I + m0) * sizeof(WT);
  const unsigned char* xb = static_cast<const unsigned char*>(a.x);
  const int wlive = (a.I - m0) * (int)sizeof(WT);

  auto load_stage = [&](int kt, int slot) {
    unsigned char* st = sm + slot * SB;
    const int k0 = kt * BK, krows = min(BK, a.H - k0);
    const unsigned char* w0 = wtile + k0 * wld;
    copy_rows<BK, WB, WT>(st, [&](int r) { return r < krows ? w0 + r * wld : nullptr; }, wlive, a.wvec, a.w);
    copy_rows<BR, XB, XT>(
        st + W_STAGE,
        [&](int n) { return rows_x[n] < 0 ? nullptr : xb + (rows_x[n] + k0) * (long long)sizeof(XT); },
        (a.H - k0) * (int)sizeof(XT), a.xvec, a.x);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt_begin + s < kt_end) load_stage(kt_begin + s, s);
    cp_async_commit();
  }

  // MMA: acc[(2 jj + nt) · 4 + i], C fragment i of the warp's m-tile jj
  // (columns 32 warp + 16 jj ..) and n-tile nt; FFMA: acc[4 n + c], row n
  // of the task at the lane's column 4 lane + c, over the warp's K rows
  float acc[MMA ? 16 : 4 * BR];
#pragma unroll
  for (int i = 0; i < (MMA ? 16 : 4 * BR); ++i) acc[i] = 0.f;

  int slot = 0;
#pragma unroll 1
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt is in for every thread; the slot before it is consumed
    {
      const int next = kt + STAGES - 1;
      if (next < kt_end) load_stage(next, slot == 0 ? STAGES - 1 : slot - 1);
      cp_async_commit();
    }
    const unsigned char* st = sm + slot * SB;
    const unsigned char* xs = st + W_STAGE;
    if constexpr (MMA) {
      const int q = lane >> 3;
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {  // the stage's 16-row K chunks
        // B: x rows 8 nt + (lane & 7) at the chunk's lo and hi 8 K
        uint32_t b[4];
        const int n = 8 * (q >> 1) + (lane & 7);
        ldsm_x4(b, smem_addr(xs + swz<XB>(n, 32 * c + 16 * (q & 1))));
        // A of m-tile 2 warp + jj: its 16 columns at the chunk's 16 K rows, transposed
        const int k = 16 * c + (lane & 7) + 8 * (q >> 1);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t A[4];
          ldsm_x4_trans(A, smem_addr(st + swz<WB>(k, 64 * warp + 32 * jj + 16 * (q & 1))));
          sweep::mma_16816(*reinterpret_cast<float(*)[4]>(acc + 8 * jj), A, b[0], b[1]);
          if (rows > 8) sweep::mma_16816(*reinterpret_cast<float(*)[4]>(acc + 8 * jj + 4), A, b[2], b[3]);
        }
      }
    } else {
      constexpr int KW = BK / WARPS;  // the warp's K rows of the stage
#pragma unroll
      for (int k4 = 0; k4 < KW; k4 += 4) {
        const int k = KW * warp + k4;
        float wv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4(wv[i], st, k + i, lane, WT());
#pragma unroll
        for (int n = 0; n < BR; ++n) {
          if (n < rows) {
            float xv[4];
            x4<XB>(xv, xs, n, k, XT());
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[4 * n + c] = fmaf(xv[i], wv[i][c], acc[4 * n + c]);
          }
        }
      }
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the sums overlay it

  // the lane's sums into red, [planes][BR][RS]: MMA one plane (each warp
  // owns its columns); FFMA a plane a warp (each warp a share of K), added
  // below in warp order
  constexpr int PLANES = MMA ? 1 : WARPS;
  float* red = reinterpret_cast<float*>(sm);
  if constexpr (MMA) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 16; ++i)  // C fragment i % 4: row + (i & 1), column + 8 ((i >> 1) & 1)
      red[(8 * (i / 4 % 2) + 2 * t + (i & 1)) * RS + 32 * warp + 16 * (i / 8) + g + 8 * ((i >> 1) & 1)] = acc[i];
  } else {
    float* rw = red + warp * BR * RS;
#pragma unroll
    for (int n = 0; n < BR; ++n)
      if (n < rows)
        *reinterpret_cast<float4*>(rw + n * RS + 4 * lane) =
            make_float4(acc[4 * n], acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3]);
  }
  __syncthreads();
  const bool split = a.ks > 1;
  for (int i = tid; i < BR * BN / 4; i += THREADS) {
    const int n = i / (BN / 4), m = 4 * (i % (BN / 4));
    if (rows_o[n] < 0 || m0 + m >= a.I) continue;
    float4 v = *reinterpret_cast<const float4*>(red + n * RS + m);
#pragma unroll
    for (int p = 1; p < PLANES; ++p) add4(v, red + (p * BR + n) * RS + m);
    if (!split) {
      store_out(a, rows_o[n], m0 + m, v);
    } else if (PLANES > 1) {
      *reinterpret_cast<float4*>(red + n * RS + m) = v;  // in plane 0, for the cluster
    }
  }
  if (split) {  // the cluster's blocks' sums, in rank order; each block stores every ks-th float4
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int i = tid * a.ks + rank; i < BR * BN / 4; i += THREADS * a.ks) {
      const int n = i / (BN / 4), m = 4 * (i % (BN / 4));
      if (rows_o[n] < 0 || m0 + m >= a.I) continue;
      float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) + n * RS + m);
      for (int q = 1; q < a.ks; ++q) add4(v, cluster.map_shared_rank(red, q) + n * RS + m);
      store_out(a, rows_o[n], m0 + m, v);
    }
    cluster.sync();  // no block leaves while a peer reads its shared memory
  }
}

template <typename XT, typename WT>
cudaError_t launch(Args a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<XT, WT>();
  static int slots = 0;  // blocks the card holds at once
  static const cudaError_t setup = [] {
    auto kernel = gather_kernel<XT, WT>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    slots = sms * per_sm;
    return e == cudaSuccess && slots < 1 ? cudaErrorInvalidConfiguration : e;
  }();
  if (setup != cudaSuccess) return setup;
  const int tiles = (a.I + BN - 1) / BN, ktiles = (a.H + bk<WT>() - 1) / bk<WT>();
  const long long working = (long long)std::min(a.N, a.E) * tiles;
  int ks = 1;
  while (2 * ks <= KSPLIT_MAX && ktiles >= 2 * ks * SPLIT_MIN_STAGES &&
         (2 * ks <= KSPLIT_MIN || working * 2 * ks <= slots))
    ks *= 2;
  a.ks = ks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.N * tiles, 1, ks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = ks;
  cfg.attrs = &cluster;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, gather_kernel<XT, WT>, a);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_w(int w_dtype, const Args& a, cudaStream_t st) {
  switch (w_dtype) {
    case kF32:
      return launch<XT, float>(a, st);
    case kBF16:
      return launch<XT, __nv_bfloat16>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gm
}  // namespace dsocr

extern "C" int dsocr_gather_matmul(const void* x, const void* w, const void* idx, void* out, int N, int H, int I,
                                   int E, int x_dtype, int w_dtype, void* stream) {
  using namespace dsocr;
  if (N <= 0 || I <= 0) return (int)cudaSuccess;
  if (H < 0 || E < 0 || (long long)N * ((I + gm::BN - 1) / gm::BN) > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const unsigned long long xes = x_dtype == kBF16 ? 2 : 4, wes = w_dtype == kBF16 ? 2 : 4;
  gm::Args a = {};
  a.x = x;
  a.w = w;
  a.idx = static_cast<const int32_t*>(idx);
  a.out = static_cast<float*>(out);
  a.N = N;
  a.H = H;
  a.I = I;
  a.E = E;
  a.wvec = copy_chunk({I * wes, (unsigned long long)reinterpret_cast<uintptr_t>(w)});
  a.xvec = copy_chunk({H * xes, (unsigned long long)reinterpret_cast<uintptr_t>(x)});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)gm::dispatch_w<float>(w_dtype, a, st);
    case kBF16:
      return (int)gm::dispatch_w<__nv_bfloat16>(w_dtype, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
