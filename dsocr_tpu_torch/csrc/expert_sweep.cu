// The routed experts over packed in-major weights, one body for Q8_0, Q4_K
// and Q6_K: the dense sweeps, out[e] = bf16(x_e) @ dequant(W[e]) → [E, N,
// M] f32, and the gather tier, out[g] = bf16(x[g]) @ dequant(W[idx[g]]) →
// [G, M] f32.
//
// Replaces, in dsocr_tpu/ops/pallas/, dequant_matmul.py's q8_gather_matmul
// (:220), q8_gather_matmul_layered (:349), q8_dense_experts_layered (:455)
// and q8_dense_experts_perx_layered (:495), and kquant_matmul.py's
// q4k_gather_matmul (:568), q4k_gather_matmul_layered (:609),
// q6k_gather_matmul (:706), q6k_gather_matmul_layered (:746),
// q4k_dense_experts_layered (:821), q4k_dense_experts_perx_layered (:885),
// q6k_dense_experts_layered (:959) and q6k_dense_experts_perx_layered
// (:1002). The C entries of dequant_matmul.cu and kquant_matmul.cu route
// all twelve here. x_e is x for every expert (dense, xg_stride 0) or x + e
// · xg_stride (perx); the gather tier's x[g] is x + g · xg_stride.
//
// Numerics are the reference's (quant_decode.cuh): each weight is the f32
// dequantized value rounded to bf16 once, x is rounded to bf16, products
// sum in f32 on the tensor cores. bf16 × bf16 products are exact in f32,
// so only the summation order differs from the plain twins; the order is
// fixed (no atomics), so two launches give the same bits. An output
// element's sum runs over K in an order set by K and the launch's ks alone
// (the mma's columns are independent), so a gather row's bits do not
// depend on which other selections share its expert.
//
// What bounds it on the H100: device-memory bytes. At decode the serving
// path sweeps every expert at N 16 rows: one MoE layer's Q8_0 gate+up is
// 146.8 MB of codes and 18.4 MB of scales (0.052 ms at 3.35 TB/s with the
// f32 output), down 73.4 + 9.2 MB (0.027 ms); 4.7 GFLOP is nothing to the
// tensor cores. The gather tier (N · top_k <= E: single-request decode, a
// few serving rows, the tail of a burst) must read each distinct selected
// expert once: 2.58 MB of Q8_0 gate+up an expert, 1.29 MB of down. What the
// design does about it:
//
// - The gather tier's blocks group the selections by expert themselves,
//   from idx (plan_rows): the block of an expert's first selection (its
//   leader) takes up to 16 selections of that expert as one task (the
//   17th selection's block the next 16, and so on), its x rows gathered
//   into the ring's x rows and its outputs scattered back by selection;
//   the other selections' blocks return at once. No host-side sort, no
//   sync. Where few are selected (6 at one request's decode: 84 gate+up
//   blocks on 132 SMs), a cluster of ks blocks splits each task's K
//   stages and adds its blocks' sums in rank order through distributed
//   shared memory (2 blocks at least, 4 while min(selections, E)
//   experts' blocks fit one wave).
// - A dense block is one expert × a slab of BN = 128 · WN columns × 16
//   rows of x over the whole of K (a gather block: its list, 8 or 16 rows
//   at a time, over its share of K). Its codes, scales (mins, highs) and x come
//   through a ring of STAGES stages of BK = 64 K rows (4 for Q8_0, whose
//   stage is the largest, 3 for the K-quants: each measured faster at the
//   serving shapes), filled by 16-byte
//   cp.async copies (4-byte where M is not a multiple of 16; zero-filled
//   past K, M and N), with one barrier a stage, so the loads of the next
//   stages are in flight while the tensor cores run this one. Each block
//   reads its x once, a stage's slice with each stage.
// - W is decoded in registers straight into mma.sync.m16n8k16 A
//   fragments, with W as A (16 output columns a tile) and x as B (one n8
//   tile per 8 rows): no bf16 tile of W in shared memory. A 16-K chunk of
//   a stage goes to one warp (warp c % WK of the block's WK along K); its
//   lane (g, t) owns the 16 columns 16 g .. 16 g + 15 of the warp's 128
//   and the K rows 4 t .. 4 t + 3 of the chunk: 16-byte reads of one code
//   row each (Q8_0: four rows; the K-quants' two K values a byte: two; Q6_K
//   one row of highs). Inside an mma the K order is free as long as A and
//   B agree, so lane t's K rows 4 t + i fill the slots 2t, 2t+1, 2t+8,
//   2t+9 (i = 0..3), and its B fragment is x's 4 values at K 4 t .. 4 t + 3
//   of the chunk, one 8-byte read (f32 x: one 16-byte read, rounded to bf16
//   in registers). Tile j's A rows g and g + 8 are the lane's columns 2j
//   and 2j + 1, so the C fragments give each lane 16 consecutive columns of
//   2 (or 4) rows: the epilogue is float4 stores, after a sum over the WK
//   warps of a column in warp order through shared memory.
// - Codes become floats by a byte permute into a float's mantissa and one
//   subtraction, never I2F: a chunk's codes are first brought to one byte a
//   value (Q8_0's sign bit flipped; the K-quants' nibbles masked apart,
//   Q6_K's two high bits ORed beside them), so each value is a PRMT with
//   an immediate selector, an FADD and an FMUL (Q4_K: FFMA with the min).
// - Shared-memory rows of codes are XOR-swizzled in 16-byte pieces by the
//   reading lane's t, so a quarter-warp's 16-byte reads hit 8 distinct bank
//   groups; x's rows likewise by row.
#include <cooperative_groups.h>

#include <algorithm>
#include <cmath>

#include "expert_sweep.cuh"

namespace dsocr {
namespace sweep {

namespace cg = cooperative_groups;

// blocks an SM holds (the registers they bound: ~160 or 128 a thread); a
// dense launch takes whichever leaves the fuller last wave of blocks, a
// gather launch the higher
constexpr int MIN_BLOCKS_LO = 3, MIN_BLOCKS_HI = 4;
// a gather launch splits each task's K over a cluster of KSPLIT_MIN to
// KSPLIT_MAX blocks, each keeping at least SPLIT_MIN_STAGES ring stages
constexpr int KSPLIT_MIN = 2, KSPLIT_MAX = 4;
constexpr int SPLIT_MIN_STAGES = 2;

template <class P, typename XT, int NT>
__host__ __device__ constexpr int stage_bytes() {
  return plane_bytes<P>(0) + plane_bytes<P>(1) + plane_bytes<P>(2) + 8 * NT * BK * (int)sizeof(XT);
}

// floats of the epilogue's per-warp sums, [WK][8 NT][BN + 4], laid over
// the ring once it is consumed
template <int NT>
__host__ __device__ constexpr int red_floats() {
  return WK > 1 ? WK * 8 * NT * (BN + 4) : 0;
}

template <class P, typename XT, int NT>
constexpr size_t smem_bytes() {
  constexpr size_t ring = (size_t)Fmt<P>::STAGES * stage_bytes<P, XT, NT>();
  constexpr size_t red = sizeof(float) * red_floats<NT>();
  return ring > red ? ring : red;
}

struct Args {
  const void* x;
  float* out;
  const int32_t* idx;  // gather: each selection's expert; null for the dense sweeps
  int groups;          // gather: the selections (grid y)
  int E;               // experts in the stack
  int R, K, M;
  long long xg_stride;  // elements between experts' x (dense; 0: shared) or selections' x (gather)
  int ks;               // gather: blocks of a cluster that split K (1: no split)
  bool vec16;     // byte planes copy 16 bytes a piece (M % 16 == 0), else 4
  bool x_vec16;   // x rows start on 16-byte boundaries
};

// ---- the gather tier's plan, built by each block from idx ----
// Block (slab, g) serves expert e = idx[g] if the selections g' < g of e
// number a multiple of BR (g is a leader), else it returns at once. The
// leader's task is the next BR selections g'' >= g of e in ascending
// order, one x row and one output row each (n-tiles of 8): an expert that
// BR selections or fewer select is read once, by the block of its first
// selection. plan_rows fills rows_x (x's element offset) and rows_o (the
// output row) of the task's rows, -1 past them, and returns how many rows
// it has, or 0 where g does not lead. It reads idx in chunks of THREADS,
// one entry a thread: a block-wide count for the selections below g, then
// a warp vote and a prefix count over the votes for the task's list.
template <int BR>
__device__ int plan_rows(const Args& a, int e, int g, long long* rows_x, int* rows_o, unsigned* vote) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < BR) rows_x[tid] = rows_o[tid] = -1;
  int below = 0;  // selections of e below g
  for (int j0 = 0; j0 < g; j0 += THREADS) {
    const int j = j0 + tid;
    below += __syncthreads_count(j < g && a.idx[j] == e);
  }
  if (below % BR) return 0;
  int listed = 0;  // selections of e from g on, in the chunks done
  for (int j0 = g; j0 < a.groups && listed < BR; j0 += THREADS) {
    const int j = j0 + tid;
    const bool hit = j < a.groups && a.idx[j] == e;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) vote[warp] = mask;
    __syncthreads();
    int pos = listed + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
    for (int q = 0; q < THREADS / 32; ++q) {
      const int c = __popc(vote[q]);
      if (q < warp) pos += c;
      listed += c;
    }
    if (hit && pos < BR) {
      rows_x[pos] = (long long)j * a.xg_stride;
      rows_o[pos] = j;
    }
    __syncthreads();  // the votes are read before the next chunk's
  }
  return min(listed, BR);
}

// Dense (GATHER false): grid (slabs of BN columns, experts, 8 NT-row tiles
// of x), one task a block. Gather: grid (slabs, selections, ks), one task
// a leader (plan_rows), a cluster of ks blocks splitting its K stages,
// each block's sums over its warps added in rank order through distributed
// shared memory. Warp (wn, wk) owns columns 128 wn .. + 127 of the slab and
// the chunks wk, wk + WK, ... of a stage.
template <class P, typename XT, int NT, int MINB, bool GATHER>
__global__ void __launch_bounds__(THREADS, MINB) sweep_kernel(const P w, const Args a) {
  using F = Fmt<P>;
  constexpr int STAGES = F::STAGES;
  constexpr int BR = 8 * NT;  // x rows a task
  constexpr int XB = BK * (int)sizeof(XT);  // bytes of an x row in a stage
  constexpr int SB = stage_bytes<P, XT, NT>();
  constexpr int PB0 = plane_bytes<P>(0), PB1 = plane_bytes<P>(1), PB2 = plane_bytes<P>(2);
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ long long rows_x[GATHER ? BR : 1];
  __shared__ int rows_o[GATHER ? BR : 1];
  __shared__ unsigned vote[GATHER ? THREADS / 32 : 1];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wn = warp % WN, wk = warp / WN, g = lane / 4, t = lane % 4;
  const int K = a.K, M = a.M, R = a.R;
  const int m0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  int e, r0 = 0, kt_begin = 0, kt_end = ktiles, nt_live = NT;
  if constexpr (GATHER) {
    const int sel = blockIdx.y, rank = blockIdx.z;
    e = a.idx[sel];
    if (e < 0 || e >= a.E) {  // an index outside [0, E): the selection's row is zeros
      for (int m = m0 + 4 * tid; rank == 0 && m < min(m0 + BN, M); m += 4 * THREADS) {
        *reinterpret_cast<float4*>(a.out + (size_t)sel * M + m) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
    const int rows = plan_rows<BR>(a, e, sel, rows_x, rows_o, vote);
    if (rows == 0) return;  // another selection of e leads this one's task
    nt_live = (rows + 7) / 8;  // n-tiles holding rows of the task: the mma skips the others
    const int per = (ktiles + a.ks - 1) / a.ks;
    kt_begin = min(ktiles, rank * per);
    kt_end = min(ktiles, kt_begin + per);
  } else {
    e = blockIdx.y;
    r0 = blockIdx.z * BR;
  }

  // the task's planes at K row 0, column m0, and its x rows
  const unsigned char* base[3];
#pragma unroll
  for (int p = 0; p < F::PLANES; ++p) {
    base[p] = static_cast<const unsigned char*>(F::plane(w, p)) +
              ((size_t)e * (K / F::kpr(p)) * M + m0) * F::es(p);
  }
  const XT* xg = static_cast<const XT*>(a.x);
  if constexpr (!GATHER) xg += (size_t)e * a.xg_stride + (size_t)r0 * K;

  // stage kt into ring slot `slot`
  auto load_stage = [&](int kt, int slot) {
    unsigned char* st = sm + slot * SB;
    const int k0 = kt * BK;
#pragma unroll
    for (int p = 0; p < F::PLANES; ++p) {
      const int kpr = F::kpr(p), es = F::es(p), rows = BK / kpr;
      const int live_rows = min(rows, (K - k0) / kpr);
      const int ld = M * es;  // bytes a global row
      const int live_bytes = (M - m0) * es;
      const unsigned char* src = base[p] + (size_t)(k0 / kpr) * ld;
      unsigned char* dst = st + (p == 0 ? 0 : p == 1 ? PB0 : PB0 + PB1);
      if (es == 4 || a.vec16) {
        const int pieces = BN * es / 16;
#pragma unroll
        for (int u = 0; u < (BK / kpr * BN * es / 16 + THREADS - 1) / THREADS; ++u) {
          const int i = tid + u * THREADS;
          if (i < rows * pieces) {
            const int r = i / pieces, cc = i % pieces;
            const bool ok = r < live_rows && 16 * cc < live_bytes;
            cp_async_zfill<16>(dst + r * BN * es + 16 * (es == 1 ? piece(r, kpr, cc) : cc),
                               ok ? src + r * ld + 16 * cc : src, ok);
          }
        }
      } else {  // byte plane, M % 16 != 0: 4-byte pieces
        for (int i = tid; i < rows * (BN / 4); i += THREADS) {
          const int r = i / (BN / 4), cw = i % (BN / 4);
          const bool ok = r < live_rows && 4 * cw < live_bytes;
          cp_async_zfill<4>(dst + r * BN + 16 * piece(r, kpr, cw / 4) + 4 * (cw % 4),
                            ok ? src + r * ld + 4 * cw : src, ok);
        }
      }
    }
    // the task's x rows, K values k0 .. k0 + BK - 1, zero past its rows and K
    unsigned char* xs = st + PB0 + PB1 + PB2;
    constexpr int XP = XB / 16;               // pieces of a row
    constexpr int VP = 16 / (int)sizeof(XT);  // values of a piece
#pragma unroll
    for (int u = 0; u < (BR * XP + THREADS - 1) / THREADS; ++u) {
      const int i = tid + u * THREADS;
      if (i < BR * XP) {
        const int n = i / XP, cc = i % XP;
        bool ok;
        const XT* src;
        if constexpr (GATHER) {  // list row n: a row of a selection's x
          const long long xo = rows_x[n];
          ok = xo >= 0 && k0 + VP * cc < K;
          src = xg + xo + k0 + VP * cc;
        } else {
          ok = r0 + n < R && k0 + VP * cc < K;
          src = xg + n * K + k0 + VP * cc;
        }
        unsigned char* dst = xs + n * XB + 16 * x_piece<XT>(n, cc);
        if (a.x_vec16) {
          cp_async_zfill<16>(dst, ok ? src : xg, ok);
        } else {  // x off a 16-byte boundary: plain loads, done before the stage is read
          XT* d = reinterpret_cast<XT*>(dst);
#pragma unroll
          for (int v = 0; v < VP; ++v) d[v] = ok ? src[v] : from_f32<XT>(0.f);
        }
      }
    }
  };

  // output row n of the task at column m0, or null past its rows
  auto out_row = [&](int n) -> float* {
    if constexpr (GATHER) return rows_o[n] < 0 ? nullptr : a.out + (size_t)rows_o[n] * M + m0;
    return r0 + n < R ? a.out + ((size_t)e * R + r0 + n) * M + m0 : nullptr;
  };

  uint32_t magic;  // 0x4B000000, opaque to the compiler so the byte permutes keep immediate selectors
  asm("mov.b32 %0, 0x4B000000;" : "=r"(magic));
  const int cc_lane = 8 * wn + g;          // the lane's 16-byte piece of a code row
  const int col_lane = 128 * wn + 16 * g;  // its first column in the slab

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt_begin + s < kt_end) load_stage(kt_begin + s, s);
    cp_async_commit();
  }

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;

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
    const int k0 = kt * BK;
    const unsigned char* st = sm + slot * SB;
    const unsigned char* const pl[3] = {st, st + PB0, st + PB0 + PB1};
    const unsigned char* xs = st + PB0 + PB1 + PB2;
#pragma unroll
    for (int ci = 0; ci < CHUNKS / WK; ++ci) {
      const int c = wk + WK * ci;
      if (k0 + 16 * c >= K) break;  // K % 32 == 0: a live chunk is whole
      const typename F::Frag f = F::load(pl, c, t, cc_lane, col_lane);
      uint32_t b[NT][2];
      b_frags<XT, NT>(b, xs, c, g, t);
      tile_products<F, NT, 0>(acc, f, b, magic, nt_live);
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // acc[j][nt]: rows 8 nt + 2t (+1) at the lane's columns 2j (C rows g)
  // and 2j + 1 (C rows g + 8), so columns 16g + 4u .. + 3 of a row are
  // acc[2u][nt][h], acc[2u][nt][2 + h], acc[2u + 1][nt][h], acc[2u + 1][nt][2 + h]
  if constexpr (WK == 1) {  // (a gather launch splits no K for WK 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = out_row(8 * nt + 2 * t + h);
        if (!o) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = col_lane + 4 * u;
          if (m0 + m < M) {
            *reinterpret_cast<float4*>(o + m) = make_float4(acc[2 * u][nt][h], acc[2 * u][nt][2 + h],
                                                            acc[2 * u + 1][nt][h], acc[2 * u + 1][nt][2 + h]);
          }
        }
      }
  } else {
    float* red = reinterpret_cast<float*>(sm);
    const bool split = GATHER && a.ks > 1;
    __syncthreads();  // red overlays the ring, which every warp is done reading
    float* rw = red + (size_t)wk * BR * (BN + 4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 8 * nt + 2 * t + h;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          *reinterpret_cast<float4*>(rw + n * (BN + 4) + col_lane + 4 * u) = make_float4(
              acc[2 * u][nt][h], acc[2 * u][nt][2 + h], acc[2 * u + 1][nt][h], acc[2 * u + 1][nt][2 + h]);
        }
      }
    __syncthreads();
    for (int i = tid; i < BR * BN / 4; i += THREADS) {  // the WK warps' sums, in warp order
      const int n = i / (BN / 4), m = 4 * (i % (BN / 4));
      float* o = out_row(n);
      if (!o) continue;
      float4 v = *reinterpret_cast<const float4*>(red + n * (BN + 4) + m);
#pragma unroll
      for (int q = 1; q < WK; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(red + ((size_t)q * BR + n) * (BN + 4) + m);
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
        v.w += y.w;
      }
      if (split) {
        *reinterpret_cast<float4*>(red + n * (BN + 4) + m) = v;  // in warp 0's place, for the cluster
      } else if (m0 + m < M) {
        *reinterpret_cast<float4*>(o + m) = v;
      }
    }
    if (split) {  // the cluster's blocks' sums, in rank order; each block stores every ks-th float4
      cg::cluster_group cluster = cg::this_cluster();
      const int ks = a.ks, rank = blockIdx.z;
      cluster.sync();
      for (int i = tid * ks + rank; i < BR * BN / 4; i += THREADS * ks) {
        const int n = i / (BN / 4), m = 4 * (i % (BN / 4));
        float* o = out_row(n);
        if (!o || m0 + m >= M) continue;
        float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) + n * (BN + 4) + m);
        for (int q = 1; q < ks; ++q) {
          const float4 y =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + n * (BN + 4) + m);
          v.x += y.x;
          v.y += y.y;
          v.z += y.z;
          v.w += y.w;
        }
        *reinterpret_cast<float4*>(o + m) = v;
      }
      cluster.sync();  // no block leaves while a peer reads its shared memory
    }
  }
}

// Blocks of `kernel` the card holds at once (SMs × blocks an SM), set up
// once per kernel
template <class P, typename XT, int NT, int MINB, bool GATHER>
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;
  static cudaError_t err = [] {
    auto kernel = sweep_kernel<P, XT, NT, MINB, GATHER>;
    constexpr size_t smem = smem_bytes<P, XT, NT>();
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    blocks = sms * per_sm;
    return e == cudaSuccess && blocks < 1 ? cudaErrorInvalidConfiguration : e;
  }();
  *out = blocks;
  return err;
}

// the share of the block slots of its waves that `tasks` blocks fill
inline double wave_fill(double tasks, int resident) {
  const double waves = std::ceil(tasks / resident);
  return tasks / (waves * resident);
}

template <class P, typename XT, int NT>
cudaError_t launch(const P& w, const void* x, void* out, int E, int R, int K, int M, long long xg_stride,
                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes<P, XT, NT>();
  const dim3 grid((M + BN - 1) / BN, E, (R + 8 * NT - 1) / (8 * NT));
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  // Every block is one equal task, so the last wave's empty slots are lost
  // time: take the residency (MIN_BLOCKS_LO or _HI blocks an SM) whose
  // waves the grid fills better, the higher one on a tie.
  int lo = 0, hi = 0;
  cudaError_t err = resident_blocks<P, XT, NT, MIN_BLOCKS_LO, false>(&lo);
  if (err == cudaSuccess) err = resident_blocks<P, XT, NT, MIN_BLOCKS_HI, false>(&hi);
  if (err != cudaSuccess) return err;
  const double tasks = (double)grid.x * grid.y * grid.z;
  auto kernel = wave_fill(tasks, lo) > wave_fill(tasks, hi) ? sweep_kernel<P, XT, NT, MIN_BLOCKS_LO, false>
                                                           : sweep_kernel<P, XT, NT, MIN_BLOCKS_HI, false>;
  Args a = {};
  a.x = x;
  a.out = static_cast<float*>(out);
  a.E = E;
  a.R = R;
  a.K = K;
  a.M = M;
  a.xg_stride = xg_stride;
  a.ks = 1;
  a.vec16 = M % 16 == 0;
  a.x_vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (xg_stride * (long long)sizeof(XT)) % 16 == 0;
  kernel<<<grid, THREADS, smem, st>>>(w, a);
  return cudaGetLastError();
}

// The gather tier: grid (slabs, selections, ks). Only the slabs of each
// distinct selected expert do work, and the launch does not read idx (no
// host sync), so it cannot count them: a router can give 6 experts or 24
// to 24 selections. It takes the residency with the most block slots
// (MIN_BLOCKS_HI) and splits each task's K over a cluster of ks blocks, a
// power of two, each keeping at least SPLIT_MIN_STAGES ring stages: at
// least KSPLIT_MIN, which costs little where many experts are selected
// and fills the card where few are, and up to KSPLIT_MAX while
// min(groups, E) experts' blocks still fit one wave.
template <class P, typename XT, int NT>
cudaError_t launch_gather(const P& w, const void* x, const int32_t* idx, void* out, int groups, int R, int K,
                          int M, int E, long long xg_stride, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<P, XT, NT>();
  const int slabs = (M + BN - 1) / BN, ktiles = (K + BK - 1) / BK;
  if (groups > 65535) return cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t err = resident_blocks<P, XT, NT, MIN_BLOCKS_HI, true>(&slots);
  if (err != cudaSuccess) return err;
  const long long working = (long long)std::min(groups, E) * slabs;
  int ks = 1;
  while (WK > 1 && 2 * ks <= KSPLIT_MAX && ktiles >= 2 * ks * SPLIT_MIN_STAGES &&
         (2 * ks <= KSPLIT_MIN || working * 2 * ks <= slots))
    ks *= 2;
  auto kernel = sweep_kernel<P, XT, NT, MIN_BLOCKS_HI, true>;
  Args a = {};
  a.x = x;
  a.out = static_cast<float*>(out);
  a.idx = idx;
  a.groups = groups;
  a.E = E;
  a.R = R;
  a.K = K;
  a.M = M;
  a.xg_stride = xg_stride;
  a.ks = ks;
  a.vec16 = M % 16 == 0;
  a.x_vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (xg_stride * (long long)sizeof(XT)) % 16 == 0;
  const dim3 grid(slabs, groups, ks);
  if (ks == 1) {
    kernel<<<grid, THREADS, smem, st>>>(w, a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = ks;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, w, a);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// NT n-tiles of 8 rows: a dense task's rows, or in a gather launch the
// most rows one expert can take, up to 16 (more take more tasks)
template <class P, typename XT>
cudaError_t launch_rows(const P& w, const void* x, const int32_t* idx, void* out, int groups, int R, int K, int M,
                        int E, long long xg_stride, cudaStream_t st) {
  if (idx == nullptr) {
    return R <= 8 ? launch<P, XT, 1>(w, x, out, groups, R, K, M, xg_stride, st)
                  : launch<P, XT, 2>(w, x, out, groups, R, K, M, xg_stride, st);
  }
  return groups <= 8 ? launch_gather<P, XT, 1>(w, x, idx, out, groups, R, K, M, E, xg_stride, st)
                     : launch_gather<P, XT, 2>(w, x, idx, out, groups, R, K, M, E, xg_stride, st);
}

template <class P>
int run(const P& w, const void* x, const void* idx, void* out, int groups, int R, int K, int M, int E,
        long long xg_stride, int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  switch (x_dtype) {
    case kF32:
      return (int)launch_rows<P, float>(w, x, ix, out, groups, R, K, M, E, xg_stride, st);
    case kBF16:
      return (int)launch_rows<P, __nv_bfloat16>(w, x, ix, out, groups, R, K, M, E, xg_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sweep
}  // namespace dsocr

// The format `fmt` (QFormat): Q8_0 parts (codes, scales, -), Q4_K (codes,
// scales, mins), Q6_K (codes, highs, scales), in-major [E, ..., M]. With
// idx null, the dense sweeps: out [groups, R, M] f32, out[e] = bf16(x +
// e · xg_stride as [R, K]) @ dequant(W[e]) for e < groups <= E. Else the
// gather tier, one row a selection (R 1): out [groups, M], out[g] =
// bf16(x + g · xg_stride as [K]) @ dequant(W[idx[g]]), zeros where idx[g]
// is outside [0, E). The
// callers (dsocr_q8_expert_matmul, dsocr_q4k_expert_matmul,
// dsocr_q6k_expert_matmul) have checked K, M and the counts.
extern "C" int dsocr_expert_sweep(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                  const void* idx, void* out, int groups, int R, int K, int M, int E,
                                  long long xg_stride, int x_dtype, void* stream) {
  using namespace dsocr;
  if (groups < 1 || E < 1 || R < 1 || M < 4 || M % 4 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  if (idx == nullptr ? groups > E : R != 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1) | reinterpret_cast<uintptr_t>(p2) |
       reinterpret_cast<uintptr_t>(out)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  switch (fmt) {
    case kQ8:
      return sweep::run(Q8{static_cast<const int8_t*>(p0), static_cast<const float*>(p1)}, x, idx, out, groups, R,
                        K, M, E, xg_stride, x_dtype, stream);
    case kQ4K:
      if (K % 256) return (int)cudaErrorInvalidValue;
      return sweep::run(Q4K{static_cast<const uint8_t*>(p0), static_cast<const float*>(p1),
                            static_cast<const float*>(p2)},
                        x, idx, out, groups, R, K, M, E, xg_stride, x_dtype, stream);
    case kQ6K:
      if (K % 256) return (int)cudaErrorInvalidValue;
      return sweep::run(Q6K{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
                            static_cast<const float*>(p2)},
                        x, idx, out, groups, R, K, M, E, xg_stride, x_dtype, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
