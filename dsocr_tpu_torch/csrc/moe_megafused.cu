// The Q8_0 routed-expert chain in one kernel: for every expert e,
// gate+up → silu(gate)·up → down → weighted by the dense routing map,
// with no [E, N, 2·MI] activation in device memory.
//
// Replaces q8_moe_megafused_layered (dsocr_tpu/ops/pallas/dequant_matmul.py
// :629). out[n] = Σ_e w[e, n] · (bf16(silu(x@Wg[e]) · (x@Wu[e]))) @ Wd[e],
// the reference's roundings: bf16(x), each weight bf16(f32(code) · scale),
// f32 sums, inter rounded to bf16, silu as g / (1 + expf(-g)) in f32.
//
// What bounds it on the H100: device-memory bytes. One MoE layer's gate+up
// and down codes and scales are 146.8 + 18.4 + 73.4 + 9.2 ≈ 248 MB, ≥ 0.074
// ms at 3.35 TB/s; at N ≤ 32 rows the tensor cores barely work. So it runs
// on the expert sweep's body (expert_sweep.cuh), whose time is its decode's
// instruction count and the card's fill, not its bytes in flight:
//
// - A cluster of CLUSTER blocks serves one expert (7: the 14 inter chunks
//   of MI 896 split evenly, and 64 clusters of 7 fit the card at once).
//   Block r takes a share of the expert's inter chunks (64 gate columns
//   and the 64 matching up columns each) for phase 1, and for phase 2 an
//   equal share of the expert's down stages (128-column output slabs × K
//   stages of 64), so a slab may be split between two blocks, each
//   writing its own partial piece. Each block walks its items as one
//   sequence of ring stages of BK = 64 K rows: codes, scales and (phase
//   1) x's slice of the stage through the sweep's cp.async ring, one
//   barrier a stage, x never held whole. The ring runs ahead across the
//   phase boundary, so the first down stages are in flight while the
//   cluster waits for its inter.
// - W is decoded in registers straight into mma.sync.m16n8k16 A fragments
//   (Fmt<Q8>, W as A, x as B); no bf16 tile of W in shared memory. In
//   phase 1 a lane's 16 columns are 8 gate columns and the 8 matching up
//   columns (GateUp::load reads 8 bytes of each half of the stage's code
//   row), so its C fragments hold gate and up of the same inter column:
//   bf16(silu(g)·u) is formed in registers and written to the block's
//   inter chunk in shared memory, in the layout of a stage's x rows.
// - The exchange: phase 2's stage kt multiplies inter chunk kt (K rows
//   64 kt .. 64 kt + 63 of down), which one block of the cluster owns; the
//   stage's B rows are copied from the owner's shared memory through
//   distributed shared memory when the stage is issued. One cluster
//   barrier separates the phases (split arrive / wait around the issue of
//   the next stage), one more keeps every block until its peers are done
//   reading its inter.
// - At the end of an item the block's four K-split warps add their sums in
//   a fixed order, (w0 + w2) + (w1 + w3), through the two ring slots the
//   item leaves free (the next stage's issue waits for it), and warp 0
//   writes the item's output: inter, or partial[e, n, h] = w[e, n] ·
//   (inter @ Wd)[n, h] in f32.
// - A second kernel adds each expert's pieces and sums the experts in
//   expert order. Two launches on the same inputs give the same bits (an
//   atomicAdd over experts would reorder the f32 sum from launch to
//   launch), and the combine's read (5.2 MB at full width, more where
//   slabs are split) costs a few µs against the chain's ~250 MB; a last
//   cluster adding in expert order would need a counter per output tile
//   and the same read.
#include <cooperative_groups.h>

#include "expert_sweep.cuh"

namespace dsocr {
namespace mf {

namespace cg = cooperative_groups;
using namespace sweep;

// blocks that serve one expert, and blocks an SM holds at N ≤ 16 (32 rows:
// half as many, for the accumulators' registers)
static constexpr int CLUSTER = 7;
static constexpr int MIN_BLOCKS = 4;
constexpr int STAGES = Fmt<Q8>::STAGES;
constexpr int GW = BN / 2;  // gate columns of a phase-1 item, beside as many up columns
constexpr int PB0 = plane_bytes<Q8>(0), PB1 = plane_bytes<Q8>(1);
static_assert(GW == BK, "phase 2's stage kt is inter chunk kt");
static_assert(STAGES >= 3, "an item's end borrows two free ring slots");
static_assert(WN == 1 && WK == 4, "the end-of-item sum is written for four K-split warps");

template <typename XT, int NT>
__host__ __device__ constexpr int stage_bytes() {  // codes, scales, x rows (phase 2: inter rows)
  return PB0 + PB1 + 8 * NT * BK * (int)sizeof(XT);
}
template <int NT>
__host__ __device__ constexpr int red_floats() {  // one warp's sums [8 NT][BN + 4]
  return 8 * NT * (BN + 4);
}
template <typename XT, int NT>
__host__ __device__ constexpr bool red_in_ring() {
  return red_floats<NT>() * 4 <= stage_bytes<XT, NT>();
}
template <int NT>
__host__ __device__ constexpr int chunk_bytes() {  // one inter chunk: 8 NT rows of 64 bf16
  return 8 * NT * BK * 2;
}

// Phase 1's lane columns: 8 gate columns 8g .. 8g + 7 of the item and the
// matching up columns, from a stage whose code row holds the item's 64
// gate columns in pieces 0..3 and its 64 up columns in pieces 4..7 (each
// piece at its swizzled place), and whose scale row holds the gate scales
// then the up scales. Frag u[i][0..1] and s[0..1] are gate, [2..3] up, so
// lane column j < 8 is gate column 8g + j and j ≥ 8 up column 8g + j − 8.
// A half-warp's 8-byte reads (g 0..3 or 4..7, t 0..3) cover a row's 128
// bytes once: conflict-free.
struct GateUp {
  using Frag = Fmt<Q8>::Frag;
  static __device__ __forceinline__ Frag load(const unsigned char* codes, const float* scales, int c, int t,
                                              int g) {
    Frag f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * c + 4 * t + i;
      const unsigned char* row = codes + r * BN + 8 * (g & 1);
      const uint2 gate = *reinterpret_cast<const uint2*>(row + 16 * piece(r, 1, g >> 1));
      const uint2 up = *reinterpret_cast<const uint2*>(row + 16 * piece(r, 1, 4 + (g >> 1)));
      f.u[i][0] = gate.x ^ 0x80808080u;
      f.u[i][1] = gate.y ^ 0x80808080u;
      f.u[i][2] = up.x ^ 0x80808080u;
      f.u[i][3] = up.y ^ 0x80808080u;
    }
    const float* s = scales + (c / 2) * BN + 8 * g;
    f.s[0] = *reinterpret_cast<const float4*>(s);
    f.s[1] = *reinterpret_cast<const float4*>(s + 4);
    f.s[2] = *reinterpret_cast<const float4*>(s + GW);
    f.s[3] = *reinterpret_cast<const float4*>(s + GW + 4);
    return f;
  }
  template <int I, int J>
  static __device__ __forceinline__ float value(const Frag& f, uint32_t magic) {
    return Fmt<Q8>::value<I, J>(f, magic);
  }
};

struct Args {
  const void* x;     // [N, H]
  const float* w;    // [E, N]
  const int8_t* guc;  // [E, H, 2 MI]
  const float* gus;   // [E, H/32, 2 MI]
  const int8_t* dnc;  // [E, MI, H]
  const float* dns;   // [E, MI/32, H]
  float* partial;     // [E, N, H]
  int N, H, MI;
  bool x_vec16;  // x starts on a 16-byte boundary
};

// the first of n items that rank r of the cluster takes
__host__ __device__ __forceinline__ int share(int n, int r) { return (int)((long long)n * r / CLUSTER); }

// Phase 2's stage units of rank r, [u0, u1) of ns · nq (slab u / nq, K
// stage u % nq): an equal share of them where there are at least as many
// slabs as blocks (so a slab spans one block or two), else slab r whole.
__host__ __device__ __forceinline__ void phase2_units(int H, int nq, int r, int& u0, int& u1) {
  const int ns = (H + BN - 1) / BN;
  if (ns >= CLUSTER) {
    u0 = share(ns * nq, r);
    u1 = share(ns * nq, r + 1);
  } else {
    u0 = r < ns ? r * nq : 0;
    u1 = r < ns ? u0 + nq : 0;
  }
}

// whether slab s spans two blocks: its second block's sums are partial
// piece 1
__device__ __forceinline__ bool slab_split(int H, int nq, int s) {
  for (int r = 1; r < CLUSTER; ++r) {
    int u0, u1;
    phase2_units(H, nq, r, u0, u1);
    if (u0 < u1 && s * nq < u0 && u0 < (s + 1) * nq) return true;
  }
  return false;
}

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

// p (this block's shared memory) in the shared memory of cluster block
// `rank`, and a 16-byte load from there; volatile, so the load stays where
// it is issued, ahead of the stage's tensor-core work, and its latency
// hides behind it
__device__ __forceinline__ uint32_t peer_smem(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return addr;
}
__device__ __forceinline__ uint4 ld_peer(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// a lane's sums [8 j][NT][4] as rows of [BN + 4] floats (its 16 columns of
// the rows 8 nt + 2t + h), and back
template <int NT>
__device__ __forceinline__ void store_sums(float* red, const float (&acc)[8][NT][4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(red + (8 * nt + 2 * t + h) * (BN + 4) + 16 * g + 4 * u) =
            make_float4(acc[2 * u][nt][h], acc[2 * u][nt][2 + h], acc[2 * u + 1][nt][h], acc[2 * u + 1][nt][2 + h]);
}
template <int NT>
__device__ __forceinline__ void add_sums(float (&acc)[8][NT][4], const float* red, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(red + (8 * nt + 2 * t + h) * (BN + 4) + 16 * g + 4 * u);
        acc[2 * u][nt][h] += v.x;
        acc[2 * u][nt][2 + h] += v.y;
        acc[2 * u + 1][nt][h] += v.z;
        acc[2 * u + 1][nt][2 + h] += v.w;
      }
}

// Grid E · CLUSTER in clusters of CLUSTER (set at launch); NT n-tiles of 8
// rows (N ≤ 8 NT).
template <typename XT, int NT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) megafused_kernel(const Args a) {
  constexpr int ROWS = 8 * NT;
  constexpr int XB = BK * (int)sizeof(XT);  // bytes of an x row in a stage
  constexpr int IB = BK * 2;                // bytes of an inter row (bf16) in a stage or chunk
  constexpr int SB = stage_bytes<XT, NT>();
  constexpr int RED = red_floats<NT>();
  constexpr int CB = chunk_bytes<NT>();
  extern __shared__ __align__(16) unsigned char sm[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid % 32, wk = tid / 32, g = lane / 4, t = lane % 4;
  const int N = a.N, H = a.H, MI = a.MI;
  const int nq = (MI + GW - 1) / GW;  // inter chunks: phase-1 items, and phase 2's stages an item
  const int kt1 = (H + BK - 1) / BK;  // stages of a phase-1 item
  const int q0 = share(nq, rank), q1 = share(nq, rank + 1);
  int u0, u1;  // phase-2 stage units [u0, u1): slab u / nq, K stage u % nq
  phase2_units(H, nq, rank, u0, u1);
  const int T1 = (q1 - q0) * kt1, T = T1 + (u1 - u0);
  const int nt_live = min(NT, (N + 7) / 8);
  unsigned char* const inter = sm + STAGES * SB + (red_in_ring<XT, NT>() ? 0 : 2 * RED * 4);

  const int8_t* const guc = a.guc + (size_t)e * H * 2 * MI;
  const float* const gus = a.gus + (size_t)e * (H / 32) * 2 * MI;
  const int8_t* const dnc = a.dnc + (size_t)e * MI * H;
  const float* const dns = a.dns + (size_t)e * (MI / 32) * H;
  const XT* const x = static_cast<const XT*>(a.x);

  // stage st's codes, scales and (phase 1) x rows into ring slot `slot`,
  // zeros past K, the columns and N
  auto issue = [&](int st, int slot) {
    if (st >= T) return;
    unsigned char* s = sm + slot * SB;
#pragma unroll
    for (int u = 0; u < BK * 8 / THREADS; ++u) {  // 64 code rows of eight 16-byte pieces
      const int i = tid + u * THREADS, r = i / 8, cc = i % 8;
      const int8_t* src;
      bool ok;
      if (st < T1) {  // pieces 0..3 gate columns, 4..7 the matching up columns
        const int k = (st % kt1) * BK + r, col = GW * (q0 + st / kt1) + 16 * (cc & 3);
        ok = k < H && col < MI;
        src = guc + (size_t)k * 2 * MI + (cc >= 4 ? MI : 0) + col;
      } else {
        const int u = u0 + st - T1, k = (u % nq) * BK + r, col = BN * (u / nq) + 16 * cc;
        ok = k < MI && col < H;
        src = dnc + (size_t)k * H + col;
      }
      cp_async_zfill<16>(s + r * BN + 16 * piece(r, 1, cc), ok ? src : guc, ok);
    }
    if (tid < 2 * (BN / 4)) {  // two scale rows of 32 four-float pieces
      const int sr = tid / (BN / 4), p = tid % (BN / 4);
      const float* src;
      bool ok;
      if (st < T1) {  // pieces 0..15 gate, 16..31 up
        const int k = (st % kt1) * BK + 32 * sr, col = GW * (q0 + st / kt1) + 4 * (p % 16);
        ok = k < H && col < MI;
        src = gus + (size_t)(k / 32) * 2 * MI + (p >= 16 ? MI : 0) + col;
      } else {
        const int u = u0 + st - T1, k = (u % nq) * BK + 32 * sr, col = BN * (u / nq) + 4 * p;
        ok = k < MI && col < H;
        src = dns + (size_t)(k / 32) * H + col;
      }
      cp_async_zfill<16>(s + PB0 + sr * BN * 4 + 16 * p, ok ? src : gus, ok);
    }
    if (st < T1) {  // x rows 0 .. ROWS - 1, K values k0 .. k0 + 63
      const int k0 = (st % kt1) * BK;
      unsigned char* xs = s + PB0 + PB1;
      constexpr int XP = XB / 16, VP = 16 / (int)sizeof(XT);
#pragma unroll
      for (int u = 0; u < (ROWS * XP + THREADS - 1) / THREADS; ++u) {
        const int i = tid + u * THREADS;
        if (i < ROWS * XP) {
          const int n = i / XP, cc = i % XP;
          const bool ok = n < N && k0 + VP * cc < H;
          const XT* src = x + (size_t)n * H + k0 + VP * cc;
          unsigned char* dst = xs + n * XB + 16 * x_piece<XT>(n, cc);
          if (a.x_vec16) {
            cp_async_zfill<16>(dst, ok ? src : x, ok);
          } else {  // x off a 16-byte boundary: plain loads, done before the stage is read
            XT* d = reinterpret_cast<XT*>(dst);
#pragma unroll
            for (int v = 0; v < VP; ++v) d[v] = ok ? src[v] : from_f32<XT>(0.f);
          }
        }
      }
    }
  };
  // phase-2 stage st's B rows: inter chunk kt from the block that owns it,
  // loaded into registers (FV 16-byte pieces a thread), then stored into
  // the stage's x rows
  constexpr int FV = (CB / 16 + THREADS - 1) / THREADS;
  auto load_inter = [&](int st, uint4 (&v)[FV]) {
    if (st < T1 || st >= T) return false;
    const int kt = (u0 + st - T1) % nq;
    int owner = 0;
    while (share(nq, owner + 1) <= kt) ++owner;
    const uint32_t src = peer_smem(inter + (kt - share(nq, owner)) * CB, owner);
#pragma unroll
    for (int f = 0; f < FV; ++f) {
      if (tid + f * THREADS < CB / 16) v[f] = ld_peer(src + 16 * (tid + f * THREADS));
    }
    return true;
  };
  auto store_inter = [&](int st, const uint4 (&v)[FV]) {
    uint4* dst = reinterpret_cast<uint4*>(sm + (st % STAGES) * SB + PB0 + PB1);
#pragma unroll
    for (int f = 0; f < FV; ++f) {
      if (tid + f * THREADS < CB / 16) dst[tid + f * THREADS] = v[f];
    }
  };
  auto fill_inter = [&](int st) {
    uint4 v[FV];
    if (load_inter(st, v)) store_inter(st, v);
  };
  bool passed = false;  // the cluster's inter is complete
  auto cluster_arrive = [] { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); };
  auto cluster_wait = [] { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); };

  uint32_t magic;  // 0x4B000000, opaque to the compiler so the byte permutes keep immediate selectors
  asm("mov.b32 %0, 0x4B000000;" : "=r"(magic));

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue(s, s);
    cp_async_commit();
  }
  if (T1 == 0) {  // no inter of its own: wait for the peers' at once
    cluster_arrive();
    cluster_wait();
    passed = true;
    for (int s = 0; s < STAGES - 1; ++s) fill_inter(s);
  }

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;

  int slot = 0;
#pragma unroll 1
  for (int st = 0; st < T; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st is in for every thread; the slot before it is consumed
    const bool p1 = st < T1;
    const int item_stage = p1 ? st % kt1 : (u0 + st - T1) % nq;
    const bool item_end = item_stage == (p1 ? kt1 : nq) - 1 || st == T - 1;
    const int prev = slot == 0 ? STAGES - 1 : slot - 1;
    uint4 ahead[FV];  // the B rows of stage st + STAGES - 1, stored once this stage's products are issued
    bool loaded = false;
    if (!item_end) {
      issue(st + STAGES - 1, prev);
      if (passed) loaded = load_inter(st + STAGES - 1, ahead);
    }
    const unsigned char* s = sm + slot * SB;
    const int k0 = item_stage * BK;
#pragma unroll
    for (int ci = 0; ci < CHUNKS / WK; ++ci) {
      const int c = wk + WK * ci;
      if (k0 + 16 * c >= (p1 ? H : MI)) break;  // H, MI % 32 == 0: a live chunk is whole
      uint32_t b[NT][2];
      if (p1) {
        const GateUp::Frag f = GateUp::load(s, reinterpret_cast<const float*>(s + PB0), c, t, g);
        b_frags<XT, NT>(b, s + PB0 + PB1, c, g, t);
        tile_products<GateUp, NT, 0>(acc, f, b, magic, nt_live);
      } else {
        const unsigned char* const pl[3] = {s, s + PB0, s + PB0 + PB1};
        const Fmt<Q8>::Frag f = Fmt<Q8>::load(pl, c, t, g, 16 * g);
        b_frags<__nv_bfloat16, NT>(b, s + PB0 + PB1, c, g, t);
        tile_products<Fmt<Q8>, NT, 0>(acc, f, b, magic, nt_live);
      }
    }
    if (loaded) store_inter(st + STAGES - 1, ahead);
    if (item_end) {
      // the four warps' sums, (w0 + w2) + (w1 + w3), through the two free slots
      __syncthreads();  // every warp is done with this slot
      float* ra = reinterpret_cast<float*>(red_in_ring<XT, NT>() ? sm + prev * SB : sm + STAGES * SB);
      float* rb = reinterpret_cast<float*>(red_in_ring<XT, NT>() ? sm + slot * SB : sm + STAGES * SB + RED * 4);
      if (wk >= 2) store_sums<NT>(wk == 2 ? ra : rb, acc, g, t);
      __syncthreads();
      if (wk < 2) add_sums<NT>(acc, wk == 0 ? ra : rb, g, t);
      __syncthreads();
      if (wk == 1) store_sums<NT>(ra, acc, g, t);
      __syncthreads();
      if (wk == 0) add_sums<NT>(acc, ra, g, t);
      __syncthreads();  // the slots are free for the ring again
      if (wk == 0) {
        if (p1) {  // inter chunk q: row n, columns 8g .. 8g + 7 are piece g of the row
          unsigned char* ic = inter + (st / kt1) * CB;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = 8 * nt + 2 * t + h;
              uint4 v;  // gate column 8g + 2j + c is acc[j][nt][2c + h], its up acc[j + 4][nt][2c + h]
              v.x = bf16_pair(silu_mul(acc[0][nt][h], acc[4][nt][h]), silu_mul(acc[0][nt][2 + h], acc[4][nt][2 + h]));
              v.y = bf16_pair(silu_mul(acc[1][nt][h], acc[5][nt][h]), silu_mul(acc[1][nt][2 + h], acc[5][nt][2 + h]));
              v.z = bf16_pair(silu_mul(acc[2][nt][h], acc[6][nt][h]), silu_mul(acc[2][nt][2 + h], acc[6][nt][2 + h]));
              v.w = bf16_pair(silu_mul(acc[3][nt][h], acc[7][nt][h]), silu_mul(acc[3][nt][2 + h], acc[7][nt][2 + h]));
              *reinterpret_cast<uint4*>(ic + n * IB + 16 * x_piece<__nv_bfloat16>(n, g)) = v;
            }
        } else {  // output slab s: partial[e, piece, n, m0 + 16g ..] = w[e, n] · sums
          const int s = (u0 + st - T1) / nq, m0 = BN * s;
          const int piece = s * nq < u0 ? 1 : 0;  // the slab's second block: the K stages after the first's
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = 8 * nt + 2 * t + h;
              if (n >= N) continue;
              const float we = a.w[(size_t)e * N + n];
              float* o = a.partial + ((size_t)(2 * e + piece) * N + n) * H + m0 + 16 * g;
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (m0 + 16 * g + 4 * u < H) {
                  *reinterpret_cast<float4*>(o + 4 * u) =
                      make_float4(we * acc[2 * u][nt][h], we * acc[2 * u][nt][2 + h],
                                  we * acc[2 * u + 1][nt][h], we * acc[2 * u + 1][nt][2 + h]);
                }
              }
            }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;
      if (st == T1 - 1) {  // the block's inter is written: the down stages' codes fly while the cluster waits
        cluster_arrive();
        issue(st + STAGES - 1, prev);
        cluster_wait();
        passed = true;
        for (int s2 = T1; s2 < min(T, st + STAGES); ++s2) fill_inter(s2);
      } else {
        issue(st + STAGES - 1, prev);
        if (passed) fill_inter(st + STAGES - 1);
      }
    }
    cp_async_commit();
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while a peer still reads its inter
}

// out[n, h] = Σ_e (partial[e, 0, n, h] + partial[e, 1, n, h]), in expert
// order; piece 1 only where the slab of h spans two blocks.
__global__ void combine_kernel(const float* __restrict__ partial, float* __restrict__ out, int E, int N, int H,
                               int MI) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int NH = N * H;
  if (i >= NH) return;
  const bool split = slab_split(H, (MI + GW - 1) / GW, (i % H) / BN);
  float acc = 0.f;
  for (int e = 0; e < E; ++e) {
    float v = partial[(size_t)2 * e * NH + i];
    if (split) v += partial[(size_t)(2 * e + 1) * NH + i];
    acc += v;
  }
  out[i] = acc;
}

// The launch, or with `occupancy` given, what the card holds of it instead.
template <typename XT, int NT, int MINB>
cudaError_t launch(const Args& a, int E, cudaStream_t st, int* occupancy) {
  const int nq = (a.MI + GW - 1) / GW;
  const size_t smem = (size_t)STAGES * stage_bytes<XT, NT>() +
                      (red_in_ring<XT, NT>() ? 0 : (size_t)2 * red_floats<NT>() * 4) +
                      (size_t)((nq + CLUSTER - 1) / CLUSTER) * chunk_bytes<NT>();
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = megafused_kernel<XT, NT, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && CLUSTER > 8) {  // past the portable cluster size (Hopper takes 16)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(E * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (occupancy != nullptr) {  // {clusters the card holds at once, blocks an SM holds}
    err = cudaOccupancyMaxActiveClusters(&occupancy[0], kernel, &cfg);
    return err != cudaSuccess ? err
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[1], kernel, THREADS, smem);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename XT>
cudaError_t launch_rows(const Args& a, int E, cudaStream_t st, int* occupancy) {
  if (a.N <= 8) return launch<XT, 1, MIN_BLOCKS>(a, E, st, occupancy);
  if (a.N <= 16) return launch<XT, 2, MIN_BLOCKS>(a, E, st, occupancy);
  return launch<XT, 4, (MIN_BLOCKS + 1) / 2>(a, E, st, occupancy);
}

}  // namespace mf
}  // namespace dsocr

// x [N, H] (f32 or bf16), w [E, N] f32, gate+up codes [E, H, 2·MI] int8 and
// scales [E, H/32, 2·MI] f32, down codes [E, MI, H] and scales
// [E, MI/32, H]; partial [E, 2, N, H] f32 scratch → out [N, H] f32. With
// `occupancy` (int[2]) given, nothing runs: it gets the clusters of the
// launch the card holds at once and the blocks an SM holds.
extern "C" int dsocr_q8_moe_megafused(const void* x, const void* w, const void* gu_codes,
                                      const void* gu_scales, const void* dn_codes,
                                      const void* dn_scales, void* partial, void* out, int N,
                                      int H, int MI, int E, int x_dtype, void* stream, void* occupancy) {
  using namespace dsocr;
  if (N < 1 || N > 32 || E < 1 || H < 32 || MI < 32 || H % 32 != 0 || MI % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(gu_codes) | reinterpret_cast<uintptr_t>(gu_scales) |
       reinterpret_cast<uintptr_t>(dn_codes) | reinterpret_cast<uintptr_t>(dn_scales) |
       reinterpret_cast<uintptr_t>(partial)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mf::Args a = {};
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.guc = static_cast<const int8_t*>(gu_codes);
  a.gus = static_cast<const float*>(gu_scales);
  a.dnc = static_cast<const int8_t*>(dn_codes);
  a.dns = static_cast<const float*>(dn_scales);
  a.partial = static_cast<float*>(partial);
  a.N = N;
  a.H = H;
  a.MI = MI;
  a.x_vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (x_dtype == kF32) {
    err = mf::launch_rows<float>(a, E, st, static_cast<int*>(occupancy));
  } else if (x_dtype == kBF16) {
    err = mf::launch_rows<__nv_bfloat16>(a, E, st, static_cast<int*>(occupancy));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || occupancy != nullptr) return (int)err;
  const int NH = N * H;
  mf::combine_kernel<<<(NH + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                       static_cast<float*>(out), E, N, H, MI);
  return (int)cudaGetLastError();
}
