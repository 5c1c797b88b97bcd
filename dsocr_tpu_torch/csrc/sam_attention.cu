// SAM global attention with the decomposed relative-position bias, at f32
// accuracy on Hopper's tensor cores.
//
// Replaces sam_flash_attention (dsocr_tpu/ops/pallas/sam_attention.py:74,
// pallas_call at :92):
//   out = softmax(q·kᵀ + bias_h[i, j / W] + bias_w[i, j % W]) · v
// q pre-scaled by D^-0.5; q, k, v, out [BH, S, D], bias_h [BH, S, kh],
// bias_w [BH, S, kw], all f32, kh·kw = S, kw = W. No S×S tensor reaches
// device memory. The Pallas kernel's one-hot expansion matmuls (a Mosaic
// workaround) are not carried over: each score reads its two bias terms.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): operations. A
// (view, head) does 4·S²·D FLOPs on O(S·D) bytes: at BH 12, S 4096, D 64,
// 51.5 GFLOP on ~75 MB, which moves in 0.023 ms at 3.35 TB/s. The
// reference computes in f32, and TF32 alone keeps about three decimal
// digits, so there are two bounds:
// - f32 FMAs on the CUDA cores (67 TFLOP/s): 0.769 ms at BH 12, S 4096;
//   0.704 ms at BH 72, S 1600;
// - 3xTF32 on the tensor cores: each f32 product as three TF32 products
//   (below) at 494.7 TFLOP/s dense: 0.313 ms and 0.286 ms.
//
// What the design does about them:
// - 3xTF32: every operand x splits into hi = tf32(x) and lo = tf32(x - hi)
//   (round to nearest, ties away, as cvt.rna, in two integer ops), and a
//   product is lo·hi + hi·lo + hi·hi, accumulated in f32 (lo·lo, 2^-22 of
//   it, is dropped). Both products, S = Q·Kᵀ and O += P·V, run this way.
// - D <= 64, the main path: wgmma. A block owns 128 queries of one (view,
//   head) in two warpgroups of 64 rows, a warp 16 of them, and walks every
//   key tile of 64 with an online softmax. K and V tiles come raw through a
//   ring of SA_STAGES tiles filled by cp.async (16 bytes a copy, zero-fill
//   past S and past D); once they are in, all 256 threads split them into
//   hi/lo planes in shared memory in the 128-byte swizzle: K in place, V
//   transposed, since a TF32 wgmma reads both operands K-major. Per key tile
//   each warpgroup then issues 24 wgmma.m64n64k8 for the scores (A: Q's
//   hi/lo fragments, split once and kept in registers; B: the K planes) and
//   24 for P·V (A: P's fragments, which are the score C fragments when keys
//   2t and 2t + 1 of each 8 sit at K positions t and t + 4, so V's planes
//   are written in that key order). Splitting once a tile instead of in
//   every warp's fragment loads is what moved the time: the split is ALU
//   work, and on mma.sync it, not the tensor cores, set the kernel's time.
// - The softmax runs on the fragments in registers, in log2 units (q and
//   the bias are scaled by log2 e once; ex2.approx): a row's max across the
//   4 lanes that hold it by two shuffles, its sum kept per lane and reduced
//   once at the end, where O is divided by it. A tile's P·V sums in fresh
//   accumulators and merges into O by FFMA: the tensor cores' f32 sums
//   round toward zero, which over the 1,536 products of a row's output at S
//   4096 biased O by ~7e-5 of its magnitude.
// - Bias: per key tile the loading threads write each key's (j / W, j % W),
//   or (kh, 0) for a key at j >= S (the ragged last tile), so that key's
//   score is -inf and weighs exactly 0; its K and V rows are zero-filled by
//   the copy. Each score reads its two terms by that table from one of two
//   sources, chosen by the C entry from the shared-memory bytes:
//   - staged (every grid up to about 112 × 112 at D <= 64, 190 × 190 above):
//     the block's rows of bias_h and bias_w sit in shared memory, copied
//     once, rows g and g + 8 of a warp side by side (one 8-byte load gives
//     both), bias_h with one more column of -inf. That costs 8 bytes ×
//     BQ / 2 × ((kh + 1) + bw_stride(kw)): 64.5 KB at 64 × 64 with the
//     wgmma body's 128 rows, 80.5 KB at 80 × 80, and it fits while
//     (kh + 1) + bw_stride(kw) <= 228 (wgmma) or 392 (mma.sync);
//   - global, past that budget: each score reads bias_h[i, j / W] and
//     bias_w[i, j % W] through L1 (a key tile touches at most
//     ceil(64 / W) + 1 columns of bias_h and min(W, 64) of bias_w, so the
//     lines stay cached across a warp's rows), scaled by log2 e as the
//     staged copy is, so both sources give the same bits.
//   The reference takes any grid; so does the kernel.
// - 64 < D <= 128 (no caller on the main path): mma.sync.m16n8k8, a block
//   of 64 queries in 4 warps, each warp splitting its K and V fragments as
//   it loads them from tiles in XOR-swizzled rows of 128 (zero-padded).
// - No atomics: two launches give the same bits.
#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace dsocr {

constexpr int SA_BK = 64;     // keys per tile
constexpr int SA_STAGES = 2;  // K/V tiles in the ring
constexpr float SA_LOG2E = 1.4426950408889634f;

struct SamParams {
  const float* q;  // [BH, S, D]
  const float* k;
  const float* v;
  const float* bias_h;  // [BH, S, kh]
  const float* bias_w;  // [BH, S, kw]
  float* out;           // [BH, S, D]
  int S, D, kh, kw, width;
};

// cvt.rna.tf32.f32 in two integer ops: half a TF32 ulp added to the
// magnitude's bits, the 13 bits TF32 drops cleared. The same value for
// every finite x; the instruction itself compiles to about five, with
// checks for NaN and infinity that no operand here needs.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo, each a TF32 value (lo to within 2^-22 of x)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// 16 bytes global → shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0)
               : "memory");
}

// bias_w's column swizzle for row pair g: lanes t = 0..3 of rows g = 0..3
// read 16 distinct 8-byte words at W = 64
__device__ __forceinline__ int bw_swizzle(int g) { return (g & 1) | ((g & 2) << 2); }

__host__ __device__ inline int bw_stride(int kw) { return (kw + 15) & ~15; }

// bytes of a block's bias rows: BQ / 2 pairs of [kh + 1] and [bw_stride(kw)]
inline size_t bias_smem_bytes(int bq, int kh, int kw) {
  return sizeof(float2) * (bq / 2) * ((kh + 1) + bw_stride(kw));
}

// The block's bias rows q0 .. q0 + BQ - 1 in log2 units, as pairs (row g,
// row g + 8) of each warp's 16 rows: bh2 [BQ / 2][kh + 1] (the last column
// -inf), bw2 [BQ / 2][bw_stride(kw)] with bw_swizzle's columns. Rows past S
// are 0.
template <int BQ, int THREADS>
__device__ __forceinline__ void stage_bias(const SamParams& p, int q0, size_t head, float2* bh2,
                                           float2* bw2, int tid) {
  const int khs = p.kh + 1, kws = bw_stride(p.kw), S = p.S;
  for (int i = tid; i < (BQ / 2) * khs; i += THREADS) {
    const int pr = i / khs, c = i - pr * khs;
    const int r0 = q0 + 16 * (pr >> 3) + (pr & 7), r1 = r0 + 8;
    float2 b = make_float2(-INFINITY, -INFINITY);
    if (c < p.kh) {
      b.x = r0 < S ? p.bias_h[(head + r0) * p.kh + c] * SA_LOG2E : 0.f;
      b.y = r1 < S ? p.bias_h[(head + r1) * p.kh + c] * SA_LOG2E : 0.f;
    }
    bh2[i] = b;
  }
  for (int i = tid; i < (BQ / 2) * p.kw; i += THREADS) {
    const int pr = i / p.kw, c = i - pr * p.kw;
    const int r0 = q0 + 16 * (pr >> 3) + (pr & 7), r1 = r0 + 8;
    float2 b;
    b.x = r0 < S ? p.bias_w[(head + r0) * p.kw + c] * SA_LOG2E : 0.f;
    b.y = r1 < S ? p.bias_w[(head + r1) * p.kw + c] * SA_LOG2E : 0.f;
    bw2[pr * kws + (c ^ bw_swizzle(pr & 7))] = b;
  }
}

// A score's two bias terms for rows g and g + 8 of a warp, in log2 units,
// by key column: bias_h's (c = kh for a key past S: -inf) and bias_w's.
// Staged: the block's rows in shared memory (stage_bias's layout).
struct StagedBias {
  const float2* bhr;
  const float2* bwr;
  int wx;
  __device__ __forceinline__ float2 h(int c) const { return bhr[c]; }
  __device__ __forceinline__ float2 w(int c) const { return bwr[c ^ wx]; }
};

// Global: straight from bias_h and bias_w through L1; a row past S reads
// row S - 1 (its output is never written)
struct GlobalBias {
  const float* h0;
  const float* h1;
  const float* w0;
  const float* w1;
  int kh;
  __device__ __forceinline__ GlobalBias(const SamParams& p, size_t head, int row0, int row1) {
    const size_t r0 = head + min(row0, p.S - 1), r1 = head + min(row1, p.S - 1);
    h0 = p.bias_h + r0 * p.kh;
    h1 = p.bias_h + r1 * p.kh;
    w0 = p.bias_w + r0 * p.kw;
    w1 = p.bias_w + r1 * p.kw;
    kh = p.kh;
  }
  __device__ __forceinline__ float2 h(int c) const {
    if (c >= kh) return make_float2(-INFINITY, -INFINITY);
    return make_float2(__ldg(h0 + c) * SA_LOG2E, __ldg(h1 + c) * SA_LOG2E);
  }
  __device__ __forceinline__ float2 w(int c) const {
    return make_float2(__ldg(w0 + c) * SA_LOG2E, __ldg(w1 + c) * SA_LOG2E);
  }
};

// the bias source of pair row pr (rows g and g + 8 of a warp: row0, row1)
template <bool STAGED>
__device__ __forceinline__ auto make_bias(const SamParams& p, size_t head, int row0, int row1,
                                          const float2* bh2, const float2* bw2, int pr, int g) {
  if constexpr (STAGED) {
    return StagedBias{bh2 + pr * (p.kh + 1), bw2 + pr * bw_stride(p.kw), bw_swizzle(g)};
  } else {
    return GlobalBias(p, head, row0, row1);
  }
}

// key k0 + j's (j / W, j % W), or (kh, 0) past S (bias_h's -inf column);
// thread j < SA_BK writes entry j
__device__ __forceinline__ void write_key_table(int2* tab, const SamParams& p, int k0, int j) {
  const int kj = k0 + j;
  int2 hw = make_int2(p.kh, 0);
  if (kj < p.S) {
    hw.x = kj / p.width;
    hw.y = kj - hw.x * p.width;
  }
  tab[j] = hw;
}

// The online softmax over one key tile of a warp's 16 rows, on the score C
// fragments (rows g, g + 8 at keys 8n + 2t, 8n + 2t + 1): adds the bias,
// moves the running max m and rescales the running sum l (alpha: the
// factor for O), and leaves P = 2^(s - m) in sc.
template <class Bias>
__device__ __forceinline__ void softmax_tile(float (&sc)[8][4], const int2* tb, const Bias& bias,
                                             int t, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int4 hw = *reinterpret_cast<const int4*>(tb + 8 * n + 2 * t);
    const float2 h0 = bias.h(hw.x), w0 = bias.w(hw.y);
    const float2 h1 = bias.h(hw.z), w1 = bias.w(hw.w);
    sc[n][0] += h0.x + w0.x;
    sc[n][1] += h1.x + w1.x;
    sc[n][2] += h0.y + w0.y;
    sc[n][3] += h1.y + w1.y;
    mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2(m[i] - mx[i]);  // 0 on the first tile
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = ex2(sc[n][e] - m[e >> 1]);
      l[e >> 1] += sc[n][e];
    }
  }
}

// a row's sum over the 4 lanes that hold it
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// D <= 64: wgmma, two warpgroups a block
constexpr int SW_WG = 2;  // warpgroups a block, 64 query rows each
constexpr int SW_BQ = 64 * SW_WG;
constexpr int SW_THREADS = 128 * SW_WG;
constexpr int SW_TILE = SA_BK * 64;  // floats of a [64][64] tile

// element (r, c) of a [64][64] f32 tile in the 128-byte swizzle wgmma reads
// K-major: two column halves of 32 (8 KB apart), rows of 128 bytes whose
// 16-byte pieces are permuted by r % 8
__device__ __forceinline__ int sw128_f32(int r, int c) {
  return (c >> 5) * 64 * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// d (64 × 64, f32) += a (64 × 8, TF32 in registers) · b (8 × 64, TF32,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[8][4], const float (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(b), "r"(1));
}

// d += a·b at f32 accuracy over the 8 k-steps of a [64][64] plane pair:
// the two small products first, then hi·hi
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[8][4], const float (&ah)[8][4],
                                             const float (&al)[8][4], const float* bh,
                                             const float* bl) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int off = (kk / 4) * 64 * 32 + (kk % 4) * 8;  // column half, 32 bytes a k-step
    const uint64_t dh = wgmma_desc_sw128(bh + off, 16, 1024);
    wgmma_m64n64k8_tf32(d, al[kk], dh);
    wgmma_m64n64k8_tf32(d, ah[kk], wgmma_desc_sw128(bl + off, 16, 1024));
    wgmma_m64n64k8_tf32(d, ah[kk], dh);
  }
}

inline size_t sam_wgmma_smem_bytes(int kh, int kw, bool staged) {
  return sizeof(float) * (SA_STAGES * 2 + 3) * SW_TILE + sizeof(int2) * SA_STAGES * SA_BK +
         (staged ? bias_smem_bytes(SW_BQ, kh, kw) : 0);
}

template <bool STAGED>
__global__ void __launch_bounds__(SW_THREADS, 1) sam_attention_wgmma_kernel(SamParams p) {
  extern __shared__ __align__(1024) float sw_smem[];
  float* ring = sw_smem;                        // [STAGES][K, V][TILE]; K's hi in place
  float* klo = ring + SA_STAGES * 2 * SW_TILE;  // K's lo, [key][d]
  float* vhi = klo + SW_TILE;                   // Vᵀ [d][key, in P's order]
  float* vlo = vhi + SW_TILE;
  int2* tab = reinterpret_cast<int2*>(vlo + SW_TILE);  // [STAGES][BK]
  float2* bh2 = reinterpret_cast<float2*>(tab + SA_STAGES * SA_BK);
  float2* bw2 = bh2 + (SW_BQ / 2) * (p.kh + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = p.S, D = p.D;
  const int q0 = blockIdx.x * SW_BQ;
  const size_t head = (size_t)blockIdx.y * S;
  const float* qg = p.q + head * D;
  const float* kg = p.k + head * D;
  const float* vg = p.v + head * D;

  auto load_tile = [&](int slot, int kt) {
    const int k0 = kt * SA_BK;
    float* ks = ring + slot * 2 * SW_TILE;
#pragma unroll
    for (int it = 0; it < SA_BK * 16 / SW_THREADS; ++it) {
      const int i = tid + it * SW_THREADS, r = i / 16, c = i % 16;
      const bool ok = k0 + r < S && 4 * c < D;
      const size_t off = ok ? (size_t)(k0 + r) * D + 4 * c : 0;
      cp_async16_zfill(ks + sw128_f32(r, 4 * c), kg + off, ok);
      cp_async16_zfill(ks + SW_TILE + sw128_f32(r, 4 * c), vg + off, ok);
    }
    if (tid < SA_BK) write_key_table(tab + slot * SA_BK, p, k0, tid);
  };

  const int ntiles = (S + SA_BK - 1) / SA_BK;
#pragma unroll
  for (int st = 0; st < SA_STAGES - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    cp_async_commit();
  }
  if (STAGED) stage_bias<SW_BQ, SW_THREADS>(p, q0, head, bh2, bw2, tid);

  // Q's A fragments in log2 units, split once: k-step kk's columns t and
  // t + 4 are d = 8 kk + t and 8 kk + t + 4 (wgmma reads K in order)
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  float qh[8][4], ql[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? row1 : row0, d = 8 * kk + t + 4 * (i >> 1);
      const float x = (r < S && d < D) ? qg[(size_t)r * D + d] * SA_LOG2E : 0.f;
      split_tf32(x, qh[kk][i], ql[kk][i]);
    }
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const auto bias = make_bias<STAGED>(p, head, row0, row1, bh2, bw2, 8 * warp + g, g);

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<SA_STAGES - 2>();
    __syncthreads();  // tile kt is in; both warpgroups are done with tile kt - 1
    {
      const int next = kt + SA_STAGES - 1;
      if (next < ntiles) load_tile(next % SA_STAGES, next);
      cp_async_commit();
    }
    const int slot = kt % SA_STAGES;
    float* ks = ring + slot * 2 * SW_TILE;
    const float* vs = ks + SW_TILE;
    // split: K in place (hi) and into klo; V into vhi / vlo transposed, key
    // 8j + e at position 8j + e / 2 (e even) or 8j + 4 + e / 2 (e odd)
#pragma unroll
    for (int it = 0; it < SA_BK * 16 / SW_THREADS; ++it) {
      const int i = tid + it * SW_THREADS;
      float4* x = reinterpret_cast<float4*>(ks + 4 * i);
      float4 h, lo;
      split_tf32(x->x, h.x, lo.x);
      split_tf32(x->y, h.y, lo.y);
      split_tf32(x->z, h.z, lo.z);
      split_tf32(x->w, h.w, lo.w);
      *x = h;
      *reinterpret_cast<float4*>(klo + 4 * i) = lo;
      const int r = i & 63, c = i >> 6;  // V: key r, d 4c .. 4c + 3
      const float4 y = *reinterpret_cast<const float4*>(vs + sw128_f32(r, 4 * c));
      const int col = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
      const float e[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vh, vl;
        split_tf32(e[u], vh, vl);
        vhi[sw128_f32(4 * c + u, col)] = vh;
        vlo[sw128_f32(4 * c + u, col)] = vl;
      }
    }
    fence_proxy_async();
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    wgmma_fence();
    wgmma_3xtf32(sc, qh, ql, ks, klo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    float alpha[2];
    softmax_tile(sc, tab + slot * SA_BK, bias, t, m, l, alpha);
    // P's A fragments: k-step j takes keys 8j + 2t, 8j + 2t + 1 (C columns
    // 2t, 2t + 1) as columns t, t + 4
    float ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(sc[j][0], ph[j][0], pl[j][0]);
      split_tf32(sc[j][2], ph[j][1], pl[j][1]);
      split_tf32(sc[j][1], ph[j][2], pl[j][2]);
      split_tf32(sc[j][3], ph[j][3], pl[j][3]);
    }
    float ot[8][4];  // this tile's P·V
#pragma unroll
    for (int n = 0; n < 8; ++n) ot[n][0] = ot[n][1] = ot[n][2] = ot[n][3] = 0.f;
    wgmma_fence();
    wgmma_3xtf32(ot, ph, pl, vhi, vlo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot);
    fence_regs(ph);
    fence_regs(pl);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] = fmaf(o[n][0], alpha[0], ot[n][0]);
      o[n][1] = fmaf(o[n][1], alpha[0], ot[n][1]);
      o[n][2] = fmaf(o[n][2], alpha[1], ot[n][2]);
      o[n][3] = fmaf(o[n][3], alpha[1], ot[n][3]);
    }
  }
  cp_async_wait<0>();

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  float* og = p.out + head * D;
#pragma unroll
  for (int n = 0; n < 8; ++n) {  // C columns 8n + 2t, 8n + 2t + 1 are d
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
    if (row0 < S) *reinterpret_cast<float2*>(og + (size_t)row0 * D + d) = make_float2(o[n][0] / l0, o[n][1] / l0);
    if (row1 < S) *reinterpret_cast<float2*>(og + (size_t)row1 * D + d) = make_float2(o[n][2] / l1, o[n][3] / l1);
  }
}

inline cudaError_t launch_sam_attention_wgmma(const SamParams& p, int BH, size_t smem_max,
                                              cudaStream_t stream) {
  const bool staged = sam_wgmma_smem_bytes(p.kh, p.kw, true) <= smem_max;
  const size_t smem = sam_wgmma_smem_bytes(p.kh, p.kw, staged);
  auto kernel = staged ? sam_attention_wgmma_kernel<true> : sam_attention_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + SW_BQ - 1) / SW_BQ, BH);
  kernel<<<grid, SW_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 64 < D <= 128: mma.sync, 4 warps a block, D zero-padded to 128
constexpr int SM_WARPS = 4;  // a warp owns 16 query rows
constexpr int SM_BQ = 16 * SM_WARPS;
constexpr int SM_THREADS = 32 * SM_WARPS;
constexpr int SM_DP = 128;
constexpr int SM_TILE = SA_BK * SM_DP;

// d += a·b on the tensor cores: m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d += a·b at f32 accuracy: the two small products first, then hi·hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&ah)[4], const float (&al)[4],
                                           float bh0, float bh1, float bl0, float bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// K tile [key][128] in 16-byte chunks: a fragment load reads rows g, g + 1
// (lanes of one phase) at chunk 4s + t, so odd rows flip chunk bit 2
__device__ __forceinline__ int k_off(int r, int c) { return r * SM_DP + ((c ^ ((r & 1) << 2)) << 2); }

// V tile: a load reads rows 2t (+1) at chunk 4g + c, so the row's t fills
// chunk bits 0 and 1
__device__ __forceinline__ int v_off(int r, int c) { return r * SM_DP + ((c ^ ((r >> 1) & 3)) << 2); }

inline size_t sam_mma_smem_bytes(int kh, int kw, bool staged) {
  return sizeof(float) * SA_STAGES * 2 * SM_TILE + sizeof(int2) * SA_STAGES * SA_BK +
         (staged ? bias_smem_bytes(SM_BQ, kh, kw) : 0);
}

template <bool STAGED>
__global__ void __launch_bounds__(SM_THREADS, 1) sam_attention_mma_kernel(SamParams p) {
  constexpr int CH = SM_DP / 4;  // 16-byte chunks of a row
  constexpr int KS = SM_DP / 8;  // k-steps of the scores, n-tiles of the output
  extern __shared__ __align__(16) float sm_smem[];
  float* ring = sm_smem;  // [STAGES][K, V][TILE]
  int2* tab = reinterpret_cast<int2*>(ring + SA_STAGES * 2 * SM_TILE);  // [STAGES][BK]
  float2* bh2 = reinterpret_cast<float2*>(tab + SA_STAGES * SA_BK);
  float2* bw2 = bh2 + (SM_BQ / 2) * (p.kh + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = p.S, D = p.D;
  const int q0 = blockIdx.x * SM_BQ;
  const size_t head = (size_t)blockIdx.y * S;
  const float* qg = p.q + head * D;
  const float* kg = p.k + head * D;
  const float* vg = p.v + head * D;

  auto load_tile = [&](int slot, int kt) {
    const int k0 = kt * SA_BK;
    float* ks = ring + slot * 2 * SM_TILE;
#pragma unroll
    for (int it = 0; it < SA_BK * CH / SM_THREADS; ++it) {
      const int i = tid + it * SM_THREADS, r = i / CH, c = i % CH;
      const bool ok = k0 + r < S && 4 * c < D;
      const size_t off = ok ? (size_t)(k0 + r) * D + 4 * c : 0;
      cp_async16_zfill(ks + k_off(r, c), kg + off, ok);
      cp_async16_zfill(ks + SM_TILE + v_off(r, c), vg + off, ok);
    }
    if (tid < SA_BK) write_key_table(tab + slot * SA_BK, p, k0, tid);
  };

  const int ntiles = (S + SA_BK - 1) / SA_BK;
#pragma unroll
  for (int st = 0; st < SA_STAGES - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    cp_async_commit();
  }
  if (STAGED) stage_bias<SM_BQ, SM_THREADS>(p, q0, head, bh2, bw2, tid);

  // Q in log2 units, split per tile: k-step 2s takes d and d + 1 of the
  // 16-byte piece at d = 16s + 4t as columns t and t + 4, k-step 2s + 1
  // takes d + 2 and d + 3 (the K fragments are read in the same order)
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  float qf[KS][4];
#pragma unroll
  for (int s = 0; s < SM_DP / 16; ++s) {
    const int d = 16 * s + 4 * t;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (d < D) {
      if (row0 < S) x0 = *reinterpret_cast<const float4*>(qg + (size_t)row0 * D + d);
      if (row1 < S) x1 = *reinterpret_cast<const float4*>(qg + (size_t)row1 * D + d);
    }
    const float a[2][4] = {{x0.x, x1.x, x0.y, x1.y}, {x0.z, x1.z, x0.w, x1.w}};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[2 * s + h][i] = a[h][i] * SA_LOG2E;
  }

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const auto bias = make_bias<STAGED>(p, head, row0, row1, bh2, bw2, 8 * warp + g, g);

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<SA_STAGES - 2>();  // tile kt is in
    __syncthreads();                 // ... for every thread, and tile kt - 1 is consumed
    {
      const int next = kt + SA_STAGES - 1;
      if (next < ntiles) load_tile(next % SA_STAGES, next);
      cp_async_commit();
    }
    const int slot = kt % SA_STAGES;
    const float* ks = ring + slot * 2 * SM_TILE;
    const float* vs = ks + SM_TILE;

    // scores: lane (g, t) holds rows g, g + 8 at keys 8n + 2t, 8n + 2t + 1
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < SM_DP / 16; ++s) {
      float qh[2][4], ql[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(qf[2 * s + h][i], qh[h][i], ql[h][i]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 y = *reinterpret_cast<const float4*>(ks + k_off(8 * n + g, 4 * s + t));
        float hi[4], lo[4];
        split_tf32(y.x, hi[0], lo[0]);
        split_tf32(y.y, hi[1], lo[1]);
        split_tf32(y.z, hi[2], lo[2]);
        split_tf32(y.w, hi[3], lo[3]);
        mma_3xtf32(sc[n], qh[0], ql[0], hi[0], hi[1], lo[0], lo[1]);
        mma_3xtf32(sc[n], qh[1], ql[1], hi[2], hi[3], lo[2], lo[3]);
      }
    }

    float alpha[2];
    softmax_tile(sc, tab + slot * SA_BK, bias, t, m, l, alpha);

    // this tile's P·V in fresh accumulators, 8 keys a k-step: P's A
    // fragment is the score C fragment (keys 2t, 2t + 1 as columns t,
    // t + 4); V rows 2t, 2t + 1 likewise, and n-tile n's B column g is
    // d = 16g + n, so lane g reads 16 contiguous columns of each row
    float ot[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n) ot[n][0] = ot[n][1] = ot[n][2] = ot[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ph[4], pl[4];
      split_tf32(sc[j][0], ph[0], pl[0]);
      split_tf32(sc[j][2], ph[1], pl[1]);
      split_tf32(sc[j][1], ph[2], pl[2]);
      split_tf32(sc[j][3], ph[3], pl[3]);
      float v0[KS], v1[KS];  // rows 2t, 2t + 1
#pragma unroll
      for (int c = 0; c < KS / 4; ++c) {
        const float4 x0 = *reinterpret_cast<const float4*>(vs + v_off(8 * j + 2 * t, (KS / 4) * g + c));
        const float4 x1 = *reinterpret_cast<const float4*>(vs + v_off(8 * j + 2 * t + 1, (KS / 4) * g + c));
        v0[4 * c] = x0.x, v0[4 * c + 1] = x0.y, v0[4 * c + 2] = x0.z, v0[4 * c + 3] = x0.w;
        v1[4 * c] = x1.x, v1[4 * c + 1] = x1.y, v1[4 * c + 2] = x1.z, v1[4 * c + 3] = x1.w;
      }
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        float vh0, vl0, vh1, vl1;
        split_tf32(v0[n], vh0, vl0);
        split_tf32(v1[n], vh1, vl1);
        mma_3xtf32(ot[n], ph, pl, vh0, vh1, vl0, vl1);
      }
    }
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      o[n][0] = fmaf(o[n][0], alpha[0], ot[n][0]);
      o[n][1] = fmaf(o[n][1], alpha[0], ot[n][1]);
      o[n][2] = fmaf(o[n][2], alpha[1], ot[n][2]);
      o[n][3] = fmaf(o[n][3], alpha[1], ot[n][3]);
    }
  }
  cp_async_wait<0>();

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  // lane t holds columns 32t + n (C column 2t of n-tile n) and 32t + 16 + n
  // (column 2t + 1)
  float* og = p.out + head * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int c = 0; c < KS / 4; ++c) {
      const int d = (SM_DP / 4) * t + half * KS + 4 * c;
      if (d >= D) continue;
      if (row0 < S) {
        *reinterpret_cast<float4*>(og + (size_t)row0 * D + d) =
            make_float4(o[4 * c][half] / l0, o[4 * c + 1][half] / l0, o[4 * c + 2][half] / l0,
                        o[4 * c + 3][half] / l0);
      }
      if (row1 < S) {
        *reinterpret_cast<float4*>(og + (size_t)row1 * D + d) =
            make_float4(o[4 * c][2 + half] / l1, o[4 * c + 1][2 + half] / l1,
                        o[4 * c + 2][2 + half] / l1, o[4 * c + 3][2 + half] / l1);
      }
    }
  }
}

inline cudaError_t launch_sam_attention_mma(const SamParams& p, int BH, size_t smem_max,
                                            cudaStream_t stream) {
  const bool staged = sam_mma_smem_bytes(p.kh, p.kw, true) <= smem_max;
  const size_t smem = sam_mma_smem_bytes(p.kh, p.kw, staged);
  auto kernel = staged ? sam_attention_mma_kernel<true> : sam_attention_mma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + SM_BQ - 1) / SM_BQ, BH);
  kernel<<<grid, SM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dsocr

extern "C" int dsocr_sam_flash_attention(
    const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w,
    void* out, int BH, int S, int D, int kh, int kw, int width, void* stream) {
  using namespace dsocr;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  if (BH < 1 || BH > 65535 || S < 1 || D < 4 || D > 128 || D % 4 || kh < 1 || kw < 1 ||
      (long long)kh * kw != S || kw != width || !aligned) {
    return (int)cudaErrorInvalidValue;
  }
  // the bias rows are staged in shared memory where they fit beside the
  // ring, and read per score from L1 / L2 past that
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  SamParams p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.bias_h = static_cast<const float*>(bias_h);
  p.bias_w = static_cast<const float*>(bias_w);
  p.out = static_cast<float*>(out);
  p.S = S;
  p.D = D;
  p.kh = kh;
  p.kw = kw;
  p.width = width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_sam_attention_wgmma(p, BH, (size_t)smem_max, st)
                       : launch_sam_attention_mma(p, BH, (size_t)smem_max, st));
}
