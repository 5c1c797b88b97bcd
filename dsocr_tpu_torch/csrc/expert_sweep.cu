// The dense expert sweep over packed in-major weights, one body for Q8_0,
// Q4_K and Q6_K: out[e] = bf16(x_e) @ dequant(W[e]) → [E, N, M] f32.
//
// Replaces, in dsocr_tpu/ops/pallas/, dequant_matmul.py's
// q8_dense_experts_layered (:455) and q8_dense_experts_perx_layered (:495)
// and kquant_matmul.py's q4k_dense_experts_layered (:821),
// q4k_dense_experts_perx_layered (:885), q6k_dense_experts_layered (:959)
// and q6k_dense_experts_perx_layered (:1002). The C entries of
// dequant_matmul.cu and kquant_matmul.cu route here when they get no
// expert index (the dense sweeps); the gather tier keeps their
// expert_kernel. x_e is x for every expert (dense, xg_stride 0) or
// x + e · xg_stride (perx).
//
// Numerics are the reference's (quant_decode.cuh): each weight is the f32
// dequantized value rounded to bf16 once, x is rounded to bf16, products
// sum in f32 on the tensor cores. bf16 × bf16 products are exact in f32,
// so only the summation order differs from the plain twins; the order is
// fixed (no atomics), so two launches give the same bits.
//
// What bounds it on the H100: device-memory bytes. At decode the serving
// path sweeps every expert at N 16 rows: one MoE layer's Q8_0 gate+up is
// 146.8 MB of codes and 18.4 MB of scales (0.052 ms at 3.35 TB/s with the
// f32 output), down 73.4 + 9.2 MB (0.027 ms); 4.7 GFLOP is nothing to the
// tensor cores. What the design does about it:
//
// - A block is one expert × a slab of BN = 128 · WN columns × 16 rows of
//   x, over the whole of K. Its codes, scales (mins, highs) and x come
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
#include "quant_decode.cuh"

namespace dsocr {
namespace sweep {

constexpr int BK = 64;        // K rows a ring stage
constexpr int WN = 1;         // warps across a block's columns, 128 columns each
constexpr int WK = 4;         // warps across a stage's K: chunk c of 16 rows goes to warp c % WK
// blocks an SM holds (the registers they bound: ~160 or 128 a thread); the
// launch takes whichever leaves the fuller last wave of blocks
constexpr int MIN_BLOCKS_LO = 3, MIN_BLOCKS_HI = 4;
constexpr int BN = 128 * WN;
constexpr int THREADS = 32 * WN * WK;
constexpr int CHUNKS = BK / 16;
static_assert(CHUNKS % WK == 0, "every warp takes as many chunks of a stage");

// d += a · b: mma.sync m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// `bytes` (16 or 4) global → shared, or that many zero bytes where !ok
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem), "n"(N),
                 "r"(ok ? N : 0)
                 : "memory");
  }
}

// 16-byte piece `cc` of row r of a byte plane holding `kpr` K values a
// row: its place in shared memory. Lane t of a chunk reads the rows that
// hold K rows 4 t .. 4 t + 3, so those rows flip the piece index by 2 t
// within each 128-byte group: a quarter-warp (g = 2a, 2a + 1; t = 0..3)
// reads 8 distinct groups of banks.
__device__ __forceinline__ int piece(int r, int kpr, int cc) {
  return cc ^ (2 * (((r * kpr) >> 2) & 3));
}

// x's 16-byte piece cc of row n in a stage (rows of BK values): bf16 rows
// (8 pieces) flip by 2 (n % 4), f32 rows (16 pieces) by 4 (n % 2), so the
// B-fragment reads of a half-warp (bf16, 8 bytes) or quarter-warp (f32, 16
// bytes) are conflict-free
template <typename XT>
__device__ __forceinline__ int x_piece(int n, int cc) {
  return sizeof(XT) == 2 ? cc ^ (2 * (n & 3)) : cc ^ (4 * (n & 1));
}

// byte k of `word` as the low byte of the f32 2^23 + byte: one PRMT with
// an immediate selector against `magic` (0x4B000000 in a register)
template <int K>
__device__ __forceinline__ float byte_f32(uint32_t word, uint32_t magic) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(word), "r"(magic), "n"(0x7650 | K));
  return __uint_as_float(d);
}

__device__ __forceinline__ float pick(const float4& v, int k) {  // k a constant after unrolling
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// ---- the formats: the planes of the in-major layout, and one lane's
// share of a 16-K chunk of a stage (quant_decode.cuh's numerics). A
// Frag's u[i][w] holds the four columns 4w .. 4w + 3 of the lane's K row
// 4t + i as one byte each, so value(i, j) is a byte permute into a float's
// mantissa, a subtraction and a product (or FMA) ----
template <class P>
struct Fmt;

template <>
struct Fmt<Q8> {  // codes [E, K, M] int8, scales [E, K/32, M]
  static constexpr int PLANES = 2;
  static constexpr int STAGES = 4;  // ring stages
  // K values a row of plane p holds, and bytes a column of it
  static __host__ __device__ constexpr int kpr(int p) { return p == 0 ? 1 : 32; }
  static __host__ __device__ constexpr int es(int p) { return p == 0 ? 1 : 4; }
  static __host__ __device__ const void* plane(const Q8& w, int p) {
    return p == 0 ? static_cast<const void*>(w.codes) : static_cast<const void*>(w.scales);
  }
  struct Frag {
    uint32_t u[4][4];  // code + 128 (the sign bit flipped)
    float4 s[4];
  };
  // the stage's planes; chunk c, lane t, the lane's piece cc and first column col
  static __device__ __forceinline__ Frag load(const unsigned char* const (&pl)[3], int c, int t, int cc,
                                              int col) {
    Frag f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * c + 4 * t + i;
      const uint4 q = *reinterpret_cast<const uint4*>(pl[0] + r * BN + 16 * piece(r, 1, cc));
#pragma unroll
      for (int w = 0; w < 4; ++w) f.u[i][w] = word_of(q, w) ^ 0x80808080u;
    }
    const float* s = reinterpret_cast<const float*>(pl[1]) + (c / 2) * BN + col;
#pragma unroll
    for (int w = 0; w < 4; ++w) f.s[w] = *reinterpret_cast<const float4*>(s + 4 * w);
    return f;
  }
  // K row 4t + i of the chunk, lane column J: the f32 weight
  template <int I, int J>
  static __device__ __forceinline__ float value(const Frag& f, uint32_t magic) {
    return (byte_f32<J % 4>(f.u[I][J / 4], magic) - 8388736.f) * pick(f.s[J / 4], J % 4);
  }
};

template <>
struct Fmt<Q4K> {  // codes [E, K/2, M] (K rows 2r, 2r + 1 in byte row r), scales, mins [E, K/32, M]
  static constexpr int PLANES = 3;
  static constexpr int STAGES = 3;
  static __host__ __device__ constexpr int kpr(int p) { return p == 0 ? 2 : 32; }
  static __host__ __device__ constexpr int es(int p) { return p == 0 ? 1 : 4; }
  static __host__ __device__ const void* plane(const Q4K& w, int p) {
    return p == 0 ? static_cast<const void*>(w.codes)
                  : p == 1 ? static_cast<const void*>(w.scales) : static_cast<const void*>(w.mins);
  }
  struct Frag {
    uint32_t u[4][4];  // the 4-bit codes, one a byte
    float4 s[4], b[4];
  };
  static __device__ __forceinline__ Frag load(const unsigned char* const (&pl)[3], int c, int t, int cc,
                                              int col) {
    Frag f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // byte rows 2t, 2t + 1: K rows 4t + 2h (low nibbles), + 1 (high)
      const int r = 8 * c + 2 * t + h;
      const uint4 q = *reinterpret_cast<const uint4*>(pl[0] + r * BN + 16 * piece(r, 2, cc));
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        f.u[2 * h][w] = word_of(q, w) & 0x0F0F0F0Fu;
        f.u[2 * h + 1][w] = (word_of(q, w) >> 4) & 0x0F0F0F0Fu;
      }
    }
    const float* s = reinterpret_cast<const float*>(pl[1]) + (c / 2) * BN + col;
    const float* b = reinterpret_cast<const float*>(pl[2]) + (c / 2) * BN + col;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      f.s[w] = *reinterpret_cast<const float4*>(s + 4 * w);
      f.b[w] = *reinterpret_cast<const float4*>(b + 4 * w);
    }
    return f;
  }
  template <int I, int J>
  static __device__ __forceinline__ float value(const Frag& f, uint32_t magic) {  // q·s − b, q·s exact
    return fmaf(byte_f32<J % 4>(f.u[I][J / 4], magic) - 8388608.f, pick(f.s[J / 4], J % 4),
                -pick(f.b[J / 4], J % 4));
  }
};

template <>
struct Fmt<Q6K> {  // codes [E, K/2, M], highs [E, K/4, M] (K row 4h + i at bits 2i of byte row h), scales [E, K/16, M]
  static constexpr int PLANES = 3;
  static constexpr int STAGES = 3;
  static __host__ __device__ constexpr int kpr(int p) { return p == 0 ? 2 : p == 1 ? 4 : 16; }
  static __host__ __device__ constexpr int es(int p) { return p == 0 ? 1 : p == 1 ? 1 : 4; }
  static __host__ __device__ const void* plane(const Q6K& w, int p) {
    return p == 0 ? static_cast<const void*>(w.codes)
                  : p == 1 ? static_cast<const void*>(w.highs) : static_cast<const void*>(w.scales);
  }
  struct Frag {
    uint32_t u[4][4];  // the 6-bit codes lo | hi << 4, one a byte
    float4 s[4];
  };
  static __device__ __forceinline__ Frag load(const unsigned char* const (&pl)[3], int c, int t, int cc,
                                              int col) {
    Frag f;
    const int rh = 4 * c + t;  // highs row t of the chunk: K rows 4t + i at bits 2i
    const uint4 hq = *reinterpret_cast<const uint4*>(pl[1] + rh * BN + 16 * piece(rh, 4, cc));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * c + 2 * t + h;
      const uint4 q = *reinterpret_cast<const uint4*>(pl[0] + r * BN + 16 * piece(r, 2, cc));
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t hw = word_of(hq, w);
        // K row 4t + 2h: low nibbles, highs at bits 4h; 4t + 2h + 1: high nibbles, bits 4h + 2
        f.u[2 * h][w] = (word_of(q, w) & 0x0F0F0F0Fu) | ((h == 0 ? hw << 4 : hw) & 0x30303030u);
        f.u[2 * h + 1][w] = ((word_of(q, w) >> 4) & 0x0F0F0F0Fu) | ((h == 0 ? hw << 2 : hw >> 2) & 0x30303030u);
      }
    }
    const float* s = reinterpret_cast<const float*>(pl[2]) + c * BN + col;
#pragma unroll
    for (int w = 0; w < 4; ++w) f.s[w] = *reinterpret_cast<const float4*>(s + 4 * w);
    return f;
  }
  template <int I, int J>
  static __device__ __forceinline__ float value(const Frag& f, uint32_t magic) {  // q − 32 exactly, one rounding
    return (byte_f32<J % 4>(f.u[I][J / 4], magic) - (8388608.f + 32.f)) * pick(f.s[J / 4], J % 4);
  }
};

template <class P>
__host__ __device__ constexpr int plane_bytes(int p) {  // one stage of plane p
  return p < Fmt<P>::PLANES ? BK / Fmt<P>::kpr(p) * BN * Fmt<P>::es(p) : 0;
}

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
  int R, K, M;
  long long xg_stride;  // elements between experts' x (0: shared)
  bool vec16;     // byte planes copy 16 bytes a piece (M % 16 == 0), else 4
  bool x_vec16;   // x rows start on 16-byte boundaries
};

// A = bf16 pairs of tile J's A fragment: rows g, g + 8 are the lane's
// columns 2j, 2j + 1; K slots 2t, 2t + 1 its K rows 4t, 4t + 1, slots
// 2t + 8, 2t + 9 its K rows 4t + 2, 4t + 3
template <class F, int J>
__device__ __forceinline__ void a_frag(uint32_t (&A)[4], const typename F::Frag& f, uint32_t magic) {
  A[0] = bf16_pair(F::template value<0, 2 * J>(f, magic), F::template value<1, 2 * J>(f, magic));
  A[1] = bf16_pair(F::template value<0, 2 * J + 1>(f, magic), F::template value<1, 2 * J + 1>(f, magic));
  A[2] = bf16_pair(F::template value<2, 2 * J>(f, magic), F::template value<3, 2 * J>(f, magic));
  A[3] = bf16_pair(F::template value<2, 2 * J + 1>(f, magic), F::template value<3, 2 * J + 1>(f, magic));
}

template <class F, int NT, int J>
__device__ __forceinline__ void tile_products(float (&acc)[8][NT][4], const typename F::Frag& f,
                                              const uint32_t (&b)[NT][2], uint32_t magic) {
  if constexpr (J < 8) {
    uint32_t A[4];
    a_frag<F, J>(A, f, magic);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_16816(acc[J][nt], A, b[nt][0], b[nt][1]);
    tile_products<F, NT, J + 1>(acc, f, b, magic);
  }
}

// Grid (slabs of BN columns, experts, 8 NT-row tiles of x): one task a
// block. Warp (wn, wk) owns columns 128 wn .. + 127 of the slab and the
// chunks wk, wk + WK, ... of a stage.
template <class P, typename XT, int NT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) sweep_kernel(const P w, const Args a) {
  using F = Fmt<P>;
  constexpr int STAGES = F::STAGES;
  constexpr int BR = 8 * NT;  // x rows a task
  constexpr int XB = BK * (int)sizeof(XT);  // bytes of an x row in a stage
  constexpr int SB = stage_bytes<P, XT, NT>();
  constexpr int PB0 = plane_bytes<P>(0), PB1 = plane_bytes<P>(1), PB2 = plane_bytes<P>(2);
  extern __shared__ __align__(16) unsigned char sm[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wn = warp % WN, wk = warp / WN, g = lane / 4, t = lane % 4;
  const int K = a.K, M = a.M, R = a.R;
  const int m0 = blockIdx.x * BN, e = blockIdx.y, r0 = blockIdx.z * BR;
  const int ktiles = (K + BK - 1) / BK;

  // the task's planes at K row 0, column m0, and its x rows
  const unsigned char* base[3];
#pragma unroll
  for (int p = 0; p < F::PLANES; ++p) {
    base[p] = static_cast<const unsigned char*>(F::plane(w, p)) +
              ((size_t)e * (K / F::kpr(p)) * M + m0) * F::es(p);
  }
  const XT* xg = static_cast<const XT*>(a.x) + (size_t)e * a.xg_stride + (size_t)r0 * K;

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
    // x rows r0 .. r0 + BR - 1, K values k0 .. k0 + BK - 1, zero past R and K
    unsigned char* xs = st + PB0 + PB1 + PB2;
    constexpr int XP = XB / 16;               // pieces of a row
    constexpr int VP = 16 / (int)sizeof(XT);  // values of a piece
#pragma unroll
    for (int u = 0; u < (BR * XP + THREADS - 1) / THREADS; ++u) {
      const int i = tid + u * THREADS;
      if (i < BR * XP) {
        const int n = i / XP, cc = i % XP;
        const bool ok = r0 + n < R && k0 + VP * cc < K;
        const XT* src = xg + n * K + k0 + VP * cc;
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

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  uint32_t magic;  // 0x4B000000, opaque to the compiler so the byte permutes keep immediate selectors
  asm("mov.b32 %0, 0x4B000000;" : "=r"(magic));
  const int cc_lane = 8 * wn + g;          // the lane's 16-byte piece of a code row
  const int col_lane = 128 * wn + 16 * g;  // its first column in the slab
  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;

  int slot = 0;
#pragma unroll 1
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt is in for every thread; the slot before it is consumed
    {
      const int next = kt + STAGES - 1;
      if (next < ktiles) load_stage(next, slot == 0 ? STAGES - 1 : slot - 1);
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
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {  // x row 8 nt + g, K 16 c + 4 t .. + 3
        const int n = 8 * nt + g;
        if constexpr (sizeof(XT) == 2) {
          const int cc = 2 * c + (t >> 1);
          const uint2 v = *reinterpret_cast<const uint2*>(xs + n * XB + 16 * x_piece<XT>(n, cc) + 8 * (t & 1));
          b[nt][0] = v.x;
          b[nt][1] = v.y;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(xs + n * XB + 16 * x_piece<XT>(n, 4 * c + t));
          b[nt][0] = bf16_pair(v.x, v.y);
          b[nt][1] = bf16_pair(v.z, v.w);
        }
      }
      tile_products<F, NT, 0>(acc, f, b, magic);
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // acc[j][nt]: rows 8 nt + 2t (+1) at the lane's columns 2j (C rows g)
  // and 2j + 1 (C rows g + 8), so columns 16g + 4u .. + 3 of a row are
  // acc[2u][nt][h], acc[2u][nt][2 + h], acc[2u + 1][nt][h], acc[2u + 1][nt][2 + h]
  float* og = a.out + ((size_t)e * R + r0) * M + m0;
  if constexpr (WK == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 8 * nt + 2 * t + h;
        if (r0 + n >= R) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = col_lane + 4 * u;
          if (m0 + m < M) {
            *reinterpret_cast<float4*>(og + (size_t)n * M + m) =
                make_float4(acc[2 * u][nt][h], acc[2 * u][nt][2 + h], acc[2 * u + 1][nt][h], acc[2 * u + 1][nt][2 + h]);
          }
        }
      }
  } else {
    float* red = reinterpret_cast<float*>(sm);
    __syncthreads();  // red overlays the ring, which every warp is done reading
    float* rw = red + (size_t)wk * BR * (BN + 4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 8 * nt + 2 * t + h;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          *reinterpret_cast<float4*>(rw + n * (BN + 4) + col_lane + 4 * u) =
              make_float4(acc[2 * u][nt][h], acc[2 * u][nt][2 + h], acc[2 * u + 1][nt][h], acc[2 * u + 1][nt][2 + h]);
        }
      }
    __syncthreads();
    for (int i = tid; i < BR * BN / 4; i += THREADS) {  // the WK warps' sums, in warp order
      const int n = i / (BN / 4), m = 4 * (i % (BN / 4));
      float4 v = *reinterpret_cast<const float4*>(red + n * (BN + 4) + m);
#pragma unroll
      for (int q = 1; q < WK; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(red + ((size_t)q * BR + n) * (BN + 4) + m);
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
        v.w += y.w;
      }
      if (r0 + n < R && m0 + m < M) *reinterpret_cast<float4*>(og + (size_t)n * M + m) = v;
    }
  }
}

// Blocks of `kernel` the card holds at once (SMs × blocks an SM), set up
// once per kernel
template <class P, typename XT, int NT, int MINB>
cudaError_t resident_blocks(int* out) {
  static int blocks = 0;
  static cudaError_t err = [] {
    auto kernel = sweep_kernel<P, XT, NT, MINB>;
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
inline double wave_fill(long long tasks, int resident) {
  const long long waves = (tasks + resident - 1) / resident;
  return (double)tasks / ((double)waves * resident);
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
  cudaError_t err = resident_blocks<P, XT, NT, MIN_BLOCKS_LO>(&lo);
  if (err == cudaSuccess) err = resident_blocks<P, XT, NT, MIN_BLOCKS_HI>(&hi);
  if (err != cudaSuccess) return err;
  const long long tasks = (long long)grid.x * grid.y * grid.z;
  auto kernel = wave_fill(tasks, lo) > wave_fill(tasks, hi) ? sweep_kernel<P, XT, NT, MIN_BLOCKS_LO>
                                                           : sweep_kernel<P, XT, NT, MIN_BLOCKS_HI>;
  Args a;
  a.x = x;
  a.out = static_cast<float*>(out);
  a.R = R;
  a.K = K;
  a.M = M;
  a.xg_stride = xg_stride;
  a.vec16 = M % 16 == 0;
  a.x_vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (xg_stride * (long long)sizeof(XT)) % 16 == 0;
  kernel<<<grid, THREADS, smem, st>>>(w, a);
  return cudaGetLastError();
}

template <class P, typename XT>
cudaError_t launch_rows(const P& w, const void* x, void* out, int E, int R, int K, int M, long long xg_stride,
                        cudaStream_t st) {
  return R <= 8 ? launch<P, XT, 1>(w, x, out, E, R, K, M, xg_stride, st)
                : launch<P, XT, 2>(w, x, out, E, R, K, M, xg_stride, st);
}

template <class P>
int run(const P& w, const void* x, void* out, int E, int R, int K, int M, long long xg_stride, int x_dtype,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return (int)launch_rows<P, float>(w, x, out, E, R, K, M, xg_stride, st);
    case kBF16:
      return (int)launch_rows<P, __nv_bfloat16>(w, x, out, E, R, K, M, xg_stride, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sweep
}  // namespace dsocr

// out [E, R, M] f32: out[e] = bf16(x + e · xg_stride as [R, K]) @ dequant(W[e])
// for the format `fmt` (QFormat): Q8_0 parts (codes, scales, -), Q4_K
// (codes, scales, mins), Q6_K (codes, highs, scales), in-major. The
// callers (dsocr_q8_expert_matmul, dsocr_q4k_expert_matmul,
// dsocr_q6k_expert_matmul) have checked K and M.
extern "C" int dsocr_expert_sweep(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                  void* out, int E, int R, int K, int M, long long xg_stride, int x_dtype,
                                  void* stream) {
  using namespace dsocr;
  if (E < 1 || R < 1 || M < 4 || M % 4 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1) | reinterpret_cast<uintptr_t>(p2) |
       reinterpret_cast<uintptr_t>(out)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  switch (fmt) {
    case kQ8:
      return sweep::run(Q8{static_cast<const int8_t*>(p0), static_cast<const float*>(p1)}, x, out, E, R, K, M,
                        xg_stride, x_dtype, stream);
    case kQ4K:
      if (K % 256) return (int)cudaErrorInvalidValue;
      return sweep::run(Q4K{static_cast<const uint8_t*>(p0), static_cast<const float*>(p1),
                            static_cast<const float*>(p2)},
                        x, out, E, R, K, M, xg_stride, x_dtype, stream);
    case kQ6K:
      if (K % 256) return (int)cudaErrorInvalidValue;
      return sweep::run(Q6K{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
                            static_cast<const float*>(p2)},
                        x, out, E, R, K, M, xg_stride, x_dtype, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
