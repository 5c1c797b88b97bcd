// The expert sweep's body, shared by the routed-expert kernels of
// expert_sweep.cu (the dense sweeps and the gather tier) and the megafused
// Q8_0 chain of moe_megafused.cu: the ring stage's geometry, the copies,
// the XOR swizzles of the stage's planes, the formats' in-register decode
// (Fmt<P>: codes to floats by a byte permute into a float's mantissa) and
// the mma.sync.m16n8k16 fragments a lane builds from them. See the note at
// the top of expert_sweep.cu for the lane mapping and what it is for.
#pragma once

#include "quant_decode.cuh"

namespace dsocr {
namespace sweep {

constexpr int BK = 64;        // K rows a ring stage
constexpr int WN = 1;         // warps across a block's columns, 128 columns each
constexpr int WK = 4;         // warps across a stage's K: chunk c of 16 rows goes to warp c % WK
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

// The B fragments of a stage's x rows (BK values a row, x_piece's layout):
// n-tile nt takes row 8 nt + g at K 16 c + 4 t .. + 3 (bf16: one 8-byte
// read; f32: one 16-byte read, rounded to bf16 in registers)
template <typename XT, int NT>
__device__ __forceinline__ void b_frags(uint32_t (&b)[NT][2], const unsigned char* xs, int c, int g, int t) {
  constexpr int XB = BK * (int)sizeof(XT);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
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
}

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
                                              const uint32_t (&b)[NT][2], uint32_t magic, int nt_live) {
  if constexpr (J < 8) {
    uint32_t A[4];
    a_frag<F, J>(A, f, magic);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < nt_live) mma_16816(acc[J][nt], A, b[nt][0], b[nt][1]);
    tile_products<F, NT, J + 1>(acc, f, b, magic, nt_live);
  }
}

}  // namespace sweep
}  // namespace dsocr
