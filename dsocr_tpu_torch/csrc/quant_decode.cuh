// Decode policies of the packed weight formats (Q8_0, Q4_K, Q6_K): one
// thread's share of the codes, loaded as vectors, and the reference's
// dequantization of each value. The kernels are templates over a policy,
// so the tiling, staging and tensor-core work are one body for every
// format.
//
// Layouts, adjacent K values per byte, the first in the low bits:
//  Q8_0  int8 codes; per 32 K values an f32 scale s; w = code·s.
//        Row: codes [M, K], scales [M, K/32].
//  Q4_K  codes (4 bits, two per byte); per 32 K values an f32 scale
//        s = d·sc and an f32 min b = dmin·m; w = q·s − b.
//        Row: codes [M, K/2], scales and mins [M, K/32].
//        In-major: codes [E, K/2, M], scales and mins [E, K/32, M].
//  Q6_K  codes (the low 4 bits, two per byte), highs (the 2-bit high parts,
//        four per byte); per 16 K values an f32 scale s = d·sc;
//        w = (q − 32)·s. Row: codes [M, K/2], highs [M, K/4], scales
//        [M, K/16]. In-major: [E, K/2, M], [E, K/4, M], [E, K/16, M].
//
// Numerics are the reference's: each value is the f32 weight, which the
// kernels round to bf16 once. Q8_0: one rounded product. Q4_K: q·s is
// exact in f32 (a 4-bit code times an f16 value times a 6-bit integer: at
// most 21 significant bits), so the fused multiply-add rounds exactly
// where the reference's separate product and difference do. Q6_K:
// (q − 32)·s can need 25 bits, so it is formed as the reference forms it:
// an exact f32 difference, then one rounded product.
//
// Row: 32 consecutive K values k0 .. k0 + 31 of one W row (k0 % 32 == 0);
// value(r, v) is value v of them. A zero Row (dead rows) decodes to ±0.
#pragma once

#include "common.cuh"

namespace dsocr {

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {  // lo at the lower address
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t field(uint32_t word, int shift, uint32_t mask) {
  return (word >> shift) & mask;
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// An integer 0 <= u < 2^23 minus `bias`, as f32, exactly: u ORed into the
// mantissa of 2^23, less 2^23 + bias (a logic op and a subtraction, where
// I2F runs at a quarter of the FP32 rate)
__device__ __forceinline__ float small_uint_f32(uint32_t u, float bias) {
  return __uint_as_float(0x4B000000u | u) - (8388608.f + bias);
}

// format codes shared with the Python wrappers (ops/kernels/_lib.py)
enum QFormat : int { kQ8 = 0, kQ4K = 1, kQ6K = 2 };

struct Q8 {
  static constexpr int SUB = 32;  // K values per scale
  const int8_t* codes;
  const float* scales;

  struct Row {  // 32 bytes of codes, one scale
    uint4 q[2];
    float s;
  };
  __device__ __forceinline__ Row row(size_t m, int K, int k0) const {
    const uint4* c = reinterpret_cast<const uint4*>(codes + m * K + k0);
    return {{c[0], c[1]}, scales[m * (K / SUB) + k0 / SUB]};
  }
  static __device__ __forceinline__ float value(const Row& r, int v) {
    // code + 128 becomes the low byte of the float 2^23 + (code + 128)
    const uint32_t word = word_of(r.q[v / 16], (v % 16) / 4) ^ 0x80808080u;
    return (__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650 | (v % 4))) - 8388736.f) * r.s;
  }
};

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
    return fmaf(small_uint_f32(field(word_of(r.q, v / 8), 4 * (v % 8), 0xFu), 0.f), r.s, -r.b);
  }
};

struct Q6K {
  static constexpr int SUB = 16;  // K values per scale
  const uint8_t* codes;
  const uint8_t* highs;
  const float* scales;

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
  static __device__ __forceinline__ float value(const Row& r, int v) {  // q − 32 exactly, then one rounding
    const uint32_t q = field(word_of(r.q, v / 8), 4 * (v % 8), 0xFu) |
                       (field(v < 16 ? r.h.x : r.h.y, 2 * (v % 16), 0x3u) << 4);
    return small_uint_f32(q, 32.f) * (v < 16 ? r.s.x : r.s.y);
  }
};

}  // namespace dsocr
