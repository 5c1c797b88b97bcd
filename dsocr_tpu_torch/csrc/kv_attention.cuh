// The one-token KV write and the one-query decode attention of the
// continuous-batching step, generic in how a row's positions map to rows
// of the cache: ``SlotRows`` for the contiguous [B, NKV, S, D] slot cache
// (slot_attention.cu), ``PagedRows`` for the [P, NKV, page, D] page pool
// behind per-row page tables (paged_attention.cu). A map gives
//
//   n_pos(b)      the positions [0, n_pos) that row b attends;
//   row(b, h, t)  the cache row (of D, or Dv, elements) that holds
//                 position t of row b and KV head h, or -1 where the row
//                 holds nothing there (the write skips it, the attend
//                 leaves it out);
//   run(t)        how many positions from t on lie in consecutive cache
//                 rows (to the end of the row, or of t's page), so that
//                 the attend looks up one row per tile.
//
// One body serves both caches: the split-K attend below (its design and
// bound are in the note above decode_split_kernel) runs both the slot and
// the paged decode attention.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace dsocr {

struct SlotRows {
  const int32_t* lengths;
  int NKV, S;

  __device__ int n_pos(int b) const {
    const long long n = (long long)lengths[b] + 1;  // attends [0, lengths[b]] inclusive
    return n < 1 ? 1 : (n > S ? S : (int)n);
  }
  __device__ long long row(int b, int h, int t) const {
    if (t < 0 || t >= S) return -1;
    return ((long long)b * NKV + h) * S + t;
  }
  __device__ int run(int t) const { return S - t; }
};

struct PagedRows {
  const int32_t* lengths;
  const int32_t* tables;  // [B, P_max]; an entry outside [0, P) is no page
  int NKV, P, page, P_max;

  __device__ int n_pos(int b) const {
    const long long n = (long long)lengths[b] + 1;
    const long long cap = (long long)P_max * page;
    return n < 0 ? 0 : (n > cap ? (int)cap : (int)n);
  }
  __device__ long long row(int b, int h, int t) const {
    if (t < 0 || t / page >= P_max) return -1;
    const int pid = tables[(size_t)b * P_max + t / page];
    if (pid < 0 || pid >= P) return -1;
    return ((long long)pid * NKV + h) * page + t % page;
  }
  __device__ int run(int t) const { return page - t % page; }
};

// ---- the KV write ---------------------------------------------------------
// One warp per (row, head) and plane (warp 0 of a block K, warp 1 V): row
// b's new token goes into the cache row that holds position lengths[b]; a
// row that holds no such position writes nothing. Its source row is
// kn + b · kb + h · kh (elements; D contiguous), so the decoder's K and V
// come as the views its projection leaves, with no copy. Three modes of
// one body:
//
//   QUANT   TI f32 or bf16, TC int8: the token is quantized here, as the
//           reference's quantize_kv_int8 does before its write: amax by
//           warp max (order-free, so exact), scale = amax / 127 (IEEE
//           division: the build has no fast-math), safe = scale where > 0
//           else 1, code = int8(clamp(rint(x / safe), -127, 127)), round
//           half to even. D ≤ 128: four values a lane. Codes and scale go
//           to the map's row.
//   convert TI f32 or bf16, TC f32 or bf16: the token in the cache's type
//           (round to nearest even, as .to(dtype)).
//   copy    TI = TC, an unsigned type of the element's size: bits as they
//           are, the scales ksn/vsn [B, NKV] beside them where the cache
//           has scale planes (the reference's Pallas contract: codes and
//           scales quantized by the caller).
template <typename TI, typename TC, bool QUANT, typename Map>
__global__ void __launch_bounds__(64) kv_write_kernel(TC* k, TC* v, float* ks, float* vs, const TI* kn,
                                                      const TI* vn, const float* ksn, const float* vsn,
                                                      long long kb, long long kh, long long vb, long long vh,
                                                      int NKV, int D, int Dv, Map map) {
  const int b = blockIdx.x, h = blockIdx.y, lane = threadIdx.x % 32;
  const bool is_v = threadIdx.x >= 32;
  const long long dst = map.row(b, h, map.lengths[b]);
  if (dst < 0) return;
  const int n = is_v ? Dv : D;
  const TI* src = is_v ? vn + b * vb + h * vh : kn + b * kb + h * kh;
  TC* out = (is_v ? v : k) + dst * n;
  if constexpr (QUANT) {
    float x[4];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * lane + i;
      x[i] = d < n ? to_f32(src[d]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    amax = warp_max(amax);
    const float scale = amax / 127.0f;
    const float safe = scale > 0.f ? scale : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * lane + i;
      if (d < n) out[d] = (TC)fminf(fmaxf(rintf(x[i] / safe), -127.f), 127.f);
    }
    if (lane == 0) (is_v ? vs : ks)[dst] = scale;
  } else {
    for (int d = lane; d < n; d += 32) {
      if constexpr (std::is_same<TI, TC>::value) {
        out[d] = src[d];
      } else {
        out[d] = from_f32<TC>(to_f32(src[d]));
      }
    }
    if (ks != nullptr && lane == 0) (is_v ? vs : ks)[dst] = (is_v ? vsn : ksn)[(size_t)b * NKV + h];
  }
}

template <typename TI, typename TC, bool QUANT, typename Map>
cudaError_t launch_kv_write_as(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                               const void* ksn, const void* vsn, long long kb, long long kh, long long vb,
                               long long vh, int B, int NKV, int D, int Dv, Map map, cudaStream_t st) {
  kv_write_kernel<TI, TC, QUANT, Map><<<dim3(B, NKV), 64, 0, st>>>(
      static_cast<TC*>(k), static_cast<TC*>(v), static_cast<float*>(ks), static_cast<float*>(vs),
      static_cast<const TI*>(kn), static_cast<const TI*>(vn), static_cast<const float*>(ksn),
      static_cast<const float*>(vsn), kb, kh, vb, vh, NKV, D, Dv, map);
  return cudaGetLastError();
}

// The reference's contract: k_new/v_new [B, NKV, D|Dv] already in the
// cache's type (int8 codes with their scales ksn/vsn), copied bit for bit.
template <typename Map>
cudaError_t launch_kv_write(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                            const void* ksn, const void* vsn, int B, int NKV, int D, int Dv,
                            int esize, Map map, cudaStream_t st) {
  const long long kb = (long long)NKV * D, vb = (long long)NKV * Dv;
  switch (esize) {
    case 1:
      return launch_kv_write_as<uint8_t, uint8_t, false>(k, v, ks, vs, kn, vn, ksn, vsn, kb, D, vb, Dv, B, NKV,
                                                         D, Dv, map, st);
    case 2:
      return launch_kv_write_as<uint16_t, uint16_t, false>(k, v, ks, vs, kn, vn, ksn, vsn, kb, D, vb, Dv, B,
                                                           NKV, D, Dv, map, st);
    case 4:
      return launch_kv_write_as<uint32_t, uint32_t, false>(k, v, ks, vs, kn, vn, ksn, vsn, kb, D, vb, Dv, B,
                                                           NKV, D, Dv, map, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The token as the decoder leaves it, in_dtype f32 or bf16 at strides
// (kb, kh), (vb, vh): quantized for an int8 cache (cache_dtype kI8, ks and
// vs its scale planes), else converted to the cache's f32 or bf16.
template <typename TI, typename Map>
cudaError_t launch_kv_write_token_from(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                                       long long kb, long long kh, long long vb, long long vh, int B, int NKV,
                                       int D, int Dv, int cache_dtype, Map map, cudaStream_t st) {
  switch (cache_dtype) {
    case kI8:
      if (D > 128 || Dv > 128 || ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch_kv_write_as<TI, int8_t, true>(k, v, ks, vs, kn, vn, nullptr, nullptr, kb, kh, vb, vh, B, NKV,
                                                  D, Dv, map, st);
    case kF32:
      return launch_kv_write_as<TI, float, false>(k, v, nullptr, nullptr, kn, vn, nullptr, nullptr, kb, kh, vb,
                                                  vh, B, NKV, D, Dv, map, st);
    case kBF16:
      return launch_kv_write_as<TI, __nv_bfloat16, false>(k, v, nullptr, nullptr, kn, vn, nullptr, nullptr, kb,
                                                          kh, vb, vh, B, NKV, D, Dv, map, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Map>
cudaError_t launch_kv_write_token(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                                  long long kb, long long kh, long long vb, long long vh, int B, int NKV, int D,
                                  int Dv, int in_dtype, int cache_dtype, Map map, cudaStream_t st) {
  switch (in_dtype) {
    case kF32:
      return launch_kv_write_token_from<float>(k, v, ks, vs, kn, vn, kb, kh, vb, vh, B, NKV, D, Dv, cache_dtype,
                                               map, st);
    case kBF16:
      return launch_kv_write_token_from<__nv_bfloat16>(k, v, ks, vs, kn, vn, kb, kh, vb, vh, B, NKV, D, Dv,
                                                       cache_dtype, map, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- the decode attend ------------------------------------------------------
// One query per (row, head) against the row's cached positions: with G = 1
// (DeepSeek-OCR's 10 query heads on 10 KV heads) it is a matrix-vector
// product, 4 FLOPs per bf16 K/V element, far below the card's ~295 FLOPs
// per byte, so the bound is device-memory bytes and the design keeps as
// many of them in flight as it can. No tensor cores: they would only wait
// on the same bytes.
//
// Split-K over positions. The grid is (splits, NKV, B); split s owns the
// positions [s·DA_CHUNK, (s+1)·DA_CHUNK) of the cache's capacity (S, or
// P_max · page), so a 16-row step over a 1536-position cache is 960
// blocks instead of 160, and a long row no longer sets the time alone.
// `splits` comes from the capacity on the host: `lengths` is never read
// back. Within a split, the positions the row attends fall into tiles of
// up to DA_WTILE consecutive cache rows (a tile also ends where map.run
// does: at a page boundary), dealt to the block's four warps in turn.
// Each warp is a pipeline of its own, with no block-wide barrier in its
// loop: it copies its next tile's K and V rows (and int8 scales) into one
// of its two shared-memory stages by cp.async, 16 bytes a lane where the
// row size allows, while it computes on the other. Scores: half a warp
// per position, each lane a 16-byte slice of the row (8 elements) against
// q held in registers; one transpose-reduce (8 shuffles) finishes the
// tile's 16 dots at once, two lanes holding each. The scores stay in
// registers for an f32 online softmax from m = -1e30, in log2 units (ex2,
// with log2 e folded into the scale), one exponential a lane; int8 codes
// become floats by a byte permute (exact, and at the full FP32 rate). The
// value sum gives each lane 4 columns and takes p from the lane that holds
// it by shuffle. At the end of the split the four warps' (m, l, acc) are
// combined in warp order, and the split writes its (m, l, acc[Dv]) per
// query head to the scratch `part`; a split that attends nothing (past
// n_pos, or no page holds its positions) writes l = 0.
// decode_merge_kernel then combines the splits in split order:
// deterministic, no atomics. int8 caches fold their scales in as the
// reference does: k scale after `* scale`, v scale into p after l has
// accumulated p. A row with no position gets zeros.
constexpr int DA_WTILE = 16;   // positions per warp tile (the score reduction assumes 16)
constexpr int DA_STAGES = 2;   // a warp's ring of tiles in shared memory
constexpr int DA_CHUNK = 256;  // positions per split (ops/kernels/_lib.py: DECODE_SPLIT)
constexpr int DA_WARPS = 4;
constexpr int DA_THREADS = 32 * DA_WARPS;
constexpr int DA_MAXG = 8;
constexpr int DA_DMAX = 128;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// 8 consecutive elements of a shared-memory row, as f32 (p 16-byte aligned
// for bf16, 8 for int8, 32 for f32: rows of a multiple of 8 elements)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// 4 int8 codes packed in u, as f32, exactly: each code + 128 becomes the low
// byte of the float 2^23 + (code + 128) (a byte permute and a subtraction,
// where I2F runs at a quarter of the FP32 rate)
__device__ __forceinline__ void i8x4_to_f32(unsigned u, float* x) {
  u ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388736.f;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  i8x4_to_f32(u.x, x);
  i8x4_to_f32(u.y, x + 4);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// 4 consecutive elements (rows of a multiple of 4 elements)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  i8x4_to_f32(*reinterpret_cast<const unsigned*>(p), x);
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

// one warp stage: K rows, V rows, k scales, v scales
template <typename KT>
__host__ __device__ inline int decode_stage_bytes(int D, int Dv) {
  return align16(DA_WTILE * D * (int)sizeof(KT)) + align16(DA_WTILE * Dv * (int)sizeof(KT)) +
         2 * DA_WTILE * (int)sizeof(float);
}

template <typename KT>
inline size_t decode_smem_bytes(int G, int D, int Dv) {
  return align16(G * D * 4) + DA_STAGES * DA_WARPS * (size_t)decode_stage_bytes<KT>(D, Dv) +
         sizeof(float) * 2 * DA_WARPS * DA_MAXG;
}

// GM: the largest G the instance takes (1, or DA_MAXG), so that the G = 1
// path keeps only its own registers.
template <typename QT, typename KT, int GM, typename Map>
__global__ void __launch_bounds__(DA_THREADS)
    decode_split_kernel(const QT* q, const KT* k, const KT* v, const float* ks, const float* vs,
                        float* part, int NH, int NKV, int D, int Dv, float scale, int chunk,
                        Map map) {
  extern __shared__ __align__(16) unsigned char da_smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = NH / NKV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kb = align16(DA_WTILE * D * (int)sizeof(KT));
  const int vb = align16(DA_WTILE * Dv * (int)sizeof(KT));
  const int stage = decode_stage_bytes<KT>(D, Dv);
  float* q_s = reinterpret_cast<float*>(da_smem);                // [G][D]
  unsigned char* stages = da_smem + align16(G * D * 4);          // [WARPS][STAGES]
  float* mw_s = reinterpret_cast<float*>(stages + DA_STAGES * DA_WARPS * stage);  // [WARPS][G]
  float* lw_s = mw_s + DA_WARPS * DA_MAXG;                                 // [WARPS][G]
  float* aw_s = reinterpret_cast<float*>(stages);  // [WARPS][G][Dv], after the loop

  float* out = part + (((size_t)b * NKV + h) * gridDim.x + split) * G * (Dv + 2);
  const int c0 = split * DA_CHUNK;
  const int c1 = min(c0 + DA_CHUNK, map.n_pos(b));
  if (c0 >= c1) {  // nothing of this split is attended: an empty partial
    if (tid < G) {
      out[tid * (Dv + 2)] = -INFINITY;
      out[tid * (Dv + 2) + 1] = 0.f;
    }
    return;
  }
  for (int idx = tid; idx < G * D; idx += DA_THREADS) {
    q_s[idx] = to_f32(q[((size_t)b * NH + h * G) * D + idx]);
  }

  // this warp's next tile at or after (t, i) that some page holds: tiles
  // are numbered i from c0 on, and warp w takes those with i % WARPS = w
  auto next_own = [&](int& t, int& i, int& nt, long long& base) {
    while (t < c1) {
      nt = min(min(DA_WTILE, c1 - t), map.run(t));
      if (i % DA_WARPS == warp) {
        base = map.row(b, h, t);
        if (base >= 0) return true;
      }
      t += nt;
      ++i;
    }
    return false;
  };
  unsigned char* ws = stages + warp * DA_STAGES * stage;
  auto issue = [&](int s, int nt, long long base) {
    unsigned char* sb = ws + s * stage;
    stage_bytes(sb, k + base * D, nt * D * (int)sizeof(KT), chunk, lane, 32);
    stage_bytes(sb + kb, v + base * Dv, nt * Dv * (int)sizeof(KT), chunk, lane, 32);
    if (ks != nullptr) {
      stage_bytes(sb + kb + vb, ks + base, nt * 4, 4, lane, 32);
      stage_bytes(sb + kb + vb + DA_WTILE * 4, vs + base, nt * 4, 4, lane, 32);
    }
  };

  // the tiles in flight, oldest first: whether there is one, and its size;
  // (t, i) is the next tile not yet issued
  bool have[DA_STAGES - 1];
  int ntq[DA_STAGES - 1];
  int t = c0, i = 0;
#pragma unroll
  for (int j = 0; j < DA_STAGES - 1; ++j) {
    long long base = -1;
    have[j] = next_own(t, i, ntq[j], base);
    if (have[j]) {
      issue(j, ntq[j], base);
      t += ntq[j];
      ++i;
    }
    cp_async_commit();
  }
  __syncthreads();  // q_s

  const int half = lane / 16, c = lane % 16;  // scores: lane c of a half takes [8c, 8c + 8)
  const int d0 = 4 * lane;                    // value sum: columns [4 lane, 4 lane + 4)
  const bool vec8 = D % 8 == 0, vec4 = Dv % 4 == 0;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units
  float qr[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = 8 * c + e;
      qr[g][e] = (g < G && d < D) ? q_s[g * D + d] : 0.f;
    }
  float m[GM], l[GM], acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  int s = 0;  // the stage of the oldest tile in flight
  while (have[0]) {
    const int nt = ntq[0];
    int nt2 = 0;
    long long base2 = -1;
    const bool have2 = next_own(t, i, nt2, base2);
    if (have2) {
      issue((s + DA_STAGES - 1) % DA_STAGES, nt2, base2);
      t += nt2;
      ++i;
    }
    cp_async_commit();
    cp_async_wait<DA_STAGES - 1>();  // this tile's copies are in; the later ones stay in flight
    __syncwarp();
    const unsigned char* sb = ws + s * stage;
    const KT* kt = reinterpret_cast<const KT*>(sb);
    const KT* vt = reinterpret_cast<const KT*>(sb + kb);
    const float* kst = ks != nullptr ? reinterpret_cast<const float*>(sb + kb + vb) : nullptr;
    const float* vst = ks != nullptr ? kst + DA_WTILE : nullptr;

    // partial dots of positions j = 2p + half (p < 8) over this lane's 8
    // elements, then a transpose-reduce across the 16 lanes of the half:
    // 8 shuffles leave lanes c and c ^ 1 with the whole dot of position
    // jl = 2 (c / 2) + half
    float part[GM][DA_WTILE / 2];
#pragma unroll
    for (int p = 0; p < DA_WTILE / 2; ++p) {
      const int j = 2 * p + half;
      float x[8];
      if (j < nt && 8 * c < D) {
        const KT* row = kt + (size_t)j * D + 8 * c;
        if (vec8) {
          load8(row, x);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = (8 * c + e < D) ? to_f32(row[e]) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], x[e], dot);
        part[g][p] = dot;
      }
    }
    const int jl = 2 * (c >> 1) + half;
    const bool live = jl < nt;
    const float ksj = (kst != nullptr && live) ? kst[jl] : 1.f;
    const float vsj = (vst != nullptr && live) ? vst[jl] : 1.f;
    float pe[GM];  // p of position jl, with the v scale folded in
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float w[4], y2[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool up = c & 8;
        w[i] = (up ? part[g][i + 4] : part[g][i]) +
               __shfl_xor_sync(0xffffffffu, up ? part[g][i] : part[g][i + 4], 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool up = c & 4;
        y2[i] = (up ? w[i + 2] : w[i]) + __shfl_xor_sync(0xffffffffu, up ? w[i] : w[i + 2], 4);
      }
      const bool up = c & 2;
      float dot = (up ? y2[1] : y2[0]) + __shfl_xor_sync(0xffffffffu, up ? y2[0] : y2[1], 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      // online softmax in log2 units (2^(x·log2e) = e^x); each position sits
      // in two lanes, so the reductions skip the partner lane
      float sj = dot * scale2;
      if (kst != nullptr) sj *= ksj;
      sj = live ? sj : -INFINITY;
      float mt = sj;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[g], mt);  // finite: the tile holds a key
      const float alpha = ex2(m[g] - m_new);
      const float e = live ? ex2(sj - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] *= alpha;
      pe[g] = e * vsj;
    }
    // value sum: lane holds columns d0 .. d0 + 3; p of position j from lane
    // (j % 2) · 16 + 2 (j / 2), shuffled by every lane (p is 0 past nt)
#pragma unroll
    for (int j = 0; j < DA_WTILE; ++j) {
      float pj[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) pj[g] = __shfl_sync(0xffffffffu, pe[g], (j % 2) * 16 + (j & ~1));
      float vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nt && d0 < Dv) {
        const KT* row = vt + (size_t)j * Dv + d0;
        if (vec4) {
          load4(row, vv);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) vv[e] = (d0 + e < Dv) ? to_f32(row[e]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pj[g], vv[e], acc[g][e]);
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
#pragma unroll
    for (int j = 0; j + 1 < DA_STAGES - 1; ++j) {
      have[j] = have[j + 1];
      ntq[j] = ntq[j + 1];
    }
    have[DA_STAGES - 2] = have2;
    ntq[DA_STAGES - 2] = nt2;
    s = (s + 1) % DA_STAGES;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its stages: they take the warps' sums

  // combine the four warps in warp order; a warp that attended nothing has l = 0
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      if (lane == 0) {
        mw_s[warp * DA_MAXG + g] = m[g];
        lw_s[warp * DA_MAXG + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d0 + e < Dv) aw_s[(warp * G + g) * Dv + d0 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * Dv; idx += DA_THREADS) {
    const int g = idx / Dv, d = idx % Dv;
    float mx = -INFINITY;
    for (int w = 0; w < DA_WARPS; ++w) {
      if (lw_s[w * DA_MAXG + g] > 0.f) mx = fmaxf(mx, mw_s[w * DA_MAXG + g]);
    }
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < DA_WARPS; ++w) {
      const float lw = lw_s[w * DA_MAXG + g];
      if (lw > 0.f) {
        const float wt = ex2(mw_s[w * DA_MAXG + g] - mx);
        lt = fmaf(lw, wt, lt);
        at = fmaf(aw_s[(w * G + g) * Dv + d], wt, at);
      }
    }
    out[g * (Dv + 2) + 2 + d] = at;
    if (d == 0) {
      out[g * (Dv + 2)] = mx;
      out[g * (Dv + 2) + 1] = lt;
    }
  }
}

// Grid (NKV, B): the splits' (m, l) of a head are read once into shared
// memory and turned into weights; then each output element combines its
// splits in split order. Splits with l = 0 attended nothing and weigh 0.
template <typename OT>
__global__ void __launch_bounds__(DA_THREADS)
    decode_merge_kernel(const float* part, OT* out, int NH, int NKV, int Dv, int splits) {
  extern __shared__ float mg_smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = NH / NKV;
  const int W = Dv + 2;
  const float* pb = part + ((size_t)b * NKV + h) * splits * G * W;
  float* w_s = mg_smem;              // [splits][G]: m, then the weight
  float* l_s = w_s + splits * G;     // [splits][G]
  float* inv_s = l_s + splits * G;   // [G]: 1 / l, or 0 for a row with no position
  for (int idx = threadIdx.x; idx < splits * G; idx += blockDim.x) {
    w_s[idx] = pb[(size_t)idx * W];
    l_s[idx] = pb[(size_t)idx * W + 1];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) {
      if (l_s[s * G + g] > 0.f) mx = fmaxf(mx, w_s[s * G + g]);
    }
    float lt = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = l_s[s * G + g];
      const float wt = ls > 0.f ? ex2(w_s[s * G + g] - mx) : 0.f;
      w_s[s * G + g] = wt;
      lt = fmaf(ls, wt, lt);
    }
    inv_s[g] = lt > 0.f ? 1.f / lt : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dv; idx += blockDim.x) {
    const int g = idx / Dv, d = idx % Dv;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float wt = w_s[s * G + g];
      if (wt > 0.f) a = fmaf(pb[((size_t)s * G + g) * W + 2 + d], wt, a);
    }
    out[((size_t)b * NH + h * G + g) * Dv + d] = from_f32<OT>(a * inv_s[g]);
  }
}

inline int decode_splits(long long capacity) {
  return (int)((capacity + DA_CHUNK - 1) / DA_CHUNK);
}

template <typename QT, typename KT, int GM, typename Map>
cudaError_t launch_decode_split(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, void* part, int B, int NH, int NKV, int D, int Dv,
                                float scale, int splits, Map map, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<KT>(NH / NKV, D, Dv);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<QT, KT, GM, Map>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int chunk = copy_chunk({(unsigned long long)D * sizeof(KT),
                                (unsigned long long)Dv * sizeof(KT),
                                (unsigned long long)(uintptr_t)k, (unsigned long long)(uintptr_t)v});
  decode_split_kernel<QT, KT, GM, Map><<<dim3(splits, NKV, B), DA_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<float*>(part), NH,
      NKV, D, Dv, scale, chunk, map);
  return cudaGetLastError();
}

template <typename QT, typename KT, typename OT, typename Map>
cudaError_t launch_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, void* part, void* out, int B, int NH, int NKV,
                                    int D, int Dv, float scale, int splits, Map map,
                                    cudaStream_t stream) {
  const int G = NH / NKV;
  cudaError_t err =
      G == 1 ? launch_decode_split<QT, KT, 1, Map>(q, k, v, ks, vs, part, B, NH, NKV, D, Dv, scale,
                                                  splits, map, stream)
             : launch_decode_split<QT, KT, DA_MAXG, Map>(q, k, v, ks, vs, part, B, NH, NKV, D, Dv,
                                                        scale, splits, map, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (2 * (size_t)splits * G + G);
  err = cudaFuncSetAttribute(decode_merge_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  decode_merge_kernel<OT><<<dim3(NKV, B), DA_THREADS, smem, stream>>>(
      static_cast<const float*>(part), static_cast<OT*>(out), NH, NKV, Dv, splits);
  return cudaGetLastError();
}

// The attend for one query type, dispatched on the cache's element type.
// `part` holds B · NKV · splits · G · (Dv + 2) floats; splits must be
// decode_splits(capacity).
template <typename QT, typename OT, typename Map>
cudaError_t dispatch_decode_attention(int kv_dtype, const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs, void* part, void* out, int B,
                                      int NH, int NKV, int D, int Dv, float scale, int splits,
                                      long long capacity, Map map, cudaStream_t stream) {
  if (NH % NKV != 0 || NH / NKV > DA_MAXG || D > DA_DMAX || Dv > DA_DMAX || D < 1 || Dv < 1) {
    return cudaErrorInvalidValue;
  }
  if (capacity < 1 || splits != decode_splits(capacity)) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  switch (kv_dtype) {
    case kF32:
      return launch_decode_attention<QT, float, OT, Map>(q, k, v, ks, vs, part, out, B, NH, NKV,
                                                         D, Dv, scale, splits, map, stream);
    case kBF16:
      return launch_decode_attention<QT, __nv_bfloat16, OT, Map>(
          q, k, v, ks, vs, part, out, B, NH, NKV, D, Dv, scale, splits, map, stream);
    case kI8:
      return launch_decode_attention<QT, int8_t, OT, Map>(q, k, v, ks, vs, part, out, B, NH, NKV,
                                                          D, Dv, scale, splits, map, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dsocr
