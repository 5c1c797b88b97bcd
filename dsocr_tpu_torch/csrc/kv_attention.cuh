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
// One body serves both caches, so a later split-K redesign of the attend
// serves both too.
#pragma once

#include <math.h>

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
// Grid (B, NKV), one thread per element of D. Copies row b's new token (bit
// for bit, whatever its element type: E is an unsigned type of its size)
// into the cache row that holds position lengths[b]; a row that holds no
// such position writes nothing.
template <typename E, typename Map>
__global__ void kv_write_kernel(E* k, E* v, float* ks, float* vs, const E* kn, const E* vn,
                                const float* ksn, const float* vsn, int NKV, int D, int Dv,
                                Map map) {
  const int b = blockIdx.x, h = blockIdx.y;
  const long long dst = map.row(b, h, map.lengths[b]);
  if (dst < 0) return;
  const size_t src = (size_t)b * NKV + h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) k[dst * D + d] = kn[src * D + d];
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) v[dst * Dv + d] = vn[src * Dv + d];
  if (ks != nullptr && threadIdx.x == 0) {
    ks[dst] = ksn[src];
    vs[dst] = vsn[src];
  }
}

template <typename Map>
cudaError_t launch_kv_write(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                            const void* ksn, const void* vsn, int B, int NKV, int D, int Dv,
                            int esize, Map map, cudaStream_t st) {
  const dim3 grid(B, NKV);
  const int threads = 128;
  float* ksf = static_cast<float*>(ks);
  float* vsf = static_cast<float*>(vs);
  const float* ksnf = static_cast<const float*>(ksn);
  const float* vsnf = static_cast<const float*>(vsn);
  switch (esize) {
    case 1:
      kv_write_kernel<uint8_t, Map><<<grid, threads, 0, st>>>(
          static_cast<uint8_t*>(k), static_cast<uint8_t*>(v), ksf, vsf,
          static_cast<const uint8_t*>(kn), static_cast<const uint8_t*>(vn), ksnf, vsnf, NKV, D,
          Dv, map);
      break;
    case 2:
      kv_write_kernel<uint16_t, Map><<<grid, threads, 0, st>>>(
          static_cast<uint16_t*>(k), static_cast<uint16_t*>(v), ksf, vsf,
          static_cast<const uint16_t*>(kn), static_cast<const uint16_t*>(vn), ksnf, vsnf, NKV, D,
          Dv, map);
      break;
    case 4:
      kv_write_kernel<uint32_t, Map><<<grid, threads, 0, st>>>(
          static_cast<uint32_t*>(k), static_cast<uint32_t*>(v), ksf, vsf,
          static_cast<const uint32_t*>(kn), static_cast<const uint32_t*>(vn), ksnf, vsnf, NKV, D,
          Dv, map);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- the decode attend ------------------------------------------------------
constexpr int DA_TILE = 64;
constexpr int DA_THREADS = 128;
constexpr int DA_MAXG = 8;
constexpr int DA_DMAX = 128;

// Grid (B, NKV). The block loads the G query heads that share KV head h,
// then walks positions [0, n_pos(b)) in tiles of up to 64 consecutive
// cache rows (a tile ends where the map's run does: at a page boundary for
// pages under 64): f32 scores against a K tile staged in shared memory,
// an online softmax per query head (one warp each), and a value sum in
// which thread d owns output column d. Only the positions the row attends
// are read; a tile the row holds no page for is skipped, and a row with
// none at all gets zeros. int8 caches fold their scales in as the
// reference does: k scale after `* scale`, v scale into p after l has
// accumulated p.
template <typename QT, typename KT, typename OT, typename Map>
__global__ void __launch_bounds__(DA_THREADS)
    decode_attention_kernel(const QT* q, const KT* k, const KT* v, const float* ks,
                            const float* vs, OT* out, int NH, int NKV, int D, int Dv, float scale,
                            Map map) {
  extern __shared__ float sm[];
  const int G = NH / NKV;
  const int DK = D + 1;
  float* q_s = sm;                  // [G][D]
  float* k_s = q_s + G * D;         // [TILE][D+1]
  float* p_s = k_s + DA_TILE * DK;  // [G][TILE]
  float* m_s = p_s + G * DA_TILE;   // [G]
  float* l_s = m_s + G;             // [G]
  float* a_s = l_s + G;             // [G]

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_pos = map.n_pos(b);

  for (int idx = tid; idx < G * D; idx += DA_THREADS) {
    const int g = idx / D, d = idx % D;
    q_s[idx] = to_f32(q[((size_t)b * NH + h * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[DA_MAXG];
#pragma unroll
  for (int g = 0; g < DA_MAXG; ++g) acc[g] = 0.f;

  for (int t0 = 0; t0 < n_pos;) {
    const long long base = map.row(b, h, t0);
    const int nt = min(min(DA_TILE, n_pos - t0), map.run(t0));
    t0 += nt;
    if (base < 0) continue;  // no page holds these positions: nothing to read
    const KT* kt = k + base * D;
    const KT* vt = v + base * Dv;
    const float* kst = ks ? ks + base : nullptr;
    const float* vst = vs ? vs + base : nullptr;
    __syncthreads();
    for (int idx = tid; idx < DA_TILE * D; idx += DA_THREADS) {
      const int j = idx / D, d = idx % D;
      k_s[j * DK + d] = (j < nt) ? to_f32(kt[(size_t)j * D + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < G * DA_TILE; idx += DA_THREADS) {
      const int g = idx / DA_TILE, j = idx % DA_TILE;
      float s = -1e30f;
      if (j < nt) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[g * D + d], k_s[j * DK + d], dot);
        s = dot * scale;
        if (kst) s *= kst[j];
      }
      p_s[idx] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += DA_THREADS / 32) {
      float* pg = p_s + g * DA_TILE;
      const float s0 = pg[lane], s1 = pg[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));  // finite: the tile holds a key
      float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float sum = warp_sum(e0 + e1);
      if (vst) {
        e0 = (lane < nt) ? e0 * vst[lane] : 0.f;
        e1 = (lane + 32 < nt) ? e1 * vst[lane + 32] : 0.f;
      }
      pg[lane] = e0;
      pg[lane + 32] = e1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    if (tid < Dv) {
#pragma unroll
      for (int g = 0; g < DA_MAXG; ++g)
        if (g < G) acc[g] *= a_s[g];
      for (int j = 0; j < nt; ++j) {
        const float vv = to_f32(vt[(size_t)j * Dv + tid]);
#pragma unroll
        for (int g = 0; g < DA_MAXG; ++g)
          if (g < G) acc[g] = fmaf(p_s[g * DA_TILE + j], vv, acc[g]);
      }
    }
  }
  __syncthreads();
  if (tid < Dv) {
#pragma unroll
    for (int g = 0; g < DA_MAXG; ++g) {
      if (g < G) {
        const float l = l_s[g];
        out[((size_t)b * NH + h * G + g) * Dv + tid] = from_f32<OT>(l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

template <typename QT, typename KT, typename OT, typename Map>
cudaError_t launch_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, void* out, int B, int NH, int NKV, int D,
                                    int Dv, float scale, Map map, cudaStream_t stream) {
  const int G = NH / NKV;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)DA_TILE * (D + 1) + (size_t)G * DA_TILE + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<QT, KT, OT, Map>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<QT, KT, OT, Map><<<dim3(B, NKV), DA_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<OT*>(out), NH, NKV,
      D, Dv, scale, map);
  return cudaGetLastError();
}

// The attend for one query type, dispatched on the cache's element type.
template <typename QT, typename OT, typename Map>
cudaError_t dispatch_decode_attention(int kv_dtype, const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs, void* out, int B, int NH,
                                      int NKV, int D, int Dv, float scale, Map map,
                                      cudaStream_t stream) {
  if (NH % NKV != 0 || NH / NKV > DA_MAXG || D > DA_DMAX || Dv > DA_THREADS) {
    return cudaErrorInvalidValue;
  }
  if ((kv_dtype == kI8) != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  switch (kv_dtype) {
    case kF32:
      return launch_decode_attention<QT, float, OT, Map>(q, k, v, ks, vs, out, B, NH, NKV, D, Dv,
                                                         scale, map, stream);
    case kBF16:
      return launch_decode_attention<QT, __nv_bfloat16, OT, Map>(q, k, v, ks, vs, out, B, NH, NKV,
                                                                 D, Dv, scale, map, stream);
    case kI8:
      return launch_decode_attention<QT, int8_t, OT, Map>(q, k, v, ks, vs, out, B, NH, NKV, D, Dv,
                                                          scale, map, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dsocr
