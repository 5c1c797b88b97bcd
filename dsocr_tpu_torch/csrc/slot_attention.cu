// Continuous-batching slot KV: the one-token write and the one-query
// decode attention over each row's used length.
//
// Replace slot_kv_update (dsocr_tpu/ops/pallas/slot_attention.py:194) and
// slot_decode_attention (:375). See ops/kernels/slot_attention.py for
// what bounds them on the H100.
#include <math.h>

#include "common.cuh"

namespace dsocr {

// ---- slot_kv_update -------------------------------------------------------
// Grid (B, NKV), one thread per element of D. Copies row b's new token
// (bit for bit, whatever its element type) into position lengths[b] of
// the layer's cache; rows with lengths[b] outside [0, S) write nothing.
template <typename E>
__global__ void slot_kv_update_kernel(E* k, E* v, float* ks, float* vs, const E* kn,
                                      const E* vn, const float* ksn, const float* vsn,
                                      const int32_t* lengths, int NKV, int S, int D,
                                      int Dv) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int pos = lengths[b];
  if (pos < 0 || pos >= S) return;
  const size_t src = (size_t)b * NKV + h;
  const size_t dst = src * S + pos;
  for (int d = threadIdx.x; d < D; d += blockDim.x) k[dst * D + d] = kn[src * D + d];
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) v[dst * Dv + d] = vn[src * Dv + d];
  if (ks != nullptr && threadIdx.x == 0) {
    ks[dst] = ksn[src];
    vs[dst] = vsn[src];
  }
}

// ---- slot_decode_attention ------------------------------------------------
constexpr int SD_TILE = 64;
constexpr int SD_THREADS = 128;
constexpr int SD_MAXG = 8;
constexpr int SD_DMAX = 128;

// Grid (B, NKV). The block loads the G query heads that share KV head h,
// then walks positions [0, lengths[b]] in tiles of 64: f32 scores from a
// K tile staged in shared memory, an online softmax per query head (one
// warp each), and a value sum in which thread d owns output column d.
// Only the used length of the row is read. int8 caches fold their scales
// in as the reference does: k scale after `* scale`, v scale into p after
// l has accumulated p.
template <typename QT, typename KT>
__global__ void __launch_bounds__(SD_THREADS)
    slot_decode_kernel(const QT* q, const KT* k, const KT* v, const float* ks,
                       const float* vs, const int32_t* lengths, QT* out, int NH, int NKV,
                       int S, int D, int Dv, float scale) {
  extern __shared__ float sm[];
  const int G = NH / NKV;
  const int DK = D + 1;
  float* q_s = sm;                  // [G][D]
  float* k_s = q_s + G * D;         // [TILE][D+1]
  float* p_s = k_s + SD_TILE * DK;  // [G][TILE]
  float* m_s = p_s + G * SD_TILE;   // [G]
  float* l_s = m_s + G;             // [G]
  float* a_s = l_s + G;             // [G]

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  int n_pos = lengths[b] + 1;  // attends [0, lengths[b]] inclusive
  n_pos = n_pos < 1 ? 1 : (n_pos > S ? S : n_pos);
  const size_t row = ((size_t)b * NKV + h) * S;
  const KT* kr = k + row * D;
  const KT* vr = v + row * Dv;
  const float* ksr = ks ? ks + row : nullptr;
  const float* vsr = vs ? vs + row : nullptr;

  for (int idx = tid; idx < G * D; idx += SD_THREADS) {
    const int g = idx / D, d = idx % D;
    q_s[idx] = to_f32(q[((size_t)b * NH + h * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[SD_MAXG];
#pragma unroll
  for (int g = 0; g < SD_MAXG; ++g) acc[g] = 0.f;

  for (int t0 = 0; t0 < n_pos; t0 += SD_TILE) {
    const int nt = min(SD_TILE, n_pos - t0);
    __syncthreads();
    for (int idx = tid; idx < SD_TILE * D; idx += SD_THREADS) {
      const int j = idx / D, d = idx % D;
      k_s[j * DK + d] = (j < nt) ? to_f32(kr[(size_t)(t0 + j) * D + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < G * SD_TILE; idx += SD_THREADS) {
      const int g = idx / SD_TILE, j = idx % SD_TILE;
      float s = -1e30f;
      if (j < nt) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[g * D + d], k_s[j * DK + d], dot);
        s = dot * scale;
        if (ksr) s *= ksr[t0 + j];
      }
      p_s[idx] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += SD_THREADS / 32) {
      float* pg = p_s + g * SD_TILE;
      const float s0 = pg[lane], s1 = pg[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float sum = warp_sum(e0 + e1);
      if (vsr) {
        e0 = (lane < nt) ? e0 * vsr[t0 + lane] : 0.f;
        e1 = (lane + 32 < nt) ? e1 * vsr[t0 + lane + 32] : 0.f;
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
      for (int g = 0; g < SD_MAXG; ++g)
        if (g < G) acc[g] *= a_s[g];
      for (int j = 0; j < nt; ++j) {
        const float vv = to_f32(vr[(size_t)(t0 + j) * Dv + tid]);
#pragma unroll
        for (int g = 0; g < SD_MAXG; ++g)
          if (g < G) acc[g] = fmaf(p_s[g * SD_TILE + j], vv, acc[g]);
      }
    }
  }
  __syncthreads();
  if (tid < Dv) {
#pragma unroll
    for (int g = 0; g < SD_MAXG; ++g)
      if (g < G) out[((size_t)b * NH + h * G + g) * Dv + tid] = from_f32<QT>(acc[g] / l_s[g]);
  }
}

template <typename QT, typename KT>
cudaError_t launch_slot_decode(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* lengths, void* out, int B, int NH,
                               int NKV, int S, int D, int Dv, float scale,
                               cudaStream_t stream) {
  const int G = NH / NKV;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)SD_TILE * (D + 1) + (size_t)G * SD_TILE + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      slot_decode_kernel<QT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  slot_decode_kernel<QT, KT><<<dim3(B, NKV), SD_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(lengths), static_cast<QT*>(out), NH, NKV, S, D, Dv, scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* lengths, void* out, int B,
                        int NH, int NKV, int S, int D, int Dv, float scale,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch_slot_decode<QT, float>(q, k, v, ks, vs, lengths, out, B, NH, NKV, S, D,
                                           Dv, scale, stream);
    case kBF16:
      return launch_slot_decode<QT, __nv_bfloat16>(q, k, v, ks, vs, lengths, out, B, NH, NKV,
                                                   S, D, Dv, scale, stream);
    case kI8:
      return launch_slot_decode<QT, int8_t>(q, k, v, ks, vs, lengths, out, B, NH, NKV, S, D,
                                            Dv, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dsocr

extern "C" int dsocr_slot_kv_update(void* k, void* v, void* ks, void* vs, const void* kn,
                                    const void* vn, const void* ksn, const void* vsn,
                                    const void* lengths, int B, int NKV, int S, int D, int Dv,
                                    int esize, void* stream) {
  using namespace dsocr;
  const dim3 grid(B, NKV);
  const int threads = 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ksf = static_cast<float*>(ks);
  float* vsf = static_cast<float*>(vs);
  const float* ksnf = static_cast<const float*>(ksn);
  const float* vsnf = static_cast<const float*>(vsn);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  switch (esize) {
    case 1:
      slot_kv_update_kernel<uint8_t><<<grid, threads, 0, st>>>(
          static_cast<uint8_t*>(k), static_cast<uint8_t*>(v), ksf, vsf,
          static_cast<const uint8_t*>(kn), static_cast<const uint8_t*>(vn), ksnf, vsnf, len,
          NKV, S, D, Dv);
      break;
    case 2:
      slot_kv_update_kernel<uint16_t><<<grid, threads, 0, st>>>(
          static_cast<uint16_t*>(k), static_cast<uint16_t*>(v), ksf, vsf,
          static_cast<const uint16_t*>(kn), static_cast<const uint16_t*>(vn), ksnf, vsnf, len,
          NKV, S, D, Dv);
      break;
    case 4:
      slot_kv_update_kernel<uint32_t><<<grid, threads, 0, st>>>(
          static_cast<uint32_t*>(k), static_cast<uint32_t*>(v), ksf, vsf,
          static_cast<const uint32_t*>(kn), static_cast<const uint32_t*>(vn), ksnf, vsnf, len,
          NKV, S, D, Dv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int dsocr_slot_decode_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs,
                                           const void* lengths, void* out, int B, int NH,
                                           int NKV, int S, int D, int Dv, float scale,
                                           int q_dtype, int kv_dtype, void* stream) {
  using namespace dsocr;
  if (NH % NKV != 0 || NH / NKV > SD_MAXG || D > SD_DMAX || Dv > SD_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  if ((kv_dtype == kI8) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kF32) {
    err = dispatch_kv<float>(kv_dtype, q, k, v, ks, vs, lengths, out, B, NH, NKV, S, D, Dv,
                             scale, st);
  } else if (q_dtype == kBF16) {
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ks, vs, lengths, out, B, NH, NKV, S,
                                     D, Dv, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
