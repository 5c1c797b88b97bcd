// One query-tile flash attention loop on the CUDA cores: the f32 body of
// the decoder prefill (prefill_attention.cu; bf16 runs on wgmma there).
//
// A block owns FT_BQ = 64 queries of one (batch, head) and walks EVERY
// key tile of the sequence with an f32 online softmax. Scores never leave
// shared memory, so no S x S tensor reaches device memory. The math is
// CUDA-core f32 FMAs on operands converted to f32 at load time: a bf16
// product is exact in f32, so this equals a bf16 dot with f32
// accumulation (the JAX kernels' `preferred_element_type=f32`).
//
// Shared memory, in floats: Q tile [64][D+1], one K-or-V tile
// [64][max(D,Dv)+1] (K for the scores, then V for the value sum), the
// score/probability tile [64][65] and the running max / sum / rescale per
// row: about 84 KB at D = 128, so two blocks fit on one SM.
#pragma once

#include <math.h>

#include "common.cuh"

namespace dsocr {

constexpr int FT_BQ = 64;
constexpr int FT_BK = 64;
constexpr int FT_THREADS = 128;
constexpr int FT_DMAX = 128;
constexpr float FT_MASKED = -1e30f;  // the reference's finite mask fill

struct FlashParams {
  const void* q;  // [B, H, S, D]
  const void* k;  // [B, Hkv, S, D]
  const void* v;  // [B, Hkv, S, Dv]
  void* out;      // [B, S, H * Dv]
  const int32_t* pad_start;  // [B] left-pad boundary
  int B, H, Hkv, S, D, Dv;
  float scale;
};

inline size_t flash_smem_bytes(int D, int Dv) {
  const int dkv = (D > Dv ? D : Dv) + 1;
  const size_t floats = (size_t)FT_BQ * (D + 1) + (size_t)FT_BK * dkv +
                        (size_t)FT_BQ * (FT_BK + 1) + 3 * FT_BQ;
  return floats * sizeof(float);
}

// Causal + left-pad mask (kv <= q and kv >= pad_start[b]), scores =
// q.k * scale, masked entries -1e30 (a fully masked row comes out as the
// uniform mean of v over all S keys, as in the reference). Keys at j >= S
// (the ragged last tile) get -inf and weigh exactly 0.
template <typename T>
__global__ void __launch_bounds__(FT_THREADS) flash_tile_kernel(FlashParams p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv, S = p.S;
  const int DQ = D + 1;
  const int DKV = (D > Dv ? D : Dv) + 1;
  float* q_s = smem;                       // [BQ][D+1]
  float* kv_s = q_s + FT_BQ * DQ;          // [BK][DKV]
  float* s_s = kv_s + FT_BK * DKV;         // [BQ][BK+1]
  float* m_s = s_s + FT_BQ * (FT_BK + 1);  // [BQ]
  float* l_s = m_s + FT_BQ;                // [BQ]
  float* a_s = l_s + FT_BQ;                // [BQ]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * FT_BQ;
  const T* q = static_cast<const T*>(p.q) + (size_t)bh * S * D;
  const T* k = static_cast<const T*>(p.k) + (size_t)(b * p.Hkv + hk) * S * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)(b * p.Hkv + hk) * S * Dv;
  const int pad = p.pad_start ? p.pad_start[b] : 0;

  for (int idx = tid; idx < FT_BQ * D; idx += FT_THREADS) {
    const int r = idx / D, d = idx % D;
    q_s[r * DQ + d] = (q0 + r < S) ? to_f32(q[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < FT_BQ) {
    m_s[tid] = FT_MASKED;
    l_s[tid] = 0.f;
  }

  // thread (tx, ty) owns rows ty + 8 i and, for the value sum, columns
  // tx + 16 c; for the scores, key columns tx + 16 c (c < 4)
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += FT_BK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int idx = tid; idx < FT_BK * D; idx += FT_THREADS) {
      const int j = idx / D, d = idx % D;
      kv_s[j * DKV + d] = (k0 + j < S) ? to_f32(k[(size_t)(k0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = q_s[(ty + 8 * i) * DQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = kv_s[(tx + 16 * c) * DKV + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 8 * i, j = tx + 16 * c;
        const int qi = q0 + r, kj = k0 + j;
        float s;
        if (kj >= S) {
          s = -INFINITY;
        } else {
          s = (kj <= qi && kj >= pad) ? sc[i][c] * p.scale : FT_MASKED;
        }
        s_s[r * (FT_BK + 1) + j] = s;
      }
    }
    __syncthreads();

    // online softmax, one thread per query row
    if (tid < FT_BQ) {
      float* row = s_s + tid * (FT_BK + 1);
      float mt = -INFINITY;
      for (int j = 0; j < FT_BK; ++j) mt = fmaxf(mt, row[j]);
      const float m_old = m_s[tid];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int j = 0; j < FT_BK; ++j) {
        const float e = expf(row[j] - m_new);
        row[j] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    // V replaces K in the shared tile (every thread is past the scores)
    for (int idx = tid; idx < FT_BK * Dv; idx += FT_THREADS) {
      const int j = idx / Dv, d = idx % Dv;
      kv_s[j * DKV + d] = (k0 + j < S) ? to_f32(v[(size_t)(k0 + j) * Dv + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = a_s[ty + 8 * i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < FT_BK; ++j) {
      float pv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = s_s[(ty + 8 * i) * (FT_BK + 1) + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int d = tx + 16 * c;
        vv[c] = (d < Dv) ? kv_s[j * DKV + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i, qi = q0 + r;
    if (qi >= S) continue;
    const float l = l_s[r];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx + 16 * c;
      if (d < Dv) out[(((size_t)b * S + qi) * p.H + h) * Dv + d] = from_f32<T>(acc[i][c] / l);
    }
  }
}

template <typename T>
inline cudaError_t launch_flash_tile(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + FT_BQ - 1) / FT_BQ);
  flash_tile_kernel<T><<<grid, FT_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dsocr
