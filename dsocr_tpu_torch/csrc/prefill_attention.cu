// Decoder prefill attention over the prompt's own K/V.
//
// Replaces flash_prefill_attention (dsocr_tpu/ops/pallas/prefill_attention.py:69).
// See ops/kernels/prefill_attention.py for what bounds it on the H100.
#include "flash_tile.cuh"

extern "C" int dsocr_flash_prefill_attention(
    const void* q, const void* k, const void* v, const void* pad_start, void* out,
    int B, int H, int Hkv, int S, int D, int Dv, float scale, int dtype, void* stream) {
  using namespace dsocr;
  if (D > FT_DMAX || Dv > FT_DMAX || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  FlashParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.pad_start = static_cast<const int32_t*>(pad_start);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.D = D;
  p.Dv = Dv;
  p.scale = scale;
  p.width = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = launch_flash_tile<float, false>(p, st);
  } else if (dtype == kBF16) {
    err = launch_flash_tile<__nv_bfloat16, false>(p, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
