// SAM global attention with the decomposed relative-position bias.
//
// Replaces sam_flash_attention (dsocr_tpu/ops/pallas/sam_attention.py:74).
// See ops/kernels/sam_attention.py for what bounds it on the H100.
#include "flash_tile.cuh"

extern "C" int dsocr_sam_flash_attention(
    const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w,
    void* out, int BH, int S, int D, int kh, int kw, int width, void* stream) {
  using namespace dsocr;
  if (D > FT_DMAX || kh > FT_BQ || kw > FT_BQ || width <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  FlashParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.bias_h = static_cast<const float*>(bias_h);
  p.bias_w = static_cast<const float*>(bias_w);
  p.B = BH;
  p.H = 1;
  p.Hkv = 1;
  p.S = S;
  p.D = D;
  p.Dv = D;
  p.kh = kh;
  p.kw = kw;
  p.width = width;
  p.scale = 1.f;  // q arrives pre-scaled by D^-0.5
  return (int)launch_flash_tile<float, true>(p, static_cast<cudaStream_t>(stream));
}
