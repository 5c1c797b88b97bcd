// Continuous-batching slot KV: the one-token write (with the int8
// quantization of the new token, or its conversion) and the one-query
// decode attention over each row's used length, on the contiguous
// [B, NKV, S, D] slot cache of one layer.
//
// Replace slot_kv_update (dsocr_tpu/ops/pallas/slot_attention.py:194) and
// slot_decode_attention (:375), and the reference's quantize_kv_int8
// (dsocr_tpu/ops/attention.py:83) that feeds the write. The bodies are kv_attention.cuh's, with
// SlotRows mapping position t of row b to row (b, h, t). See
// ops/kernels/slot_attention.py for what bounds them on the H100.
#include "kv_attention.cuh"

extern "C" int dsocr_slot_kv_update(void* k, void* v, void* ks, void* vs, const void* kn,
                                    const void* vn, const void* ksn, const void* vsn,
                                    const void* lengths, int B, int NKV, int S, int D, int Dv,
                                    int esize, void* stream) {
  using namespace dsocr;
  const SlotRows map{static_cast<const int32_t*>(lengths), NKV, S};
  return (int)launch_kv_write(k, v, ks, vs, kn, vn, ksn, vsn, B, NKV, D, Dv, esize, map,
                              static_cast<cudaStream_t>(stream));
}

// The new token as the decoder leaves it: k at kn + b·kb + h·kh (and v
// likewise), in_dtype f32 or bf16, quantized in the kernel for an int8
// cache (cache_dtype kI8, ks/vs its scale planes) or converted to the
// cache's type.
extern "C" int dsocr_slot_kv_write(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                                   const void* lengths, long long kb, long long kh, long long vb, long long vh,
                                   int B, int NKV, int S, int D, int Dv, int in_dtype, int cache_dtype,
                                   void* stream) {
  using namespace dsocr;
  const SlotRows map{static_cast<const int32_t*>(lengths), NKV, S};
  return (int)launch_kv_write_token(k, v, ks, vs, kn, vn, kb, kh, vb, vh, B, NKV, D, Dv, in_dtype, cache_dtype,
                                    map, static_cast<cudaStream_t>(stream));
}

// part: scratch of B · NKV · splits · G · (Dv + 2) floats, splits =
// ceil(S / DA_CHUNK) (kv_attention.cuh)
extern "C" int dsocr_slot_decode_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs,
                                           const void* lengths, void* part, void* out, int B,
                                           int NH, int NKV, int S, int D, int Dv, float scale,
                                           int splits, int q_dtype, int kv_dtype, void* stream) {
  using namespace dsocr;
  const SlotRows map{static_cast<const int32_t*>(lengths), NKV, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {  // the output takes q's type
    case kF32:
      return (int)dispatch_decode_attention<float, float>(kv_dtype, q, k, v, ks, vs, part, out, B,
                                                          NH, NKV, D, Dv, scale, splits, S, map,
                                                          st);
    case kBF16:
      return (int)dispatch_decode_attention<__nv_bfloat16, __nv_bfloat16>(
          kv_dtype, q, k, v, ks, vs, part, out, B, NH, NKV, D, Dv, scale, splits, S, map, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
