// Paged slot KV: the one-token write and the one-query decode attention
// through per-row page tables into a shared [P, NKV, page, D] pool of one
// layer.
//
// Replace paged_kv_update (dsocr_tpu/ops/pallas/paged_attention.py:233)
// and paged_decode_attention (:99), and the reference's quantize_kv_int8
// (dsocr_tpu/ops/attention.py:83) that feeds the write. The bodies are
// kv_attention.cuh's, the same as the contiguous slot kernels', with
// PagedRows mapping position t of row b to page tables[b, t / page],
// offset t % page. See ops/kernels/paged_attention.py for what bounds them
// on the H100.
#include "kv_attention.cuh"

extern "C" int dsocr_paged_kv_update(void* k, void* v, void* ks, void* vs, const void* kn,
                                     const void* vn, const void* ksn, const void* vsn,
                                     const void* tables, const void* lengths, int B, int NKV,
                                     int P, int page, int P_max, int D, int Dv, int esize,
                                     void* stream) {
  using namespace dsocr;
  if (page <= 0 || P_max <= 0) return (int)cudaErrorInvalidValue;
  const PagedRows map{static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(tables),
                      NKV, P, page, P_max};
  return (int)launch_kv_write(k, v, ks, vs, kn, vn, ksn, vsn, B, NKV, D, Dv, esize, map,
                              static_cast<cudaStream_t>(stream));
}

// The new token as the decoder leaves it (see dsocr_slot_kv_write), through
// the page tables.
extern "C" int dsocr_paged_kv_write(void* k, void* v, void* ks, void* vs, const void* kn, const void* vn,
                                    const void* tables, const void* lengths, long long kb, long long kh,
                                    long long vb, long long vh, int B, int NKV, int P, int page, int P_max, int D,
                                    int Dv, int in_dtype, int cache_dtype, void* stream) {
  using namespace dsocr;
  if (page <= 0 || P_max <= 0) return (int)cudaErrorInvalidValue;
  const PagedRows map{static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(tables),
                      NKV, P, page, P_max};
  return (int)launch_kv_write_token(k, v, ks, vs, kn, vn, kb, kh, vb, vh, B, NKV, D, Dv, in_dtype, cache_dtype,
                                    map, static_cast<cudaStream_t>(stream));
}

// q f32 [B, NH, D] → out f32 [B, NH * Dv], as the reference's attend.
// part: scratch of B · NKV · splits · G · (Dv + 2) floats, splits =
// ceil(P_max · page / DA_CHUNK) (kv_attention.cuh)
extern "C" int dsocr_paged_decode_attention(const void* q, const void* k, const void* v,
                                            const void* ks, const void* vs, const void* tables,
                                            const void* lengths, void* part, void* out, int B,
                                            int NH, int NKV, int P, int page, int P_max, int D,
                                            int Dv, float scale, int splits, int kv_dtype,
                                            void* stream) {
  using namespace dsocr;
  if (page <= 0 || P_max <= 0) return (int)cudaErrorInvalidValue;
  const PagedRows map{static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(tables),
                      NKV, P, page, P_max};
  return (int)dispatch_decode_attention<float, float>(
      kv_dtype, q, k, v, ks, vs, part, out, B, NH, NKV, D, Dv, scale, splits,
      (long long)P_max * page, map, static_cast<cudaStream_t>(stream));
}
