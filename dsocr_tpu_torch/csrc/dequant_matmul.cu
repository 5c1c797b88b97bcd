// Q8_0 dequantize-matmul of the routed experts (in-major layout): the C
// entry of q8_gather_matmul and q8_gather_matmul_layered (the gather
// tier: an expert index per selection) and of q8_dense_experts_layered
// and q8_dense_experts_perx_layered (the dense sweeps: no index), in
// dsocr_tpu/ops/pallas/dequant_matmul.py. Both run expert_sweep.cu's body,
// one with the K-quants'. The row layout (q8_matmul, q8_matmul_layered) is
// row_matmul.cu's. See ops/kernels/dequant_matmul.py for what bounds them
// on the H100.
#include "quant_decode.cuh"

extern "C" int dsocr_expert_sweep(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                  const void* idx, void* out, int groups, int R, int K, int M, int E,
                                  long long xg_stride, int x_dtype, void* stream);

// idx null: the dense sweeps (group g's R rows multiply expert g); else
// the gather tier, R 1 (selection g multiplies expert idx[g]; zeros for an
// index outside [0, E))
extern "C" int dsocr_q8_expert_matmul(const void* x, const void* codes, const void* scales,
                                      const void* idx, void* out, int groups, int R, int K,
                                      int M, int E, long long xg_stride, int x_dtype,
                                      void* stream) {
  using namespace dsocr;
  if (K % Q8::SUB != 0 || M % 4 != 0 || groups > 65535 || (R + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (idx == nullptr && groups > E) return (int)cudaErrorInvalidValue;
  return dsocr_expert_sweep(kQ8, x, codes, scales, nullptr, idx, out, groups, R, K, M, E, xg_stride, x_dtype,
                            stream);
}
