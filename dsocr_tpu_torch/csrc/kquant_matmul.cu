// K-quant (Q4_K, Q6_K) dequantize-matmul of the routed experts (in-major
// layout): the C entries of q4k_gather_matmul, q4k_gather_matmul_layered,
// q6k_gather_matmul and q6k_gather_matmul_layered (the gather tier: an
// expert index per selection) and of q4k_dense_experts_layered,
// q4k_dense_experts_perx_layered and their q6k_ counterparts (the dense
// sweeps: no index), in dsocr_tpu/ops/pallas/kquant_matmul.py. All run
// expert_sweep.cu's body, one with Q8_0's. The row layout (q4k_matmul,
// q6k_matmul and their _layered forms) is row_matmul.cu's. See
// ops/kernels/kquant_matmul.py for the layouts and for what bounds them on
// the H100.
#include "quant_decode.cuh"

extern "C" int dsocr_expert_sweep(int fmt, const void* x, const void* p0, const void* p1, const void* p2,
                                  const void* idx, void* out, int groups, int R, int K, int M, int E,
                                  long long xg_stride, int x_dtype, void* stream);

namespace {

// idx null: the dense sweeps (group g's R rows multiply expert g); else
// the gather tier, R 1 (selection g multiplies expert idx[g]; zeros for an
// index outside [0, E))
int expert_entry(int fmt, const void* x, const void* p0, const void* p1, const void* p2, const void* idx,
                 void* out, int groups, int R, int K, int M, int E, long long xg_stride, int x_dtype,
                 void* stream) {
  if (K % 256 != 0 || M % 4 != 0 || groups > 65535 || (R + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (idx == nullptr && groups > E) return (int)cudaErrorInvalidValue;
  return dsocr_expert_sweep(fmt, x, p0, p1, p2, idx, out, groups, R, K, M, E, xg_stride, x_dtype, stream);
}

}  // namespace

extern "C" int dsocr_q4k_expert_matmul(const void* x, const void* codes, const void* scales,
                                       const void* mins, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  return expert_entry(dsocr::kQ4K, x, codes, scales, mins, idx, out, groups, R, K, M, E, xg_stride, x_dtype,
                      stream);
}

extern "C" int dsocr_q6k_expert_matmul(const void* x, const void* codes, const void* highs,
                                       const void* scales, const void* idx, void* out, int groups,
                                       int R, int K, int M, int E, long long xg_stride,
                                       int x_dtype, void* stream) {
  return expert_entry(dsocr::kQ6K, x, codes, highs, scales, idx, out, groups, R, K, M, E, xg_stride, x_dtype,
                      stream);
}
