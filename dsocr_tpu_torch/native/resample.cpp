// Pillow-exact fixed-point bicubic resampler (native host path).
//
// Same algorithm as the NumPy twin in dsocr_tpu_torch/image/resample.py
// (bit-exact with Pillow): 22-bit fixed-point coefficients, C-cast
// round-half-towards-zero window bounds, horizontal-then-vertical
// passes, (acc + 2^21) >> 22 clip8. Also exports a fused
// resize+normalize+CHW kernel so tile preparation avoids the
// PIL->numpy->transpose round trips.
//
// Built at first use by dsocr_tpu_torch/native/resample.py: g++ -O3
// -shared -fPIC -std=c++17 into dsocr_tpu_torch/_build/, bound with
// ctypes (the calls release the GIL, so the engine's prep threads run
// in parallel).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int PRECISION_BITS = 22;
constexpr int64_t ROUNDING_BIAS = 1LL << (PRECISION_BITS - 1);

inline uint8_t clip8(int64_t v) {
    v >>= PRECISION_BITS;
    if (v < 0) return 0;
    if (v > 255) return 255;
    return static_cast<uint8_t>(v);
}

inline double bicubic_kernel(double x) {
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

struct Coeffs {
    std::vector<int> xmin;
    std::vector<int> len;
    std::vector<int32_t> weights;  // [out, ksize]
    int ksize;
};

Coeffs compute_coeffs(int in_size, int out_size) {
    Coeffs c;
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 2.0 * filterscale;
    c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    c.xmin.resize(out_size);
    c.len.resize(out_size);
    c.weights.assign(static_cast<size_t>(out_size) * c.ksize, 0);
    double ss = 1.0 / filterscale;
    std::vector<double> row(c.ksize);
    for (int i = 0; i < out_size; ++i) {
        double center = (i + 0.5) * scale;
        // C-cast truncation toward zero, exactly like Pillow
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        if (xmin >= in_size) xmin = in_size > 0 ? in_size - 1 : 0;
        if (xmax <= xmin) xmax = xmin + 1;
        int len = xmax - xmin;
        double sum = 0.0;
        for (int k = 0; k < len; ++k) {
            double w = bicubic_kernel((xmin + k - center + 0.5) * ss);
            row[k] = w;
            sum += w;
        }
        for (int k = len; k < c.ksize; ++k) row[k] = 0.0;
        if (sum != 0.0) {
            for (int k = 0; k < len; ++k) row[k] /= sum;
        }
        for (int k = 0; k < c.ksize; ++k) {
            double v = row[k] * (1 << PRECISION_BITS);
            c.weights[static_cast<size_t>(i) * c.ksize + k] =
                static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
        }
        c.xmin[i] = xmin;
        c.len[i] = len;
    }
    return c;
}

// Two-pass resize into a caller-provided u8 buffer.
void resize_core(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
    Coeffs cx = compute_coeffs(sw, dw);
    Coeffs cy = compute_coeffs(sh, dh);
    std::vector<uint8_t> horizontal(static_cast<size_t>(sh) * dw * 3);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
        uint8_t* drow = horizontal.data() + static_cast<size_t>(y) * dw * 3;
        for (int x = 0; x < dw; ++x) {
            const int32_t* w = cx.weights.data() + static_cast<size_t>(x) * cx.ksize;
            int start = cx.xmin[x];
            int len = cx.len[x];
            int64_t acc0 = ROUNDING_BIAS, acc1 = ROUNDING_BIAS, acc2 = ROUNDING_BIAS;
            for (int k = 0; k < len; ++k) {
                const uint8_t* p = srow + static_cast<size_t>(start + k) * 3;
                int64_t wk = w[k];
                acc0 += static_cast<int64_t>(p[0]) * wk;
                acc1 += static_cast<int64_t>(p[1]) * wk;
                acc2 += static_cast<int64_t>(p[2]) * wk;
            }
            drow[x * 3 + 0] = clip8(acc0);
            drow[x * 3 + 1] = clip8(acc1);
            drow[x * 3 + 2] = clip8(acc2);
        }
    }
    for (int y = 0; y < dh; ++y) {
        const int32_t* w = cy.weights.data() + static_cast<size_t>(y) * cy.ksize;
        int start = cy.xmin[y];
        int len = cy.len[y];
        uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
        for (int x = 0; x < dw; ++x) {
            int64_t acc0 = ROUNDING_BIAS, acc1 = ROUNDING_BIAS, acc2 = ROUNDING_BIAS;
            for (int k = 0; k < len; ++k) {
                const uint8_t* p =
                    horizontal.data() + (static_cast<size_t>(start + k) * dw + x) * 3;
                int64_t wk = w[k];
                acc0 += static_cast<int64_t>(p[0]) * wk;
                acc1 += static_cast<int64_t>(p[1]) * wk;
                acc2 += static_cast<int64_t>(p[2]) * wk;
            }
            drow[x * 3 + 0] = clip8(acc0);
            drow[x * 3 + 1] = clip8(acc1);
            drow[x * 3 + 2] = clip8(acc2);
        }
    }
}

}  // namespace

extern "C" {

void resize_bicubic_u8(const uint8_t* src, int sh, int sw,
                       uint8_t* dst, int dh, int dw) {
    resize_core(src, sh, sw, dst, dh, dw);
}

// Fused: resize to (dh, dw), then per-channel (x*rescale - mean)/std
// into a CHW float32 buffer (the model-input layout).
void resize_normalize_chw(const uint8_t* src, int sh, int sw,
                          float* dst, int dh, int dw,
                          const float* mean, const float* stddev,
                          float rescale) {
    std::vector<uint8_t> resized(static_cast<size_t>(dh) * dw * 3);
    const uint8_t* pixels = src;
    if (sh != dh || sw != dw) {
        resize_core(src, sh, sw, resized.data(), dh, dw);
        pixels = resized.data();
    }
    const size_t plane = static_cast<size_t>(dh) * dw;
    float inv_std[3] = {1.0f / stddev[0], 1.0f / stddev[1], 1.0f / stddev[2]};
    for (int y = 0; y < dh; ++y) {
        for (int x = 0; x < dw; ++x) {
            const uint8_t* p = pixels + (static_cast<size_t>(y) * dw + x) * 3;
            const size_t idx = static_cast<size_t>(y) * dw + x;
            for (int ch = 0; ch < 3; ++ch) {
                float v = static_cast<float>(p[ch]) * rescale;
                dst[ch * plane + idx] = (v - mean[ch]) * inv_std[ch];
            }
        }
    }
}

}  // extern "C"
