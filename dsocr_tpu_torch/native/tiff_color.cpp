// TIFF colour conversions, the host half of image/tiff.py for the two
// photometric interpretations Pillow does not map itself:
//
// - YCbCr (photometric 6) that is not JPEG-compressed in one plane: Pillow
//   hands it to libtiff's TIFFRGBAImage (tif_getimage.c), whose
//   putcontig8bitYCbCr{44,42,41,22,21,12,11}tile read packed data units
//   (the h × v luma samples row by row, then Cb, then Cr), give every
//   pixel of a unit the unit's chroma (no filter), and drop the pixels of
//   the right and bottom units that lie outside the strip or tile; the
//   conversion is tif_color.c's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB, the
//   fixed-point tables built in float from YCbCrCoefficients and
//   ReferenceBlackWhite exactly as libtiff 4.7 builds them. tiff_ycbcr
//   takes data units that are already decoded, whatever their codec.
// - CIELab (photometric 8): Pillow unpacks L, a ^ 128, b ^ 128 ("LAB")
//   and converts to RGB through LittleCMS 2.17 (ImageCms: the built-in
//   Lab v2 profile to the built-in sRGB profile, perceptual intent, 8-bit
//   Lab in, 8-bit RGB out). lcms2 optimizes that transform into a 33³
//   16-bit grid sampled from its floating-point pipeline (Lab → XYZ under
//   D50, the inverse of sRGB's Bradford-adapted matrix, the inverse sRGB
//   curve) and interpolates it tetrahedrally in 16-bit fixed point; the
//   grid here is sampled from the same pipeline with the same float and
//   double roundings (cmslut.c _LUTeval16, cmspcs.c cmsLab2XYZ, cmsgmt.c /
//   cmsvirt.c's profiles, cmsgamma.c's type -4 curve, cmsintrp.c
//   TetrahedralInterp16), so every one of the 2^24 inputs gives Pillow's
//   output.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// -- YCbCr (tif_color.c) ----------------------------------------------------------------------

constexpr int kShift = 16;
constexpr int32_t kOneHalf = 1 << (kShift - 1);

inline int32_t fix(double x) { return (int32_t)(x * (1L << kShift) + 0.5); }

inline float clamp_f(float f, float lo, float hi) { return !(f >= lo) ? lo : (f > hi ? hi : f); }

inline float clamp_w(float f, float lo, float hi) { return f < lo ? lo : (f > hi ? hi : f); }

// Code2V: ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB, or 1)
inline float code2v(int c, float rb, float rw, int cr) {
    const float span = (rw - rb) != 0 ? (rw - rb) : 1.0f;
    return ((float)(c - (int32_t)rb) * (float)cr) / span;
}

struct YccTables {
    int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];

    // 0, or -1 for coefficients or a reference range libtiff's
    // initYCbCrConversion refuses
    int init(const float* luma, const float* ref) {
        if (std::isnan(luma[0]) || std::isnan(luma[1]) || std::fabs(luma[1]) <= FLT_EPSILON || std::isnan(luma[2]))
            return -1;
        for (int i = 0; i < 6; ++i)
            if (!(ref[i] > (float)(-0x7FFFFFFF + 128) && ref[i] < (float)0x7FFFFFFF)) return -1;
        const float f1 = 2 - 2 * luma[0];
        const int32_t d1 = fix(clamp_f(f1, 0.0f, 2.0f));
        const float f2 = luma[0] * f1 / luma[1];
        const int32_t d2 = -fix(clamp_f(f2, 0.0f, 2.0f));
        const float f3 = 2 - 2 * luma[2];
        const int32_t d3 = fix(clamp_f(f3, 0.0f, 2.0f));
        const float f4 = luma[2] * f3 / luma[1];
        const int32_t d4 = -fix(clamp_f(f4, 0.0f, 2.0f));
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            const int32_t cr = (int32_t)clamp_w(code2v(x, ref[4] - 128.0f, ref[5] - 128.0f, 127), -128.0f * 32,
                                                128.0f * 32);
            const int32_t cb = (int32_t)clamp_w(code2v(x, ref[2] - 128.0f, ref[3] - 128.0f, 127), -128.0f * 32,
                                                128.0f * 32);
            cr_r[i] = (int32_t)((d1 * cr + kOneHalf) >> kShift);
            cb_b[i] = (int32_t)((d3 * cb + kOneHalf) >> kShift);
            cr_g[i] = d2 * cr;
            cb_g[i] = d4 * cb + kOneHalf;
            y[i] = (int32_t)clamp_w(code2v(x + 128, ref[0], ref[1], 255), -128.0f * 32, 128.0f * 32);
        }
        return 0;
    }

    // TIFFYCbCrtoRGB
    inline void rgb(int yy, int cb, int cr, uint8_t* o) const {
        auto clamp = [](int32_t v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
        o[0] = clamp(y[yy] + cr_r[cr]);
        o[1] = clamp(y[yy] + (int32_t)((cb_g[cb] + cr_g[cr]) >> kShift));
        o[2] = clamp(y[yy] + cb_b[cb]);
    }
};

// -- CIELab (lcms2) ---------------------------------------------------------------------------

using Mat = double[3][3];

void mat_inverse(const Mat a, Mat b) {  // cmsmtrx.c _cmsMAT3inverse
    const double c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    const double c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0];
    const double c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    const double det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2;
    b[0][0] = c0 / det;
    b[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
    b[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
    b[1][0] = c1 / det;
    b[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
    b[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
    b[2][0] = c2 / det;
    b[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
    b[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
}

void mat_mul(const Mat a, const Mat b, Mat r) {  // _cmsMAT3per
    Mat t;
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) t[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
    std::memcpy(r, t, sizeof(Mat));
}

void mat_eval(const Mat a, const double* v, double* r) {  // _cmsMAT3eval
    for (int i = 0; i < 3; ++i) r[i] = a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2];
}

// _cmsQuickSaturateWord: round half up through lcms2's 16.16 "fast floor"
uint16_t quick_saturate_word(double d) {
    d += 0.5;
    if (d <= 0) return 0;
    if (d >= 65535.0) return 0xffff;
    double t = (d - 32767.0) + 68719476736.0 * 1.5;
    int32_t halves[2];
    std::memcpy(halves, &t, sizeof(t));
    return (uint16_t)((halves[0] >> 16) + 32767);
}

double f_1(double t) {  // cmspcs.c
    const double limit = 24.0 / 116.0;
    if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
    return t * t * t;
}

struct LabGrid {
    static constexpr int kPoints = 33;
    uint16_t table[kPoints * kPoints * kPoints * 3];

    LabGrid() {
        const double d50[3] = {0.9642, 1.0, 0.8249};
        // cmsCreate_sRGBProfile: Rec. 709 primaries, D65, adapted to D50 by Bradford
        const double xn = 0.3127, yn = 0.3290;
        const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15, yb = 0.06;
        const Mat primaries = {{xr, xg, xb}, {yr, yg, yb}, {(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)}};
        Mat inv_primaries;
        mat_inverse(primaries, inv_primaries);
        const double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
        double coef[3];
        mat_eval(inv_primaries, white, coef);
        Mat rgb2xyz = {{coef[0] * xr, coef[1] * xg, coef[2] * xb},
                       {coef[0] * yr, coef[1] * yg, coef[2] * yb},
                       {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)}};
        const Mat bradford = {{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367}, {0.0389, -0.0685, 1.0296}};
        Mat bradford_inv;
        mat_inverse(bradford, bradford_inv);
        const double source[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};  // cmsxyY2XYZ
        double cone_src[3], cone_dst[3];
        mat_eval(bradford, source, cone_src);
        mat_eval(bradford, d50, cone_dst);
        const Mat cone = {{cone_dst[0] / cone_src[0], 0.0, 0.0},
                          {0.0, cone_dst[1] / cone_src[1], 0.0},
                          {0.0, 0.0, cone_dst[2] / cone_src[2]}};
        Mat tmp, adapt;
        mat_mul(cone, bradford, tmp);
        mat_mul(bradford_inv, tmp, adapt);
        mat_mul(adapt, rgb2xyz, rgb2xyz);
        // BuildRGBOutputMatrixShaper: the inverse, scaled by the 1.15 XYZ encoding
        const double max_encodeable = 1.0 + 32767.0 / 32768.0;
        Mat out;
        mat_inverse(rgb2xyz, out);
        for (auto& row : out)
            for (double& v : row) v *= max_encodeable;
        // the sRGB curve (type 4) reversed: cmsgamma.c type -4
        const double g = 2.4, a = 1. / 1.055, b = 0.055 / 1.055, c = 1. / 12.92, d = 0.04045;
        const double disc = std::pow(a * d + b, g);
        for (int i = 0; i < kPoints; ++i)
            for (int j = 0; j < kPoints; ++j)
                for (int k = 0; k < kPoints; ++k) {
                    const int node[3] = {i, j, k};
                    float in[3];
                    for (int t = 0; t < 3; ++t)  // _cmsQuantizeVal, then _LUTeval16's float input
                        in[t] = (float)quick_saturate_word(((double)node[t] * 65535.) / (double)(kPoints - 1)) /
                                65535.0F;
                    // EvaluateLab2XYZ (v4 encoding)
                    const double L = in[0] * 100.0, la = in[1] * 255.0 - 128.0, lb = in[2] * 255.0 - 128.0;
                    const double fy = (L + 16.0) / 116.0, fx = fy + 0.002 * la, fz = fy - 0.005 * lb;
                    const double xyz[3] = {f_1(fx) * d50[0], f_1(fy) * d50[1], f_1(fz) * d50[2]};
                    float enc[3], lin[3];
                    for (int t = 0; t < 3; ++t) enc[t] = (float)(xyz[t] / max_encodeable);
                    for (int t = 0; t < 3; ++t) {  // EvaluateMatrix
                        double acc = 0;
                        for (int s = 0; s < 3; ++s) acc += enc[s] * out[t][s];
                        lin[t] = (float)acc;
                    }
                    uint16_t* cell = table + ((i * kPoints + j) * kPoints + k) * 3;
                    for (int t = 0; t < 3; ++t) {
                        const double r = lin[t];
                        const double v = r >= disc ? (std::pow(r, 1.0 / g) - b) / a : r / c;
                        cell[t] = quick_saturate_word((double)(float)v * 65535.0);
                    }
                }
    }

    // TetrahedralInterp16 on 16-bit inputs
    void interp(const uint16_t* input, uint16_t* output) const {
        auto to_fixed = [](int a) { return a + ((a + 0x7fff) / 0xffff); };
        const int fx = to_fixed(input[0] * (kPoints - 1)), fy = to_fixed(input[1] * (kPoints - 1)),
                  fz = to_fixed(input[2] * (kPoints - 1));
        const int x0 = fx >> 16, y0 = fy >> 16, z0 = fz >> 16;
        const int32_t rx = fx & 0xffff, ry = fy & 0xffff, rz = fz & 0xffff;
        const int oz = 3, oy = 3 * kPoints, ox = 3 * kPoints * kPoints;
        int X1 = input[0] == 0xffff ? 0 : ox, Y1 = input[1] == 0xffff ? 0 : oy, Z1 = input[2] == 0xffff ? 0 : oz;
        const uint16_t* lut = table + x0 * ox + y0 * oy + z0 * oz;
        // which vertices to walk, and the weight of each edge, as in the six cases of the C code
        int v1, v2, v3;
        int32_t w1, w2, w3;
        if (rx >= ry) {
            if (ry >= rz) {
                v1 = X1; v2 = X1 + Y1; v3 = X1 + Y1 + Z1; w1 = rx; w2 = ry; w3 = rz;
            } else if (rz >= rx) {
                v1 = Z1; v2 = X1 + Z1; v3 = X1 + Y1 + Z1; w1 = rz; w2 = rx; w3 = ry;
            } else {
                v1 = X1; v2 = X1 + Z1; v3 = X1 + Y1 + Z1; w1 = rx; w2 = rz; w3 = ry;
            }
        } else {
            if (rx >= rz) {
                v1 = Y1; v2 = X1 + Y1; v3 = X1 + Y1 + Z1; w1 = ry; w2 = rx; w3 = rz;
            } else if (ry >= rz) {
                v1 = Y1; v2 = Y1 + Z1; v3 = X1 + Y1 + Z1; w1 = ry; w2 = rz; w3 = rx;
            } else {
                v1 = Z1; v2 = Y1 + Z1; v3 = X1 + Y1 + Z1; w1 = rz; w2 = ry; w3 = rx;
            }
        }
        for (int t = 0; t < 3; ++t) {
            const int32_t c0 = lut[t], c1 = lut[v1 + t], c2 = lut[v2 + t], c3 = lut[v3 + t];
            // 32-bit products and sum, wrapping as the C code's int arithmetic does
            const int32_t rest = (int32_t)((uint32_t)(c1 - c0) * (uint32_t)w1 + (uint32_t)(c2 - c1) * (uint32_t)w2 +
                                           (uint32_t)(c3 - c2) * (uint32_t)w3 + 0x8001u);
            output[t] = (uint16_t)(c0 + ((rest + (rest >> 16)) >> 16));
        }
    }
};

}  // namespace

extern "C" {

// Packed YCbCr data units of one strip or tile → RGB. `units`: `size`
// bytes of data units, each hs·vs luma samples then Cb and Cr: ceil(rows
// / vs) unit rows of ceil(width / hs) units, each row followed by `skip`
// units (the units of a tile past the image's right edge). libtiff skips
// those as (skip · (hs·vs + 2)) bytes, but for 4×4 units, where
// putcontig8bitYCbCr44tile skips (skip · 10): so does this. `out`: rows
// × width × 3. `luma`: YCbCrCoefficients, `ref`: ReferenceBlackWhite (as
// floats). Returns 0, 1 for subsampling libtiff has no routine for, 2
// for coefficients or a reference range it refuses, 3 for units that end
// before the block.
int tiff_ycbcr(const uint8_t* units, int64_t size, int width, int rows, int hs, int vs, int skip, const float* luma,
               const float* ref, uint8_t* out) {
    const int code = (hs << 4) | vs;
    if (code != 0x44 && code != 0x42 && code != 0x41 && code != 0x22 && code != 0x21 && code != 0x12 && code != 0x11)
        return 1;
    YccTables t;
    if (t.init(luma, ref)) return 2;
    const int64_t across = (width + hs - 1) / hs, unit = hs * vs + 2;
    const int64_t stride = across * unit + (int64_t)skip * (code == 0x44 ? 10 : unit);
    const int64_t unit_rows = (rows + vs - 1) / vs;
    if (rows > 0 && (unit_rows - 1) * stride + across * unit > size) return 3;
    for (int y = 0; y < rows; ++y) {
        const uint8_t* row_units = units + (int64_t)(y / vs) * stride;
        const int dy = (y % vs) * hs;
        uint8_t* o = out + (int64_t)y * width * 3;
        for (int x = 0; x < width; ++x, o += 3) {
            const uint8_t* u = row_units + (int64_t)(x / hs) * unit;
            t.rgb(u[dy + x % hs], u[hs * vs], u[hs * vs + 1], o);
        }
    }
    return 0;
}

// Pillow's LAB pixels (L, a ^ 128, b ^ 128), n of them, 3 bytes each →
// RGB through the lcms2 transform ImageCms builds.
int tiff_lab(const uint8_t* lab, int64_t n, uint8_t* out) {
    static const LabGrid grid;
    for (int64_t i = 0; i < n; ++i) {
        const uint16_t in[3] = {(uint16_t)(lab[3 * i] * 257), (uint16_t)(lab[3 * i + 1] * 257),
                                (uint16_t)(lab[3 * i + 2] * 257)};
        uint16_t rgb[3];
        grid.interp(in, rgb);
        for (int t = 0; t < 3; ++t) out[3 * i + t] = (uint8_t)(((uint32_t)rgb[t] * 65281u + 8388608u) >> 24);
    }
    return 0;
}

}  // extern "C"
