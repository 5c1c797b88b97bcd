// JPEG decoding (ITU-T T.81), the host half of image/decode.py's JPEG
// decoder: Huffman entropy decoding of sequential (SOF0/SOF1) and
// progressive (SOF2) scans into whole-image coefficient planes, then the
// output pass: dequantization, the `islow` inverse DCT, upsampling and
// color conversion into an (H, W, 3) uint8 buffer, or the components'
// samples as they are (libjpeg's raw data, for old-style JPEG-in-TIFF).
// decode.py parses the markers and calls jpeg_scan once per SOS and
// jpeg_output after EOI.
//
// Every step reproduces libjpeg-turbo's defaults as Pillow leaves them
// (JDCT_ISLOW, fancy upsampling, no merged upsampler, no DCT scaling), so
// the pixels are bit-equal to Pillow's convert("RGB"):
// - the entropy decoder follows jdhuff.c/jdphuff.c on damaged data too:
//   past a marker the bit reader returns zeros, the rest of the restart
//   interval is left as it is, and a restart marker out of sequence is
//   resynchronised with jpeg_resync_to_restart's rules;
// - the IDCT is jidctint.c's `islow` (13 constant bits, 2 bits kept after
//   pass 1) in the 16-bit lanes of libjpeg-turbo's x86 SIMD version, which
//   Pillow runs on x86-64 (see idct_islow);
// - YCbCr -> RGB uses jdcolor.c's 16-bit fixed-point tables;
// - the upsamplers are jdsample.c's: h2v1 and h2v2 "fancy" (triangle
//   filter, rounding biases alternating by column and row) when the
//   component is wider than 2 samples, h1v2 fancy, and a box for every
//   other integer ratio; edges lie at the component's downsampled size;
// - CMYK follows Pillow: libjpeg's CMYK (YCCK first converted), read with
//   rawmode "CMYK;I" (inverted), then Pillow's CMYK -> RGB.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// zigzag -> natural order; the 16 extra entries absorb a corrupt run
// past the 64th coefficient as libjpeg's table does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 9;  // bits resolved by one table lookup

struct Huff {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t look[1 << kLook];  // (length << 8) | symbol; length 0: longer than kLook bits
};

// jdhuff.c's jpeg_make_d_derived_tbl: `spec` holds the 16 counts then
// the symbols. Returns false for a table that is not a Huffman code.
bool build_huff(const uint8_t* spec, bool dc, Huff& h) {
    int sizes[257], codes[256], n = 0;
    for (int l = 1; l <= 16; ++l) {
        const int count = spec[l - 1];
        if (n + count > 256) return false;
        for (int i = 0; i < count; ++i) sizes[n++] = l;
    }
    sizes[n] = 0;
    int code = 0, si = sizes[0], p = 0;
    while (sizes[p]) {
        while (sizes[p] == si) codes[p++] = code++;
        if (code >= (1 << si)) return false;  // no code may be all ones
        code <<= 1;
        ++si;
    }
    std::memcpy(h.vals, spec + 16, 256);
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (spec[l - 1]) {
            h.valoffset[l] = p - codes[p];
            p += spec[l - 1];
            h.maxcode[l] = codes[p - 1];
        } else {
            h.maxcode[l] = -1;
        }
    }
    h.valoffset[17] = 0;
    h.maxcode[17] = 0xFFFFF;  // the sentinel a corrupt code runs into
    std::memset(h.look, 0, sizeof(h.look));
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
        for (int i = 0; i < spec[l - 1]; ++i, ++p) {
            const int base = codes[p] << (kLook - l);
            for (int j = 0; j < (1 << (kLook - l)); ++j) h.look[base + j] = (uint16_t)((l << 8) | h.vals[p]);
        }
    }
    if (dc) {
        for (int i = 0; i < n; ++i)
            if (h.vals[i] > 15) return false;
    }
    return true;
}

// The bit reader of jdhuff.c: bytes are read until a marker, FF00 is a
// data FF, FF fill bytes before a marker are skipped; once a marker (or
// the end of the data) is reached the reader supplies zero bits, and
// consuming one of them sets `insufficient`, libjpeg's out-of-data flag.
struct Reader {
    const uint8_t* data;
    int64_t size, pos;
    const int64_t* pieces = nullptr;  // (offset, length) stretches of `data` read after [pos, size)
    int64_t npieces = 0;
    uint64_t buf = 0;
    int bits = 0, pad = 0;  // bits held; the lowest `pad` of them are zero fill
    int marker = 0;         // the marker code that stopped the reader, 0 if none
    int64_t marker_at = 0;  // the offset of the FF before that code
    bool insufficient = false, eof = false;

    // Whether a byte is left, going on to the next piece where one ends.
    inline bool more() {
        while (pos >= size) {
            if (npieces == 0) return false;
            pos = pieces[0];
            size = pieces[0] + pieces[1];
            pieces += 2;
            --npieces;
        }
        return true;
    }
    void fill() {
        while (bits <= 56) {
            int c;
            if (marker || eof) {
                c = 0;
                pad += 8;
            } else if (!more()) {
                eof = true;
                continue;
            } else {
                c = data[pos++];
                if (c == 0xFF) {
                    int c2;
                    do {
                        if (!more()) {
                            eof = true;
                            break;
                        }
                        c2 = data[pos++];
                    } while (c2 == 0xFF);
                    if (eof) continue;
                    if (c2 != 0) {
                        marker = c2;
                        marker_at = pos - 2;
                        continue;
                    }
                }
            }
            buf = (buf << 8) | (uint64_t)c;
            bits += 8;
        }
    }
    inline void need(int n) {
        if (bits < n) fill();
    }
    inline int peek(int n) const { return (int)((buf >> (bits - n)) & ((1u << n) - 1)); }
    inline void skip(int n) {
        bits -= n;
        if (bits < pad) {
            pad = bits;
            insufficient = true;
        }
    }
    inline int get(int n) {  // n <= 25 after need(n)
        if (n == 0) return 0;
        need(n);
        const int v = peek(n);
        skip(n);
        return v;
    }
    // Skip to the next marker (jdmarker.c's next_marker) unless one is
    // pending. Returns false at the end of the data.
    bool next_marker() {
        if (marker) return true;
        for (;;) {
            if (!more()) return false;
            const void* ff = std::memchr(data + pos, 0xFF, (size_t)(size - pos));
            if (!ff) {
                pos = size;
                continue;
            }
            pos = (const uint8_t*)ff - data + 1;
            while (more() && data[pos] == 0xFF) ++pos;
            if (!more()) return false;
            const int c = data[pos++];
            if (c != 0) {
                marker = c;
                marker_at = pos - 2;
                return true;
            }
        }
    }
};

inline int decode(Reader& r, const Huff& h) {
    r.need(32);
    const int look = h.look[r.peek(kLook)];
    if (look >> 8) {
        r.skip(look >> 8);
        return look & 0xFF;
    }
    // jpeg_huff_decode: one more bit at a time; a code past 16 bits reads 17 and gives 0
    int l = kLook + 1;
    int32_t code = r.peek(l);
    while (code > h.maxcode[l]) {
        ++l;
        code = r.peek(l);
        if (l == 17) break;
    }
    r.skip(l);
    if (l > 16) return 0;
    return h.vals[(code + h.valoffset[l]) & 0xFF];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct ScanComp {
    int16_t* coefs;   // the component's plane: rows of `stride` blocks of 64
    int h, v, stride; // sampling factors, blocks a row in the plane
    int nbx, nby;     // blocks a non-interleaved scan walks
    Huff dc, ac;
};

enum Status { kOk = 0, kTruncated = 1, kBadTable = 2, kBadCoef = 3 };

}  // namespace

extern "C" {

// One scan. `start`: the offset of the first entropy-coded byte. `p`:
// progressive, scan components, Ss, Se, Ah, Al, restart interval, MCUs a
// row and MCU rows of the frame, then per scan component: frame component
// index, h, v, plane stride in blocks, nbx, nby. `tables`: per scan
// component the DC then the AC table, each 16 counts and 256 symbols.
// `offsets`: each frame component's first coefficient in `coefs`.
// `out`: the offset where marker parsing resumes, the MCU that failed or
// the count of MCUs, the data bits left unread (below), and the first MCU
// whose restart marker was not the one due (-1 if none: libjpeg's
// resync_to_restart, which tif_ojpeg.c turns into an error). `pieces`:
// `npieces` (offset, length) stretches of `data` read after [start,
// size), as one stream (old-style JPEG-in-TIFF's strips, read in place);
// the offsets in `out` are then those in `data`, and the bits left count
// to the end of the last piece read.
int jpeg_scan(const uint8_t* data, int64_t size, int64_t start, const int32_t* p, const uint8_t* tables,
              int16_t* coefs, const int64_t* offsets, int64_t* out, char* msg, int msglen, const int64_t* pieces,
              int64_t npieces) {
    const int progressive = p[0], ns = p[1], Ss = p[2], Se = p[3], Ah = p[4], Al = p[5], interval = p[6];
    const int mcus_x = p[7], mcus_y = p[8];
    std::vector<ScanComp> comps(ns);
    const bool dc_scan = !progressive || Ss == 0;
    for (int i = 0; i < ns; ++i) {
        const int32_t* q = p + 9 + 6 * i;
        ScanComp& c = comps[i];
        c.coefs = coefs + offsets[q[0]];
        c.h = q[1];
        c.v = q[2];
        c.stride = q[3];
        c.nbx = q[4];
        c.nby = q[5];
        const uint8_t* spec = tables + (size_t)i * 2 * 272;
        const bool need_dc = dc_scan && !(progressive && Ah), need_ac = !progressive || Ss > 0;
        if ((need_dc && !build_huff(spec, true, c.dc)) || (need_ac && !build_huff(spec + 272, false, c.ac))) {
            std::snprintf(msg, msglen, "bad Huffman table for scan component %d", i);
            out[0] = start;
            out[1] = 0;
            return kBadTable;
        }
    }
    Reader r{data, size, start, pieces, npieces};
    out[3] = -1;
    int32_t last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0, next_rst = 0;
    bool cut = false;  // the data ended where a restart marker was due
    const int64_t total = ns == 1 ? (int64_t)comps[0].nbx * comps[0].nby : (int64_t)mcus_x * mcus_y;
    const int p1 = 1 << Al, m1 = -(1 << Al);

    int64_t m = 0;
    for (; m < total; ++m) {
        if (interval && m > 0 && m % interval == 0) {
            // process_restart + read_restart_marker + jpeg_resync_to_restart
            r.bits = r.pad = 0;
            r.buf = 0;
            if (!r.next_marker()) {
                cut = true;
                break;
            }
            if (r.marker == 0xD0 + next_rst) {
                r.marker = 0;
            } else {
                if (out[3] < 0) out[3] = m;
                for (;;) {
                    const int mk = r.marker;
                    int action;
                    if (mk < 0xC0) {
                        action = 2;
                    } else if (mk < 0xD0 || mk > 0xD7) {
                        action = 3;
                    } else if (mk == 0xD0 + ((next_rst + 1) & 7) || mk == 0xD0 + ((next_rst + 2) & 7)) {
                        action = 3;
                    } else if (mk == 0xD0 + ((next_rst - 1) & 7) || mk == 0xD0 + ((next_rst - 2) & 7)) {
                        action = 2;
                    } else {
                        action = 1;
                    }
                    if (action == 1) {
                        r.marker = 0;
                        break;
                    }
                    if (action == 3) break;
                    r.marker = 0;
                    if (!r.next_marker()) {
                        cut = true;
                        break;
                    }
                }
                if (cut) break;
            }
            next_rst = (next_rst + 1) & 7;
            last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
            eobrun = 0;
            if (r.marker == 0) r.insufficient = false;
        }
        if (r.insufficient) continue;  // the rest of the interval is left as it is

        // the blocks of MCU m
        int16_t* blocks[10];
        int owner[10], nb = 0;
        if (ns == 1) {
            const ScanComp& c = comps[0];
            const int64_t by = m / c.nbx, bx = m % c.nbx;
            blocks[nb] = c.coefs + (by * c.stride + bx) * 64;
            owner[nb++] = 0;
        } else {
            const int64_t my = m / mcus_x, mx = m % mcus_x;
            for (int i = 0; i < ns; ++i) {
                const ScanComp& c = comps[i];
                for (int yy = 0; yy < c.v; ++yy)
                    for (int xx = 0; xx < c.h; ++xx) {
                        blocks[nb] = c.coefs + ((my * c.v + yy) * c.stride + mx * c.h + xx) * 64;
                        owner[nb++] = i;
                    }
            }
        }

        for (int b = 0; b < nb; ++b) {
            int16_t* blk = blocks[b];
            const ScanComp& c = comps[owner[b]];
            if (!progressive) {
                int s = decode(r, c.dc);
                if (s) s = extend(r.get(s), s);
                last_dc[owner[b]] = (int32_t)((uint32_t)last_dc[owner[b]] + (uint32_t)s);
                blk[0] = (int16_t)last_dc[owner[b]];
                for (int k = 1; k < 64; ++k) {
                    s = decode(r, c.ac);
                    const int run = s >> 4;
                    s &= 15;
                    if (s) {
                        k += run;
                        blk[kNatural[k]] = (int16_t)extend(r.get(s), s);
                    } else {
                        if (run != 15) break;
                        k += 15;
                    }
                }
            } else if (Ss == 0 && Ah == 0) {  // DC first
                int s = decode(r, c.dc);
                if (s) s = extend(r.get(s), s);
                const int64_t dc = (int64_t)last_dc[owner[b]] + s;
                if (dc > INT32_MAX || dc < INT32_MIN) {
                    std::snprintf(msg, msglen, "DC coefficient out of range");
                    out[0] = r.pos;
                    out[1] = m;
                    return kBadCoef;
                }
                last_dc[owner[b]] = (int32_t)dc;
                blk[0] = (int16_t)((uint32_t)dc << Al);
            } else if (Ss == 0) {  // DC refine
                if (r.get(1)) blk[0] = (int16_t)(blk[0] | p1);
            } else if (Ah == 0) {  // AC first
                if (eobrun > 0) {
                    --eobrun;
                    continue;
                }
                for (int k = Ss; k <= Se; ++k) {
                    int s = decode(r, c.ac);
                    const int run = s >> 4;
                    s &= 15;
                    if (s) {
                        k += run;
                        blk[kNatural[k]] = (int16_t)((uint32_t)extend(r.get(s), s) << Al);
                    } else if (run == 15) {
                        k += 15;
                    } else {
                        eobrun = 1 << run;
                        if (run) eobrun += r.get(run);
                        --eobrun;
                        break;
                    }
                }
            } else {  // AC refine
                int k = Ss;
                if (eobrun == 0) {
                    for (; k <= Se; ++k) {
                        int s = decode(r, c.ac);
                        int run = s >> 4;
                        s &= 15;
                        if (s) {
                            s = r.get(1) ? p1 : m1;
                        } else if (run != 15) {
                            eobrun = 1 << run;
                            if (run) eobrun += r.get(run);
                            break;
                        }
                        do {
                            int16_t* coef = blk + kNatural[k];
                            if (*coef != 0) {
                                if (r.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                            } else if (--run < 0) {
                                break;
                            }
                            ++k;
                        } while (k <= Se);
                        if (s) blk[kNatural[k]] = (int16_t)s;
                    }
                }
                if (eobrun > 0) {
                    for (; k <= Se; ++k) {
                        int16_t* coef = blk + kNatural[k];
                        if (*coef != 0 && r.get(1) && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                    }
                    --eobrun;
                }
            }
        }
    }
    out[0] = r.marker ? r.marker_at : r.pos;
    out[1] = m;
    if (cut || (r.eof && r.insufficient)) {
        std::snprintf(msg, msglen, "the data ends inside the scan");
        return kTruncated;
    }
    // The data bits left after the last one consumed, up to the end of the
    // file: libjpeg's bit reader fills to 57 bits and suspends at the end
    // of the data, so with fewer left a one-pass decode may not finish.
    // -1: a marker ends the data first, and the reader never passes one.
    out[2] = r.marker ? -1 : r.bits - r.pad;
    for (int64_t i = r.pos; !r.marker && !r.eof && i < r.size; ++i) {
        if (data[i] == 0xFF) {  // FF fill bytes, then 00 (a data FF) or a marker code
            while (i + 1 < r.size && data[i + 1] == 0xFF) ++i;
            if (++i >= r.size) break;
            if (data[i] != 0) {
                out[2] = -1;
                break;
            }
        }
        out[2] += 8;
    }
    return kOk;
}

}  // extern "C"

namespace {

// The `islow` IDCT as libjpeg-turbo's x86 SIMD code computes it
// (jidctint-avx2.asm; the SSE2 version has the same arithmetic), which is
// what Pillow's libjpeg-turbo runs on x86-64: jidctint.c's algorithm (13
// constant bits, 2 bits kept after pass 1) with 16-bit lanes. For the
// coefficients an 8-bit encoder writes it equals jidctint.c; past them the
// lanes wrap (dequantization, in0 ± in4, in7 + in3, in5 + in1) or
// saturate (pass 1's output, the final sample) where jidctint.c would
// compute wider and read its wrapping range-limit table (`& 1023`).
constexpr int kConst = 13, kPass1 = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) { return (int16_t)(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }

// One 8-point pass over lanes `in[0..7]` (16-bit) → 32-bit sums before descaling.
inline void idct_1d(const int16_t* in, int32_t* out) {
    const int32_t z2 = in[2], z3 = in[6];
    const int32_t tmp3 = z2 * (F0541 + F0765) + z3 * F0541, tmp2 = z2 * F0541 + z3 * (F0541 - F1847);
    const int32_t tmp0 = (int32_t)wrap16(in[0] + in[4]) * (1 << kConst);
    const int32_t tmp1 = (int32_t)wrap16(in[0] - in[4]) * (1 << kConst);
    const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    const int32_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
    const int32_t z3s = wrap16(i7 + i3), z4s = wrap16(i5 + i1);
    const int32_t z3p = z3s * (F1175 - F1961) + z4s * F1175, z4p = z3s * F1175 + z4s * (F1175 - F0390);
    const int32_t o0 = i7 * (F0298 - F0899) + i1 * -F0899 + z3p;
    const int32_t o3 = i7 * -F0899 + i1 * (F1501 - F0899) + z4p;
    const int32_t o1 = i5 * (F2053 - F2562) + i3 * -F2562 + z4p;
    const int32_t o2 = i5 * -F2562 + i3 * (F3072 - F2562) + z3p;
    out[0] = t10 + o3;
    out[7] = t10 - o3;
    out[1] = t11 + o2;
    out[6] = t11 - o2;
    out[2] = t12 + o1;
    out[5] = t12 - o1;
    out[3] = t13 + o0;
    out[4] = t13 - o0;
}

void idct_islow(const int16_t* in, const int16_t* quant, uint8_t* out, int64_t out_stride) {
    int16_t ws[64];  // pass 1's output, rows of the block
    bool ac_zero = true;
    for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
    if (ac_zero) {  // the SIMD code's whole-block test: every column is its DC term
        for (int c = 0; c < 8; ++c) {
            const int16_t dc = wrap16((int32_t)(uint16_t)wrap16(in[c] * quant[c]) << kPass1);
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
        }
    } else {
        for (int c = 0; c < 8; ++c) {
            int16_t col[8];
            int32_t sums[8];
            for (int r = 0; r < 8; ++r) col[r] = wrap16(in[8 * r + c] * quant[8 * r + c]);
            idct_1d(col, sums);
            constexpr int n = kConst - kPass1;
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16((sums[r] + (1 << (n - 1))) >> n);
        }
    }
    for (int r = 0; r < 8; ++r) {
        int32_t sums[8];
        idct_1d(ws + 8 * r, sums);
        constexpr int n = kConst + kPass1 + 3;
        uint8_t* o = out + r * out_stride;
        for (int i = 0; i < 8; ++i) {
            const int32_t x = sat16((sums[i] + (1 << (n - 1))) >> n);
            o[i] = (uint8_t)((x < -128 ? -128 : (x > 127 ? 127 : x)) + 128);
        }
    }
}

enum Upsample { kFull, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy, kBox };

struct Plane {
    std::vector<uint8_t> px;  // rows of `pitch` samples
    int64_t pitch;
    int dw, dh;               // the downsampled size: the component's edges
    int hx, vx;               // the box's expansion
    Upsample method;
    std::vector<int> colsum;
};

// One output row of a component's samples, upsampled to `width`.
const uint8_t* upsample_row(Plane& c, int y, int width, uint8_t* row) {
    switch (c.method) {
        case kFull:
            return c.px.data() + (int64_t)y * c.pitch;
        case kBox: {
            const uint8_t* in = c.px.data() + (int64_t)(y / c.vx) * c.pitch;
            for (int x = 0; x < width; ++x) row[x] = in[x / c.hx];
            return row;
        }
        case kH2V1Fancy: {
            const uint8_t* in = c.px.data() + (int64_t)y * c.pitch;
            const int w = c.dw;
            for (int i = 0; i < w; ++i) {
                const int near = in[i] * 3, prev = in[i > 0 ? i - 1 : 0], next = in[i + 1 < w ? i + 1 : w - 1];
                if (2 * i < width) row[2 * i] = (uint8_t)((near + prev + 1) >> 2);
                if (2 * i + 1 < width) row[2 * i + 1] = (uint8_t)((near + next + 2) >> 2);
            }
            return row;
        }
        case kH1V2Fancy:
        case kH2V2Fancy: {
            const int i = y >> 1;
            const bool above = (y & 1) == 0;
            const int far_row = above ? (i > 0 ? i - 1 : 0) : (i + 1 < c.dh ? i + 1 : c.dh - 1);
            const uint8_t* near = c.px.data() + (int64_t)i * c.pitch;
            const uint8_t* far = c.px.data() + (int64_t)far_row * c.pitch;
            if (c.method == kH1V2Fancy) {
                const int bias = above ? 1 : 2;
                for (int x = 0; x < width; ++x) row[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
                return row;
            }
            const int w = c.dw;
            int* cs = c.colsum.data();
            for (int j = 0; j < w; ++j) cs[j] = near[j] * 3 + far[j];
            for (int j = 0; j < w; ++j) {
                const int prev = cs[j > 0 ? j - 1 : 0], next = cs[j + 1 < w ? j + 1 : w - 1];
                if (2 * j < width) row[2 * j] = (uint8_t)((cs[j] * 3 + prev + 8) >> 4);
                if (2 * j + 1 < width) row[2 * j + 1] = (uint8_t)((cs[j] * 3 + next + 7) >> 4);
            }
            return row;
        }
    }
    return row;
}

// jdcolor.c's build_ycc_rgb_table
struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        constexpr int kScale = 16;
        constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
        auto fix = [](double x) { return (int64_t)(x * (1 << kScale) + 0.5); };
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
            cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + kHalf;
        }
    }
};

inline uint8_t clamp255(int64_t v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// Pillow's MULDIV255 and cmyk2rgb
inline uint8_t muldiv255(int a, int b) {
    const int t = a * b + 128;
    return (uint8_t)(((t >> 8) + t) >> 8);
}

}  // namespace

extern "C" {

// The output pass. `p`: width, height, components, color space (0 grey,
// 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK, 5 none: the components as they are,
// libjpeg's JCS_UNKNOWN; 6: raw data, no upsampling, packed in data
// units — of three components, the first at max h × max v, the others
// 1 × 1 — each hs × vs luma samples row by row then Cb and Cr, rows of
// ceil(width / hs) units, ceil(height / vs) rows), max h, max v, then per
// component: h, v, plane stride in blocks. `quant`: per component 64
// latched quantizer values in natural order (all zero for a component no
// scan carried). `out`: height × width × 3, or × components for color
// space 5, or the units. Returns 0, or 1 for sampling factors that are no
// integer ratio (libjpeg refuses them too).
int jpeg_output(const int16_t* coefs, const int64_t* offsets, const int32_t* p, const uint16_t* quant,
                uint8_t* out) {
    const int W = p[0], H = p[1], nc = p[2], color = p[3], hmax = p[4], vmax = p[5];
    std::vector<Plane> planes(nc);
    for (int ci = 0; ci < nc; ++ci) {
        const int h = p[6 + 3 * ci], v = p[7 + 3 * ci], stride = p[8 + 3 * ci];
        Plane& c = planes[ci];
        c.dw = (int)(((int64_t)W * h + hmax - 1) / hmax);
        c.dh = (int)(((int64_t)H * v + vmax - 1) / vmax);
        const int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
        c.pitch = (int64_t)bw * 8;
        c.px.resize((size_t)c.pitch * bh * 8);
        int16_t q[64];
        for (int k = 0; k < 64; ++k) q[k] = (int16_t)quant[ci * 64 + k];  // ISLOW_MULT_TYPE is short
        const int16_t* plane = coefs + offsets[ci];
        for (int by = 0; by < bh; ++by)
            for (int bx = 0; bx < bw; ++bx)
                idct_islow(plane + ((int64_t)by * stride + bx) * 64, q,
                           c.px.data() + (int64_t)by * 8 * c.pitch + bx * 8, c.pitch);
        if (hmax % h || vmax % v) return 1;
        const int hr = hmax / h, vr = vmax / v;
        if (hr == 1 && vr == 1) {
            c.method = kFull;
        } else if (hr == 2 && vr == 1 && c.dw > 2) {
            c.method = kH2V1Fancy;
        } else if (hr == 1 && vr == 2) {
            c.method = kH1V2Fancy;
        } else if (hr == 2 && vr == 2 && c.dw > 2) {
            c.method = kH2V2Fancy;
            c.colsum.resize(c.dw);
        } else {
            c.method = kBox;
        }
        c.hx = hr;
        c.vx = vr;
    }
    if (color == 6) {  // libjpeg's raw data, packed in YCbCr data units as tif_ojpeg.c packs them
        const int hs = hmax, vs = vmax, unit = hs * vs + 2;
        const int64_t across = (W + hs - 1) / hs, down = (H + vs - 1) / vs;
        const Plane &y = planes[0], &cb = planes[1], &cr = planes[2];
        for (int64_t j = 0; j < down; ++j) {
            uint8_t* o = out + j * across * unit;
            for (int64_t q = 0; q < across; ++q, o += unit) {
                for (int sy = 0; sy < vs; ++sy)
                    std::memcpy(o + sy * hs, y.px.data() + (j * vs + sy) * y.pitch + q * hs, (size_t)hs);
                o[hs * vs] = cb.px[(size_t)(j * cb.pitch + q)];
                o[hs * vs + 1] = cr.px[(size_t)(j * cr.pitch + q)];
            }
        }
        return 0;
    }
    static const YccTables t;
    std::vector<uint8_t> rows((size_t)nc * W);
    const int channels = color == 5 ? nc : 3;
    for (int y = 0; y < H; ++y) {
        const uint8_t* s[4];
        for (int ci = 0; ci < nc; ++ci) s[ci] = upsample_row(planes[ci], y, W, rows.data() + (size_t)ci * W);
        uint8_t* o = out + (int64_t)y * W * channels;
        for (int x = 0; x < W; ++x, o += channels) {
            if (color == 5) {
                for (int ci = 0; ci < nc; ++ci) o[ci] = s[ci][x];
            } else if (color == 0) {
                o[0] = o[1] = o[2] = s[0][x];
            } else if (color == 2) {
                o[0] = s[0][x];
                o[1] = s[1][x];
                o[2] = s[2][x];
            } else {
                const int yy = s[0][x], cb = s[1][x], cr = s[2][x];
                int r, g, b;
                if (color == 3) {
                    r = yy;
                    g = cb;
                    b = cr;
                } else {
                    r = clamp255(yy + t.cr_r[cr]);
                    g = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
                    b = clamp255(yy + t.cb_b[cb]);
                    if (color == 4) {  // ycck_cmyk_convert: MAXJSAMPLE - (ycc -> rgb)
                        r = clamp255(255 - (yy + t.cr_r[cr]));
                        g = clamp255(255 - (yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
                        b = clamp255(255 - (yy + t.cb_b[cb]));
                    }
                }
                if (color >= 3) {  // CMYK;I inverts, then Pillow's cmyk2rgb
                    const int c_ = 255 - r, m_ = 255 - g, y_ = 255 - b, nk = s[3][x];
                    r = clamp255(nk - muldiv255(c_, nk));
                    g = clamp255(nk - muldiv255(m_, nk));
                    b = clamp255(nk - muldiv255(y_, nk));
                }
                o[0] = (uint8_t)r;
                o[1] = (uint8_t)g;
                o[2] = (uint8_t)b;
            }
        }
    }
    return 0;
}

}  // extern "C"
