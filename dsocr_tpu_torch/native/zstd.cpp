// Zstandard (RFC 8878) decoding, the host half of image/tiff.py's
// compression 50000: libtiff's tif_zstd.c hands each strip or tile to
// ZSTD_decompressStream, and this file decodes what that call decodes.
//
// zstd_strip decodes the one frame (or skippable frame) at the start of
// its input into its output, block by block:
// - the frame header: magic 0xFD2FB528, the descriptor (its reserved bit
//   must be 0), the window descriptor or single segment, a dictionary ID
//   (any but 0 fails: libtiff's decoder has no dictionary), the frame
//   content size (checked against what the frame decodes to);
// - a window over libzstd's default limit (2^27 + 1 bytes) fails, as does
//   a block larger than min(window, 128 KiB);
// - raw, RLE and compressed blocks; the literals section raw, RLE, or
//   Huffman-coded in 1 or 4 streams with a table of its own (weights
//   direct or FSE-coded) or the previous block's (treeless);
// - the sequences section: literal length, offset and match length FSE
//   tables predefined, RLE, coded or repeated from the previous block, and
//   each sequence executed with the three repeat offsets (1, 4, 8 at the
//   frame's start);
// - the content checksum (XXH64's low 32 bits) when the frame has one.
// Bitstreams must be consumed exactly, as libzstd requires. Output stops
// at the capacity given (libtiff's strip size): a frame that decodes past
// it ends there, unchecked, as ZSTD_decompressStream leaves it when the
// output buffer is full (zstd_strip's comment has the rest).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kTruncated = 1, kCorrupt = 2, kDictionary = 3, kWindow = 4, kChecksum = 5, kMagic = 6 };

struct Error {
    int status;
};

[[noreturn]] void fail(int status) { throw Error{status}; }

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0

// -- XXH64 --------------------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}
inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
inline uint64_t round64(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t merge64(uint64_t acc, uint64_t v) { return (acc ^ round64(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = round64(v1, rd64(p));
            v2 = round64(v2, rd64(p + 8));
            v3 = round64(v3, rd64(p + 16));
            v4 = round64(v4, rd64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge64(h, v1);
        h = merge64(h, v2);
        h = merge64(h, v3);
        h = merge64(h, v4);
    } else {
        h = P5;
    }
    h += len;
    while (p + 8 <= end) {
        h = rotl(h ^ round64(0, rd64(p)), 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h = rotl(h ^ ((uint64_t)rd32(p) * P1), 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h = rotl(h ^ (*p * P5), 11) * P1;
        ++p;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// -- bit readers --------------------------------------------------------------------------------

// Forward, little-endian (FSE table descriptions).
struct ForwardBits {
    const uint8_t* src;
    size_t size;
    int64_t bit = 0;
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++bit) {
            if ((size_t)(bit >> 3) >= size) fail(kCorrupt);
            v |= (uint32_t)((src[bit >> 3] >> (bit & 7)) & 1) << i;
        }
        return v;
    }
    size_t bytes() const { return (size_t)((bit + 7) >> 3); }
};

// Backward (Huffman and FSE streams): starts after the final 1 bit of the
// last byte; bits before the start read as the `below` bytes before it
// (libzstd's fast Huffman path reads on into the streams before), then as
// zeros, and the stream is whole only if exactly its bits were read.
struct BackwardBits {
    const uint8_t* src;
    int64_t bit;          // bits left above position 0
    int64_t floor = 0;    // the lowest bit that reads the data (<= 0)
    BackwardBits(const uint8_t* s, size_t len, size_t below = 0) : src(s) {
        if (len == 0 || s[len - 1] == 0) fail(kCorrupt);
        bit = (int64_t)len * 8 - (8 - highbit(s[len - 1]));
        floor = -(int64_t)below * 8;
    }
    uint64_t read(int n) {
        if (n == 0) return 0;
        bit -= n;
        int64_t at = bit, count = n;
        if (at < floor) {
            count += at - floor;
            at = floor;
        }
        uint64_t v = 0;
        for (int64_t i = 0; i < count; ++i) {
            const int64_t b = at + i;
            const uint8_t byte = b >= 0 ? src[b >> 3] : src[-((-b + 7) >> 3)];
            v |= (uint64_t)((byte >> (b & 7)) & 1) << i;
        }
        return bit < floor ? (v << (floor - bit)) : v;
    }
};

// -- FSE ----------------------------------------------------------------------------------------

struct Fse {
    int log = 0;
    std::vector<uint8_t> symbol, bits;
    std::vector<uint16_t> base;
    bool ready = false;

    void build(const int16_t* freq, int n, int accuracy) {
        const int size = 1 << accuracy;
        log = accuracy;
        symbol.assign(size, 0);
        bits.assign(size, 0);
        base.assign(size, 0);
        std::vector<uint16_t> next(n > 0 ? n : 1);
        int high = size;
        for (int s = 0; s < n; ++s)
            if (freq[s] == -1) {
                symbol[--high] = (uint8_t)s;
                next[s] = 1;
            }
        const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
        int pos = 0;
        for (int s = 0; s < n; ++s) {
            if (freq[s] <= 0) continue;
            next[s] = (uint16_t)freq[s];
            for (int i = 0; i < freq[s]; ++i) {
                symbol[pos] = (uint8_t)s;
                do pos = (pos + step) & mask;
                while (pos >= high);
            }
        }
        if (pos != 0) fail(kCorrupt);
        for (int i = 0; i < size; ++i) {
            const uint16_t d = next[symbol[i]]++;
            bits[i] = (uint8_t)(accuracy - highbit(d));
            base[i] = (uint16_t)((d << bits[i]) - size);
        }
        ready = true;
    }

    void rle(uint8_t s) {
        log = 0;
        symbol.assign(1, s);
        bits.assign(1, 0);
        base.assign(1, 0);
        ready = true;
    }

    // A table description read forward from `src` → the bytes it took.
    size_t read(const uint8_t* src, size_t size, int max_log, int max_symbol) {
        ForwardBits in{src, size};
        const int accuracy = 5 + (int)in.read(4);
        if (accuracy > max_log) fail(kCorrupt);
        int remaining = 1 << accuracy, n = 0;
        int16_t freq[256];
        while (remaining > 0) {
            if (n > max_symbol) fail(kCorrupt);
            const int nbits = highbit((uint64_t)remaining + 1) + 1;
            uint32_t v = in.read(nbits - 1);
            const uint32_t lower = (1u << (nbits - 1)) - 1, threshold = (1u << nbits) - 1 - (remaining + 1);
            if (v >= threshold) {  // the long form: one more bit
                v |= in.read(1) << (nbits - 1);
                if (v > lower) v -= threshold;
            }
            const int proba = (int)v - 1;
            remaining -= proba < 0 ? -proba : proba;
            freq[n++] = (int16_t)proba;
            if (proba == 0) {
                int repeat;
                do {
                    repeat = (int)in.read(2);
                    for (int i = 0; i < repeat; ++i) {
                        if (n > max_symbol) fail(kCorrupt);
                        freq[n++] = 0;
                    }
                } while (repeat == 3);
            }
        }
        if (remaining != 0) fail(kCorrupt);
        build(freq, n, accuracy);
        return in.bytes();
    }
};

struct FseState {
    const Fse* t;
    uint32_t state;
    void init(BackwardBits& in, const Fse& table) {
        t = &table;
        state = (uint32_t)in.read(table.log);
    }
    uint8_t peek() const { return t->symbol[state]; }
    void update(BackwardBits& in) { state = t->base[state] + (uint32_t)in.read(t->bits[state]); }
};

// -- Huffman ------------------------------------------------------------------------------------

struct Huffman {
    int max_bits = 0;
    std::vector<uint8_t> symbol, bits;
    bool ready = false;

    // Tree description → the bytes it took.
    size_t read(const uint8_t* src, size_t size) {
        if (size < 1) fail(kCorrupt);
        uint8_t weights[256];
        int n = 0;
        const int head = src[0];
        size_t used;
        if (head >= 128) {  // direct: 4 bits a weight
            n = head - 127;
            used = 1 + (size_t)(n + 1) / 2;
            if (used > size) fail(kCorrupt);
            for (int i = 0; i < n; ++i) weights[i] = (uint8_t)(i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15);
        } else {  // FSE-coded weights, two interleaved states
            used = 1 + (size_t)head;
            if (used > size || head == 0) fail(kCorrupt);
            Fse table;
            const size_t desc = table.read(src + 1, head, 6, 255);
            if (desc >= (size_t)head) fail(kCorrupt);
            BackwardBits in(src + 1 + desc, head - desc);
            FseState s1, s2;
            s1.init(in, table);
            s2.init(in, table);
            // libzstd's FSE_decompress_wksp: alternate, stopping once the
            // stream is past its start with the other state's symbol last
            for (;;) {
                if (n >= 255) fail(kCorrupt);
                weights[n++] = s1.peek();
                s1.update(in);
                if (in.bit < 0) {
                    if (n >= 255) fail(kCorrupt);
                    weights[n++] = s2.peek();
                    break;
                }
                if (n >= 255) fail(kCorrupt);
                weights[n++] = s2.peek();
                s2.update(in);
                if (in.bit < 0) {
                    if (n >= 255) fail(kCorrupt);
                    weights[n++] = s1.peek();
                    break;
                }
            }
        }
        uint64_t sum = 0;
        for (int i = 0; i < n; ++i) {
            if (weights[i] > 12) fail(kCorrupt);
            if (weights[i]) sum += 1ull << (weights[i] - 1);
        }
        if (sum == 0) fail(kCorrupt);
        max_bits = highbit(sum) + 1;
        if (max_bits > 12) fail(kCorrupt);
        const uint64_t left = (1ull << max_bits) - sum;
        if (left & (left - 1)) fail(kCorrupt);
        weights[n++] = (uint8_t)(highbit(left) + 1);
        int counts[13] = {0};
        uint8_t nb[256];
        for (int i = 0; i < n; ++i) {
            nb[i] = weights[i] ? (uint8_t)(max_bits + 1 - weights[i]) : 0;
            counts[nb[i]]++;
        }
        const int entries = 1 << max_bits;
        symbol.assign(entries, 0);
        bits.assign(entries, 0);
        uint32_t start[13];
        start[max_bits] = 0;
        for (int b = max_bits; b >= 1; --b) {
            start[b - 1] = start[b] + counts[b] * (1u << (max_bits - b));
            for (uint32_t k = start[b]; k < start[b - 1]; ++k) bits[k] = (uint8_t)b;
        }
        if (start[0] != (uint32_t)entries) fail(kCorrupt);
        for (int i = 0; i < n; ++i) {
            if (!nb[i]) continue;
            const uint32_t len = 1u << (max_bits - nb[i]);
            std::memset(&symbol[start[nb[i]]], i, len);
            start[nb[i]] += len;
        }
        ready = true;
        return used;
    }

    // One stream of `count` symbols. `below`: the bytes before it that a
    // read past its start takes; `lenient`: no check that the stream was
    // read exactly (both as libzstd's fast 4-stream path decodes).
    void stream(const uint8_t* src, size_t len, uint8_t* out, size_t count, size_t below = 0,
                bool lenient = false) const {
        BackwardBits in(src, len, below);
        uint32_t state = (uint32_t)in.read(max_bits);
        const uint32_t mask = (1u << max_bits) - 1;
        for (size_t i = 0; i < count; ++i) {
            out[i] = symbol[state];
            const int b = bits[state];
            state = ((state << b) | (uint32_t)in.read(b)) & mask;
        }
        if (!lenient && in.bit != -max_bits) fail(kCorrupt);
    }
};

// -- sequences ----------------------------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,    17,    18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,   32,   33,   34,    35,    37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
    Huffman huffman;
    Fse ll, of, ml;
    uint64_t rep[3] = {1, 4, 8};
};

// One table of the sequences section by its mode → the bytes it took.
size_t table(Fse& t, int mode, const uint8_t* src, size_t size, const int16_t* defaults, int n_defaults,
             int default_log, int max_log, int max_symbol) {
    switch (mode) {
        case 0:
            t.build(defaults, n_defaults, default_log);
            return 0;
        case 1:
            if (size < 1 || src[0] > max_symbol) fail(kCorrupt);
            t.rle(src[0]);
            return 1;
        case 2:
            return t.read(src, size, max_log, max_symbol);
        default:
            if (!t.ready) fail(kCorrupt);
            return 0;
    }
}

// A compressed block → its bytes appended to `out` (the frame's output so far).
void compressed_block(Frame& f, const uint8_t* src, size_t size, std::vector<uint8_t>& out, size_t block_max) {
    if (size < 1) fail(kCorrupt);
    // literals section
    const int type = src[0] & 3, format = (src[0] >> 2) & 3;
    size_t regen, comp = 0, head;
    int streams = 1;
    if (type < 2) {
        if (format == 1) {
            head = 2;
        } else if (format == 3) {
            head = 3;
        } else {
            head = 1;
        }
        if (size < head) fail(kCorrupt);
        regen = head == 1 ? src[0] >> 3 : head == 2 ? (src[0] >> 4) | (src[1] << 4)
                                                   : (src[0] >> 4) | (src[1] << 4) | ((size_t)src[2] << 12);
    } else {
        head = format < 2 ? 3 : format == 2 ? 4 : 5;
        streams = format == 0 ? 1 : 4;
        if (size < head) fail(kCorrupt);
        uint64_t v = 0;
        for (size_t i = 0; i < head; ++i) v |= (uint64_t)src[i] << (8 * i);
        const int bits = format < 2 ? 10 : format == 2 ? 14 : 18;
        regen = (size_t)((v >> 4) & ((1u << bits) - 1));
        comp = (size_t)((v >> (4 + bits)) & ((1u << bits) - 1));
    }
    if (regen > block_max) fail(kCorrupt);
    std::vector<uint8_t> lit(regen);
    size_t pos = head;
    if (type == 0) {
        if (pos + regen > size) fail(kCorrupt);
        std::memcpy(lit.data(), src + pos, regen);
        pos += regen;
    } else if (type == 1) {
        if (pos + 1 > size) fail(kCorrupt);
        std::memset(lit.data(), src[pos], regen);
        pos += 1;
    } else {
        if (pos + comp > size) fail(kCorrupt);
        const uint8_t* p = src + pos;
        size_t left = comp;
        if (type == 2) {
            const size_t used = f.huffman.read(p, left);
            p += used;
            left -= used;
        } else if (!f.huffman.ready) {
            fail(kCorrupt);
        }
        if (streams == 1) {
            f.huffman.stream(p, left, lit.data(), regen);
        } else {
            if (left < 10 || regen < 6) fail(kCorrupt);
            const size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
            if (6 + s1 + s2 + s3 > left) fail(kCorrupt);
            const size_t s4 = left - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
            if (3 * seg > regen) fail(kCorrupt);
            // libzstd 1.5's fast path (HUF_DecompressFastArgs_init: a table
            // of 11 bits, every stream 8 bytes or more, a fourth segment not
            // empty) reads a stream's overrun from the bytes before it, down
            // to the jump table, and checks only the symbols' count
            const bool fast = f.huffman.max_bits <= 11 && s1 >= 8 && s2 >= 8 && s3 >= 8 && s4 >= 8 && 3 * seg < regen;
            const uint8_t* q = p + 6;
            f.huffman.stream(q, s1, lit.data(), seg, fast ? 6 : 0, fast);
            f.huffman.stream(q + s1, s2, lit.data() + seg, seg, fast ? 6 + s1 : 0, fast);
            f.huffman.stream(q + s1 + s2, s3, lit.data() + 2 * seg, seg, fast ? 6 + s1 + s2 : 0, fast);
            f.huffman.stream(q + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg, fast ? 6 + s1 + s2 + s3 : 0,
                             fast);
        }
        pos += comp;
    }
    // sequences section
    if (pos >= size) fail(kCorrupt);
    size_t nseq = src[pos++];
    if (nseq >= 128) {
        if (nseq == 255) {
            if (pos + 2 > size) fail(kCorrupt);
            nseq = src[pos] + ((size_t)src[pos + 1] << 8) + 0x7F00;
            pos += 2;
        } else {
            if (pos + 1 > size) fail(kCorrupt);
            nseq = ((nseq - 128) << 8) + src[pos++];
        }
    }
    const size_t start = out.size();
    if (nseq == 0) {
        if (pos != size) fail(kCorrupt);
        out.insert(out.end(), lit.begin(), lit.end());
        return;
    }
    if (pos >= size) fail(kCorrupt);
    const int modes = src[pos++];
    if (modes & 3) fail(kCorrupt);
    pos += table(f.ll, modes >> 6, src + pos, size - pos, kLLDefault, 36, 6, 9, 35);
    pos += table(f.of, (modes >> 4) & 3, src + pos, size - pos, kOFDefault, 29, 5, 8, 31);
    pos += table(f.ml, (modes >> 2) & 3, src + pos, size - pos, kMLDefault, 53, 6, 9, 52);
    if (pos >= size) fail(kCorrupt);
    BackwardBits in(src + pos, size - pos);
    FseState ll, of, ml;
    ll.init(in, f.ll);
    of.init(in, f.of);
    ml.init(in, f.ml);
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; ++i) {
        const int ofc = of.peek(), mlc = ml.peek(), llc = ll.peek();
        if (ofc > 31 || mlc > 52 || llc > 35) fail(kCorrupt);
        const uint64_t offset_value = (1ull << ofc) + in.read(ofc);
        const size_t match = kMLBase[mlc] + (size_t)in.read(kMLBits[mlc]);
        const size_t literals = kLLBase[llc] + (size_t)in.read(kLLBits[llc]);
        if (i + 1 < nseq) {
            ll.update(in);
            ml.update(in);
            of.update(in);
        }
        uint64_t offset;
        if (offset_value > 3) {
            offset = offset_value - 3;
            f.rep[2] = f.rep[1];
            f.rep[1] = f.rep[0];
            f.rep[0] = offset;
        } else {
            const int idx = (int)offset_value - 1 + (literals == 0 ? 1 : 0);
            if (idx == 0) {
                offset = f.rep[0];
            } else {
                offset = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
                if (idx > 1) f.rep[2] = f.rep[1];
                f.rep[1] = f.rep[0];
                f.rep[0] = offset;
            }
        }
        if (lit_pos + literals > regen) fail(kCorrupt);
        out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + literals);
        lit_pos += literals;
        if (offset == 0 || offset > out.size()) fail(kCorrupt);
        if (out.size() - start + match > block_max) fail(kCorrupt);
        size_t from = out.size() - offset;
        for (size_t k = 0; k < match; ++k) out.push_back(out[from + k]);
    }
    if (in.bit != 0) fail(kCorrupt);
    out.insert(out.end(), lit.begin() + lit_pos, lit.end());
    if (out.size() - start > block_max) fail(kCorrupt);
}

struct Header {
    bool skippable = false, single = false, checksum = false, has_fcs = false;
    uint64_t window = 0, fcs = 0, dict = 0;
    size_t size = 0;  // header bytes (a skippable frame: the whole frame)
};

Header header(const uint8_t* src, size_t size) {
    Header h;
    if (size < 4) fail(kTruncated);
    const uint32_t magic = rd32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (size < 8) fail(kTruncated);
        h.skippable = true;
        h.size = 8 + (size_t)rd32(src + 4);
        return h;
    }
    if (magic != 0xFD2FB528u) fail(kMagic);
    if (size < 5) fail(kTruncated);
    const int fhd = src[4];
    const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
    h.single = (fhd >> 5) & 1;
    h.checksum = (fhd >> 2) & 1;
    const size_t dict_bytes[4] = {0, 1, 2, 4}, fcs_bytes[4] = {(size_t)(h.single ? 1 : 0), 2, 4, 8};
    size_t pos = 5;
    if (size < pos + (h.single ? 0 : 1) + dict_bytes[dict_flag] + fcs_bytes[fcs_flag]) fail(kTruncated);
    if (fhd & 8) fail(kCorrupt);
    if (!h.single) {
        const int wd = src[pos++];
        const uint64_t base = 1ull << (10 + (wd >> 3));
        h.window = base + (base / 8) * (wd & 7);
    }
    for (size_t i = 0; i < dict_bytes[dict_flag]; ++i) h.dict |= (uint64_t)src[pos++] << (8 * i);
    h.has_fcs = fcs_bytes[fcs_flag] > 0;
    for (size_t i = 0; i < fcs_bytes[fcs_flag]; ++i) h.fcs |= (uint64_t)src[pos++] << (8 * i);
    if (fcs_flag == 1) h.fcs += 256;
    if (h.single) h.window = h.fcs;
    if (h.window < 1024) h.window = 1024;
    h.size = pos;
    return h;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where they run past `size`.
size_t frame_size(const uint8_t* src, size_t size, const Header& h) {
    size_t pos = h.size;
    for (;;) {
        if (pos + 3 > size) return 0;
        const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
        pos += 3 + (((bh >> 1) & 3) == 1 ? 1 : bh >> 3);
        if (pos > size) return 0;
        if (bh & 1) break;
    }
    pos += h.checksum ? 4 : 0;
    return pos <= size ? pos : 0;
}

}  // namespace

extern "C" {

// One strip or tile as tif_zstd.c's ZSTDDecode decodes it: ZSTD_decompressStream
// over the strip's bytes into `dst` (capacity `cap`, the strip's size)
// until it returns 0 (the end of the first frame, a skippable one too), the
// input runs out, or the output is full. A frame with a content size that
// fits `cap` and lies whole in the input goes through libzstd's single-pass
// shortcut; otherwise each block is flushed as it completes (a raw block
// as its bytes come), and the window is held to the default limit.
// Returns a Status (kOk also where the output filled before the frame's
// end, kTruncated where the input ran out first); info[0]: input bytes
// used, info[1]: the bytes of dst that count (none after an error: the
// one ZSTD_decompressStream call that failed reports no output, and
// ZSTDDecode zeros the strip from there).
int zstd_strip(const uint8_t* src, int64_t size, uint8_t* dst, int64_t cap, int64_t* info) {
    info[0] = info[1] = 0;
    size_t pos = 0;
    std::vector<uint8_t> out;
    int64_t written = 0;
    bool single_pass = false;
    auto flush = [&]() {
        const int64_t n = (int64_t)out.size() < cap ? (int64_t)out.size() : cap;
        if (n > written) std::memcpy(dst + written, out.data() + written, (size_t)(n - written));
        written = n;
    };
    try {
        const Header h = header(src, (size_t)size);
        if (h.skippable) {
            if (h.size > (size_t)size) fail(kTruncated);
            info[0] = (int64_t)h.size;
            return kOk;
        }
        pos = h.size;
        single_pass = h.has_fcs && (int64_t)h.fcs <= cap && frame_size(src, (size_t)size, h) != 0;
        if (h.dict) fail(kDictionary);
        if (!single_pass && h.window > (1ull << 27) + 1) fail(kWindow);
        const size_t block_max = h.window < (1u << 17) ? (size_t)h.window : (1u << 17);
        out.reserve((size_t)(h.has_fcs && (int64_t)h.fcs < cap ? h.fcs : cap));
        Frame f;
        for (;;) {
            if ((int64_t)pos + 3 > size) fail(kTruncated);
            const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
            pos += 3;
            const int last = bh & 1, type = (bh >> 1) & 3;
            const size_t bsize = bh >> 3;
            if (type == 3 || bsize > block_max) fail(kCorrupt);
            const size_t in_bytes = type == 1 ? 1 : bsize;
            if ((int64_t)(pos + in_bytes) > size) {
                if (type == 0 && !single_pass) {  // libzstd streams a raw block's bytes as they come
                    out.insert(out.end(), src + pos, src + size);
                    flush();
                }
                fail(kTruncated);
            }
            if (type == 0) {
                out.insert(out.end(), src + pos, src + pos + bsize);
            } else if (type == 1) {
                out.insert(out.end(), bsize, src[pos]);
            } else {
                compressed_block(f, src + pos, bsize, out, block_max);
            }
            pos += in_bytes;
            if (h.has_fcs && out.size() > h.fcs) fail(kCorrupt);
            if (!single_pass) {
                flush();
                if ((int64_t)out.size() > cap) {  // the block cannot be flushed whole: the output is full
                    info[0] = (int64_t)pos;
                    info[1] = written;
                    return kOk;
                }
            }
            if (last) break;
        }
        if (h.has_fcs && out.size() != h.fcs) fail(kCorrupt);
        if (h.checksum) {
            if ((int64_t)pos + 4 > size) fail(kTruncated);
            if ((uint32_t)xxh64(out.data(), out.size()) != rd32(src + pos)) fail(kChecksum);
            pos += 4;
        }
        flush();
        info[0] = (int64_t)pos;
        info[1] = written;
        return kOk;
    } catch (const Error& e) {
        info[0] = (int64_t)pos;
        if (e.status == kTruncated) info[1] = written;  // the input ran out: what was flushed stays
        return e.status;  // an error: ZSTD_decompressStream returns without moving output->pos
    } catch (const std::exception&) {
        return kCorrupt;
    }
}

}  // extern "C"
