// TIFF strip and tile codecs, the host half of image/tiff.py: LZW
// (compression 5, with libtiff's old-style bit order), PackBits (32773)
// and the CCITT fax codings: modified Huffman RLE (2), T.4 1-D and 2-D
// (3) and T.6 / Group 4 (4). image/tiff.py parses the directory, cuts the
// strips or tiles and calls one of these per strip or tile; Deflate goes
// through Python's zlib.
//
// Each decoder follows libtiff 4.7's (tif_lzw.c, tif_packbits.c,
// tif_fax3.c), which Pillow runs for every compressed TIFF:
// - a strip decodes until its expected bytes are out; data that ends
//   first is an error (libtiff's "Not enough data"), and data left over
//   is ignored;
// - LZW's codes start at 9 bits after a Clear; the width grows one code
//   early in new-style data and at the table's edge in old-style data,
//   whose codes are packed LSB-first (told by the first two bytes, as
//   libtiff's LZWPreDecode does); the table may run 1024 entries past
//   4096, as libtiff's does;
// - PackBits drops what would run past the strip's end;
// - the fax decoders write runs as bits, black 1 and white 0, MSB first,
//   each row (width + 7) / 8 bytes. T.4 rows are found by their EOLs
//   (libtiff's SYNC_EOL: skip to 11 zero bits, then zero bytes, then to
//   the EOL's 1), and a 2-D file's tag bit picks each row's coding; an
//   EOL inside a row ends it, the rest white, and the next row starts at
//   that EOL's 1. Changes past the width are dropped and the row ends
//   white (libtiff's CLEANUP_RUNS); runs are counted in 64 bits and clipped
//   to the width, so no change lies outside the row. A bad code word,
//   uncompressed mode or a run past 2**30 is an error here (libtiff warns
//   and pads the row, or its 32-bit counters overflow), and so is G4 data
//   that ends before the last row (libtiff leaves the rows it did not
//   reach as they were).
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// -- LZW --------------------------------------------------------------------------------------

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kTable = 4096 + 1024;

struct LzwEntry {
    int32_t next;  // the prefix's code, -1 for a literal
    uint16_t length;
    uint8_t value, first;
};

// -- CCITT code tables (T.4 tables 2 and 3) ----------------------------------------------------

struct Code {
    const char* bits;
    int value;
};

const Code kWhite[] = {
    {"00110101", 0},   {"000111", 1},     {"0111", 2},       {"1000", 3},       {"1011", 4},       {"1100", 5},
    {"1110", 6},       {"1111", 7},       {"10011", 8},      {"10100", 9},      {"00111", 10},     {"01000", 11},
    {"001000", 12},    {"000011", 13},    {"110100", 14},    {"110101", 15},    {"101010", 16},    {"101011", 17},
    {"0100111", 18},   {"0001100", 19},   {"0001000", 20},   {"0010111", 21},   {"0000011", 22},   {"0000100", 23},
    {"0101000", 24},   {"0101011", 25},   {"0010011", 26},   {"0100100", 27},   {"0011000", 28},   {"00000010", 29},
    {"00000011", 30},  {"00011010", 31},  {"00011011", 32},  {"00010010", 33},  {"00010011", 34},  {"00010100", 35},
    {"00010101", 36},  {"00010110", 37},  {"00010111", 38},  {"00101000", 39},  {"00101001", 40},  {"00101010", 41},
    {"00101011", 42},  {"00101100", 43},  {"00101101", 44},  {"00000100", 45},  {"00000101", 46},  {"00001010", 47},
    {"00001011", 48},  {"01010010", 49},  {"01010011", 50},  {"01010100", 51},  {"01010101", 52},  {"00100100", 53},
    {"00100101", 54},  {"01011000", 55},  {"01011001", 56},  {"01011010", 57},  {"01011011", 58},  {"01001010", 59},
    {"01001011", 60},  {"00110010", 61},  {"00110011", 62},  {"00110100", 63},  {"11011", 64},     {"10010", 128},
    {"010111", 192},   {"0110111", 256},  {"00110110", 320}, {"00110111", 384}, {"01100100", 448}, {"01100101", 512},
    {"01101000", 576}, {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152},
    {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472},
    {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664}, {"010011011", 1728},
};

const Code kBlack[] = {
    {"0000110111", 0},    {"010", 1},           {"11", 2},            {"10", 3},            {"011", 4},
    {"0011", 5},          {"0010", 6},          {"00011", 7},         {"000101", 8},        {"000100", 9},
    {"0000100", 10},      {"0000101", 11},      {"0000111", 12},      {"00000100", 13},     {"00000111", 14},
    {"000011000", 15},    {"0000010111", 16},   {"0000011000", 17},   {"0000001000", 18},   {"00001100111", 19},
    {"00001101000", 20},  {"00001101100", 21},  {"00000110111", 22},  {"00000101000", 23},  {"00000010111", 24},
    {"00000011000", 25},  {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54},
    {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}, {"0000001111", 64},
    {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256}, {"000000110011", 320},
    {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728},
};

// makeup codes of both colours (T.4 table 3, 1792-2560)
const Code kExtended[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},  {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560},
};

// two-dimensional mode codes (T.4 table 4)
enum Mode { kPass, kHoriz, kV0, kVR1, kVR2, kVR3, kVL1, kVL2, kVL3, kExt };
const Code kModes[] = {
    {"0001", kPass}, {"001", kHoriz}, {"1", kV0},       {"011", kVR1},     {"000011", kVR2},
    {"0000011", kVR3}, {"010", kVL1}, {"000010", kVL2}, {"0000010", kVL3}, {"0000001", kExt},
};

constexpr int kLookBits = 13;
constexpr int kEolValue = -100;  // apart from every -status
constexpr int64_t kMaxRun = INT32_MAX / 2;

// a table over the next kLookBits bits: (code length, value); length 0
// where no code starts with those bits
struct Lookup {
    std::vector<uint8_t> length = std::vector<uint8_t>(1 << kLookBits, 0);
    std::vector<int16_t> value = std::vector<int16_t>(1 << kLookBits, 0);

    void add(const char* bits, int v) {
        const int n = (int)strlen(bits);
        int prefix = 0;
        for (int i = 0; i < n; i++) prefix = prefix * 2 + (bits[i] - '0');
        const int span = 1 << (kLookBits - n);
        for (int i = 0; i < span; i++) {
            length[(prefix << (kLookBits - n)) | i] = (uint8_t)n;
            value[(prefix << (kLookBits - n)) | i] = (int16_t)v;
        }
    }
};

struct FaxTables {
    Lookup white, black, modes;
    FaxTables() {
        for (const Code& c : kWhite) white.add(c.bits, c.value);
        for (const Code& c : kBlack) black.add(c.bits, c.value);
        for (const Code& c : kExtended) {
            white.add(c.bits, c.value);
            black.add(c.bits, c.value);
        }
        // an EOL's 11 zeros: its 1 is read by the next row's sync_eol
        white.add("00000000000", kEolValue);
        black.add("00000000000", kEolValue);
        for (const Code& c : kModes) modes.add(c.bits, c.value);
        modes.add("00000000000", kEolValue);
    }
};

const FaxTables& fax_tables() {
    static const FaxTables tables;
    return tables;
}

// MSB-first bits of the data; past its end, reads fail
struct Bits {
    const uint8_t* src;
    int64_t n, pos = 0;  // pos in bits

    bool has(int k) const { return pos + k <= n * 8; }
    int peek(int k) const {  // the next k bits, zeros past the end
        int v = 0;
        for (int i = 0; i < k; i++) {
            const int64_t p = pos + i;
            v = v * 2 + (p < n * 8 ? (src[p >> 3] >> (7 - (p & 7))) & 1 : 0);
        }
        return v;
    }
    int take(int k) {
        const int v = peek(k);
        pos += k;
        return v;
    }
};

enum FaxStatus { kOk = 0, kEof = 1, kBadCode = 2, kUncompressed = 3 };

// one code from `table` → its value (kEolValue for EOL), or a status < 0
int read_code(Bits& in, const Lookup& table) {
    const int look = in.peek(kLookBits);
    const int len = table.length[look];
    if (len == 0) return in.has(1) ? -kBadCode : -kEof;
    if (!in.has(len)) return -kEof;
    in.pos += len;
    return table.value[look];
}

// one run of a colour: makeup codes, then a terminating code → the run
// (clipped to `cap`: past the row's end every length reads the same), or
// kEolValue with the makeup codes read before the EOL in `*partial`, or a
// status < 0. A run libtiff's 32-bit counters cannot hold is a bad code.
int read_run(Bits& in, const Lookup& table, int cap, int* partial = nullptr) {
    int64_t run = 0;
    for (;;) {
        const int v = read_code(in, table);
        if (v == kEolValue) {
            if (partial) *partial = (int)(run < cap ? run : cap);
            return kEolValue;
        }
        if (v < 0) return v;
        run += v;
        if (run > kMaxRun) return -kBadCode;
        if (v < 64) return (int)(run < cap ? run : cap);
    }
}

struct Row {
    std::vector<int> changes;  // positions where the colour flips, white first
    bool eol = false;           // an EOL ended the row
};

// libtiff's CLEANUP_RUNS: changes past the width go; a row that ends short
// of the width (or went past it) ends white
void finish(Row& row, int width) {
    std::vector<int>& c = row.changes;
    while (!c.empty() && c.back() > width) c.pop_back();
    if (c.size() & 1) c.push_back(c.back() < width ? c.back() : width);
}

// a 1-D coded row
int decode_1d(Bits& in, int width, Row& row) {
    int a0 = 0, color = 0;
    while (a0 < width) {
        int partial = 0;
        const int run = read_run(in, color ? fax_tables().black : fax_tables().white, width + 1, &partial);
        if (run == kEolValue) {
            if (partial) row.changes.push_back(a0 + partial);  // makeup codes, then the EOL
            row.eol = true;
            break;
        }
        if (run < 0) return -run;
        a0 += run;
        row.changes.push_back(a0);
        color ^= 1;
    }
    finish(row, width);
    return kOk;
}

// a 2-D coded row against the reference row's changes
int decode_2d(Bits& in, int width, const std::vector<int>& ref, Row& row) {
    auto at = [&](size_t i) { return i < ref.size() ? ref[i] : width; };
    int a0 = 0, color = 0;
    bool start = true;
    size_t bi = 0;
    std::vector<int>& cur = row.changes;
    while (a0 < width) {
        // b1: the first change on the reference row right of a0 (at a0 on
        // the row's start) that turns to the opposite of a0's colour
        while (bi < ref.size() && (start ? ref[bi] < a0 : ref[bi] <= a0)) bi++;
        if ((int)(bi & 1) != color) bi++;
        const int b1 = at(bi), b2 = at(bi + 1);
        const int mode = read_code(in, fax_tables().modes);
        if (mode == kEolValue) {
            row.eol = true;
            break;
        }
        if (mode < 0) return -mode;
        if (mode == kExt) return kUncompressed;
        if (mode == kPass) {
            a0 = b2;
            bi += 2;
            start = false;
            continue;
        }
        if (mode == kHoriz) {
            const int r1 = read_run(in, color ? fax_tables().black : fax_tables().white, width + 1);
            if (r1 == kEolValue) return kBadCode;
            if (r1 < 0) return -r1;
            const int r2 = read_run(in, color ? fax_tables().white : fax_tables().black, width + 1);
            if (r2 == kEolValue) return kBadCode;
            if (r2 < 0) return -r2;
            cur.push_back(a0 + r1);
            cur.push_back(a0 + r1 + r2);
            a0 += r1 + r2;
            start = false;
            continue;
        }
        static const int kShift[] = {0, 0, 0, 1, 2, 3, -1, -2, -3};
        const int a1 = b1 + kShift[mode];
        if (a1 < a0) return kBadCode;
        cur.push_back(a1);
        a0 = a1;
        color ^= 1;
        start = false;
        // the next b1 turns to the other colour: it may be the change
        // before this one (after a VL code), never one further back
        if (bi > 0) bi--;
    }
    finish(row, width);
    return kOk;
}

void fill_row(const std::vector<int>& changes, int width, uint8_t* out) {
    memset(out, 0, (width + 7) / 8);
    for (size_t i = 0; i + 1 < changes.size(); i += 2) {
        const int from = changes[i] < 0 ? 0 : changes[i] < width ? changes[i] : width;
        const int to = changes[i + 1] < from ? from : changes[i + 1] < width ? changes[i + 1] : width;
        for (int x = from; x < to; x++) out[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
    }
}

// libtiff's SYNC_EOL: unless an EOL just ended a row, skip to 11 zero
// bits; then zero bytes; then zeros up to the EOL's 1
bool sync_eol(Bits& in, bool after_eol) {
    if (!after_eol) {
        for (;;) {
            if (!in.has(11)) return false;
            if (in.peek(11) == 0) break;
            in.pos++;
        }
    }
    for (;;) {
        if (!in.has(8)) return false;
        if (in.peek(8)) break;
        in.pos += 8;
    }
    while (in.has(1) && in.peek(1) == 0) in.pos++;
    if (!in.has(1)) return false;
    in.pos++;
    return true;
}

}  // namespace

extern "C" {

// LZW data → `want` bytes of `dst`. Returns 0, 1 where the data (or an
// EOI) ends first, 2 for a code the table cannot hold.
int tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t want) {
    const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
    std::vector<LzwEntry> table(kTable);
    for (int i = 0; i < 256; i++) table[i] = {-1, 1, (uint8_t)i, (uint8_t)i};
    int nbits = 9, free_ent = kFirst, old = -1;
    uint64_t buf = 0;
    int avail = 0;
    int64_t pos = 0, out = 0;
    std::vector<uint8_t> string(kTable + 1);
    auto grow_at = [&]() { return compat ? (1 << nbits) : (1 << nbits) - 1; };
    while (out < want) {
        while (avail < nbits && pos < n) {
            buf = compat ? buf | ((uint64_t)src[pos++] << avail) : (buf << 8) | src[pos++];
            avail += 8;
        }
        if (avail < nbits) return 1;
        int code;
        if (compat) {
            code = (int)(buf & ((1u << nbits) - 1));
            buf >>= nbits;
        } else {
            code = (int)((buf >> (avail - nbits)) & ((1u << nbits) - 1));
            buf &= (avail - nbits) ? ((uint64_t)1 << (avail - nbits)) - 1 : 0;
        }
        avail -= nbits;
        if (code == kEoi) return 1;
        if (code == kClear) {
            nbits = 9;
            free_ent = kFirst;
            old = -2;  // the next code is a literal
            continue;
        }
        if (old == -2 || old == -1) {
            if (old == -1 || code > kClear) return 2;  // no Clear first, or no literal after it
            dst[out++] = (uint8_t)code;
            old = code;
            continue;
        }
        if (free_ent >= kTable || code > free_ent) return 2;
        LzwEntry& e = table[free_ent];
        e.next = old;
        e.first = table[old].first;
        e.length = (uint16_t)(table[old].length + 1);
        e.value = code < free_ent ? table[code].first : e.first;
        if (++free_ent >= grow_at() && nbits < 12) nbits++;
        old = code;
        int len = table[code].length, k = len;
        for (int c = code; c >= 0; c = table[c].next) string[--k] = table[c].value;
        const int64_t take = want - out < len ? want - out : len;
        memcpy(dst + out, string.data(), take);
        out += take;
    }
    return 0;
}

// PackBits data → `want` bytes of `dst`. Returns 0, or 1 where the data
// ends first.
int tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t want) {
    int64_t pos = 0, out = 0;
    while (pos < n && out < want) {
        int v = src[pos++];
        if (v >= 128) v -= 256;
        if (v == -128) continue;
        if (v < 0) {
            int64_t k = 1 - v;
            if (k > want - out) k = want - out;
            if (pos >= n) break;
            memset(dst + out, src[pos++], k);
            out += k;
        } else {
            int64_t k = v + 1;
            if (k > want - out) k = want - out;
            if (pos + k > n) break;
            memcpy(dst + out, src + pos, k);
            out += k;
            pos += k;
        }
    }
    return out < want ? 1 : 0;
}

// CCITT fax data → `rows` rows of (width + 7) / 8 bytes. `coding`: 2
// modified Huffman (rows byte-aligned, no EOLs), 3 T.4 (`options` is
// T4Options: bit 0 2-D coding), 4 T.6. Returns 0, 1 where the data ends
// first, 2 for a bad code word, 3 for uncompressed mode; `row_out` gets
// the row it stopped at.
int tiff_fax(const uint8_t* src, int64_t n, uint8_t* dst, int width, int rows, int coding, int options,
             int* row_out) {
    Bits in{src, n};
    const int rowbytes = (width + 7) / 8;
    std::vector<int> ref;  // the reference row's changes; all white above the first row
    bool after_eol = false;
    for (int y = 0; y < rows; y++) {
        *row_out = y;
        Row row;
        int status;
        if (coding == 2) {
            status = decode_1d(in, width, row);
            in.pos = (in.pos + 7) & ~(int64_t)7;
        } else if (coding == 3) {
            if (!sync_eol(in, after_eol)) return kEof;
            bool one_d = true;
            if (options & 1) {
                if (!in.has(1)) return kEof;
                one_d = in.take(1) == 1;
            }
            status = one_d ? decode_1d(in, width, row) : decode_2d(in, width, ref, row);
        } else {
            status = decode_2d(in, width, ref, row);
            if (status == kOk && row.eol) status = kEof;  // an EOFB before the last row
        }
        if (status != kOk) return status;
        after_eol = row.eol;
        fill_row(row.changes, width, dst + (int64_t)y * rowbytes);
        ref.swap(row.changes);
    }
    *row_out = rows;
    return kOk;
}

}  // extern "C"
