// Plain (ASCII) PNM samples, the host half of image/pnm.py: Pillow's
// PpmPlainDecoder (PIL/PpmImagePlugin.py) as it reads them, so that the
// values and the errors are Pillow's:
// - the data is read in 1 MiB blocks (ImageFile.SAFEBLOCK) from its
//   first byte; each block loses its comments ("#" up to and with the
//   next CR or LF) before it is split, and a comment cut by the block's
//   end runs on into the next blocks (_ignore_comments, including its
//   _find_comment_end, which at a block's first byte picks the later of
//   CR and LF where the other is at 0);
// - P1 (bitonal): every non-whitespace byte of a block must be "0" or
//   "1", also past the last one needed, and no separator is needed;
// - P2, P3: whitespace-separated tokens of at most 10 bytes, a token cut
//   by a block's end carried into the next one (and refused there when
//   its part so far is over 10 bytes, even after the last value needed),
//   each read as Python's int() reads it (a sign, digits with single
//   underscores between them) and refused past 0..maxval.
// Whitespace is the six bytes Python's bytes.split() splits on.
#include <cstdint>
#include <string>

namespace {

constexpr int64_t kBlock = 1 << 20;  // ImageFile.SAFEBLOCK
constexpr size_t kMaxToken = 10;

enum Status { kOk = 0, kShort = 1, kTooLong = 2, kNotInt = 3, kRange = 4, kNotBit = 5 };

inline bool space(uint8_t c) { return c == ' ' || (c >= 9 && c <= 13); }

struct Reader {
    const uint8_t* data;
    int64_t size, pos = 0;
    bool spans = false;

    std::string block() {
        const int64_t n = size - pos < kBlock ? size - pos : kBlock;
        std::string out((const char*)data + pos, (size_t)n);
        pos += n;
        return out;
    }

    // _ignore_comments
    std::string strip(std::string b) {
        if (spans) {
            while (!b.empty()) {
                const int64_t a = (int64_t)b.find('\n'), c = (int64_t)b.find('\r');
                const int64_t a1 = a == (int64_t)std::string::npos ? -1 : a;
                const int64_t c1 = c == (int64_t)std::string::npos ? -1 : c;
                const int64_t end = a1 * c1 > 0 ? (a1 < c1 ? a1 : c1) : (a1 > c1 ? a1 : c1);
                if (end != -1) {
                    b = b.substr((size_t)end + 1);
                    break;
                }
                b = block();
            }
        }
        spans = false;
        std::string out;
        size_t i = 0;
        for (;;) {
            const size_t hash = b.find('#', i);
            if (hash == std::string::npos) {
                out.append(b, i, std::string::npos);
                return out;
            }
            out.append(b, i, hash - i);
            const size_t end = b.find_first_of("\r\n", hash);  // past the "#": no index 0 to mislead
            if (end == std::string::npos) {
                spans = true;
                return out;
            }
            i = end + 1;
        }
    }
};

// Python's int() of a token without whitespace: [+-]? digit (_? digit)*
bool parse_int(const std::string& t, size_t from, size_t to, int64_t& value) {
    size_t i = from;
    bool negative = false;
    if (i < to && (t[i] == '+' || t[i] == '-')) negative = t[i++] == '-';
    if (i >= to) return false;
    int64_t v = 0;
    bool digit_before = false;
    for (; i < to; ++i) {
        const char c = t[i];
        if (c >= '0' && c <= '9') {
            v = v * 10 + (c - '0');
            digit_before = true;
        } else if (c == '_' && digit_before && i + 1 < to && t[i + 1] >= '0' && t[i + 1] <= '9') {
            digit_before = false;
        } else {
            return false;
        }
    }
    value = negative ? -v : v;
    return true;
}

}  // namespace

extern "C" {

// `data`/`size`: the bytes after the header. Fills `out` with `count`
// values (0 or 255 for P1, a set bit black; the raw integers otherwise)
// and returns a Status; `info[0]` the values read, `info[1]` the offending
// value or byte.
int pnm_plain(const uint8_t* data, int64_t size, int64_t count, int64_t maxval, int bitonal, int64_t* out,
              int64_t* info) {
    Reader r{data, size};
    int64_t got = 0;
    info[1] = 0;
    std::string half;
    while (got != count) {
        std::string b = r.block();
        if (b.empty()) {
            if (bitonal || half.empty()) break;
            b = " ";  // the last token, flushed
        }
        b = half + r.strip(b);
        half.clear();
        if (bitonal) {
            for (const char ch : b) {
                const uint8_t c = (uint8_t)ch;
                if (space(c)) continue;
                if (c != '0' && c != '1') {
                    info[0] = got;
                    info[1] = c;
                    return kNotBit;
                }
                if (got < count) out[got++] = c == '1' ? 0 : 255;
            }
            continue;
        }
        size_t end = b.size();
        if (!b.empty() && !space((uint8_t)b.back())) {
            size_t cut = b.size();
            while (cut > 0 && !space((uint8_t)b[cut - 1])) --cut;
            half = b.substr(cut);
            end = cut;
            if (half.size() > kMaxToken) {
                info[0] = got;
                return kTooLong;
            }
        }
        size_t i = 0;
        while (got != count) {
            while (i < end && space((uint8_t)b[i])) ++i;
            if (i >= end) break;
            size_t j = i;
            while (j < end && !space((uint8_t)b[j])) ++j;
            info[0] = got;
            if (j - i > kMaxToken) return kTooLong;
            int64_t v;
            if (!parse_int(b, i, j, v)) return kNotInt;
            if (v < 0 || v > maxval) {
                info[1] = v;
                return kRange;
            }
            out[got++] = v;
            i = j;
        }
    }
    info[0] = got;
    return got == count ? kOk : kShort;
}

}  // extern "C"
