// GIF LZW (the host half of image/gif.py): a frame's data sub-blocks,
// joined, decoded into `want` palette indices as Pillow's GifDecode.c
// decodes them. Codes are packed LSB first and start at min_code_size + 1
// bits; Clear is 2^min_code_size and End of Information the next code;
// the width grows when the next free code reaches 2^width, up to 12 bits,
// and a full table stops growing until the next Clear (a deferred clear).
// Decoding stops once the frame is full; data that ends first, an End of
// Information before the frame is full, or a code past the next free one
// is an error, as it is in Pillow.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns 0 once `want` indices are out, 1 where the data or an EOI ends
// first, 2 for a code past the table.
int gif_lzw(const uint8_t* src, int64_t n, int min_code_size, uint8_t* out, int64_t want) {
    if (min_code_size < 0 || min_code_size > 11) return 2;
    const int clear = 1 << min_code_size, eoi = clear + 1;
    std::vector<int32_t> prefix(4096, -1);
    std::vector<uint8_t> suffix(4096), first(4096);
    std::vector<uint16_t> length(4096, 1);
    for (int i = 0; i < clear; i++) {
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    int width = min_code_size + 1, next = clear + 2, old = -1;
    uint64_t buf = 0;
    int avail = 0;
    int64_t pos = 0, done = 0;
    std::vector<uint8_t> string(4097);
    while (done < want) {
        while (avail < width && pos < n) {
            buf |= (uint64_t)src[pos++] << avail;
            avail += 8;
        }
        if (avail < width) return 1;
        const int code = (int)(buf & ((1u << width) - 1));
        buf >>= width;
        avail -= width;
        if (code == clear) {
            width = min_code_size + 1;
            next = clear + 2;
            old = -1;
            continue;
        }
        if (code == eoi) return 1;
        if (old < 0) {  // the first code after a Clear is a literal
            if (code >= clear) return 2;
            out[done++] = (uint8_t)code;
            old = code;
            continue;
        }
        if (code > next || (code == next && next >= 4096)) return 2;
        if (next < 4096) {
            prefix[next] = old;
            first[next] = first[old];
            length[next] = (uint16_t)(length[old] + 1);
            suffix[next] = code < next ? first[code] : first[old];
            next++;
            if (next == (1 << width) && width < 12) width++;
        }
        int k = length[code];
        for (int c = code; k > 0; c = prefix[c]) string[--k] = suffix[c];
        const int64_t take = want - done < length[code] ? want - done : length[code];
        memcpy(out + done, string.data(), take);
        done += take;
        old = code;
    }
    return 0;
}

}  // extern "C"
