// BMP run-length data (BI_RLE8, BI_RLE4), the host half of image/bmp.py:
// the commands read as Pillow's BmpRleDecoder (PIL/BmpImagePlugin.py)
// reads them, so the indices match its output byte for byte, its quirks
// included:
// - an encoded run is clipped at the row's end; an absolute run is not,
//   and an RLE4 absolute run of n pixels reads n / 2 bytes (an odd n loses
//   its last pixel) while the column still moves by n;
// - end of line pads the data with zeros to a whole row; end of bitmap,
//   or data that ends, stops;
// - a delta command reads its two bytes and then two more, and moves by
//   the second pair (right + up rows of zeros);
// - an absolute run is followed by a byte of padding where the file
//   position is odd.
#include <cstdint>
#include <cstring>

extern "C" {

// `src` is the whole file, the data starting at `start`. Writes the first
// xsize * ysize indices to `out` (zeros where the data leaves gaps) and
// the count produced to `*length` (it may pass xsize * ysize). Returns 0,
// or 1 where a delta's second pair is cut short (Pillow raises there).
int bmp_rle(const uint8_t* src, int64_t n, int64_t start, int xsize, int ysize, int rle4, uint8_t* out,
            int64_t* length) {
    const int64_t dest = (int64_t)xsize * ysize;
    memset(out, 0, dest);
    int64_t len = 0, pos = start, x = 0;
    auto put = [&](uint8_t v) {
        if (len < dest) out[len] = v;
        len++;
    };
    while (len < dest) {
        if (pos + 2 > n) break;
        int count = src[pos], byte = src[pos + 1];
        pos += 2;
        if (count) {
            if (x + count > xsize) count = (int)(xsize - x > 0 ? xsize - x : 0);
            for (int i = 0; i < count; i++) put(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 0x0F) : byte);
            x += count;
        } else if (byte == 0) {  // end of line
            while (len % xsize) put(0);
            x = 0;
        } else if (byte == 1) {  // end of bitmap
            break;
        } else if (byte == 2) {  // delta: the pair is read twice
            if (pos + 2 > n) break;
            pos += 2;
            if (pos + 2 > n) {
                *length = len;
                return 1;
            }
            const int right = src[pos], up = src[pos + 1];
            pos += 2;
            const int64_t skip = right + (int64_t)up * xsize;
            for (int64_t i = 0; i < skip; i++) put(0);
            x = len % xsize;
        } else {  // absolute run
            const int64_t want = rle4 ? byte / 2 : byte;
            const int64_t got = pos + want <= n ? want : n - pos;
            for (int64_t i = 0; i < got; i++) {
                const uint8_t b = src[pos + i];
                if (rle4) {
                    put(b >> 4);
                    put(b & 0x0F);
                } else {
                    put(b);
                }
            }
            pos += got;
            if (got < want) break;
            x += byte;
            if (pos % 2) pos++;
        }
    }
    *length = len;
    return 0;
}

}  // extern "C"
