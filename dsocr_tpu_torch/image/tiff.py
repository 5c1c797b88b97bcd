"""TIFF bytes → RGB uint8, bit-equal to Pillow's ``Image.open(...).convert("RGB")``
(Pillow 12.1 over libtiff 4.7, libjpeg-turbo 3.1 and LittleCMS 2.17),
without Pillow.

The first IFD only (what ``Image.open`` gives), classic or BigTIFF, either
byte order. Pillow's own table (``TiffImagePlugin.OPEN_INFO``) decides what
opens: the key (byte order, photometric, sample format, fill order, bits
per sample, extra samples), built as Pillow builds it, names a raw mode.
Every row of that table is read (``_RAWMODES``, ``_GREY16``, ``_WIDE``);
a key outside it raises ``ImageDecodeError`` as Pillow's "unknown pixel
mode" does.

Data: strips or tiles, PlanarConfiguration 1 and 2, compression 1 (none),
32773 (PackBits), 5 (LZW, new and old style), 8 and 32946 (Deflate), 2
(CCITT modified Huffman), 3 (T.4, 1-D and 2-D), 4 (T.6), 7 (JPEG), 6
(old-style JPEG), 34925 (LZMA) and 50000 (Zstandard); the codecs but
Deflate and LZMA (Python's zlib and lzma) are native/tiff.cpp's and
native/zstd.cpp's, JPEG's image/decode.py's. Refused by name with
``UnsupportedImageFormat``: CCITT RLEW (32771), ThunderScan (32809),
SGILog and SGILog24 (34676, 34677), WebP (50001), Windows Media Photo,
every other compression, and the layouts listed below. Pillow decodes
compressed data through libtiff and uncompressed data with its own
unpackers, and the two differ; each is followed:

- compressed: the strip's StripByteCounts bytes decode to its rows (a
  count over 1 MiB and over 10 × the strip's size + 4096 cut to that, as
  libtiff's TIFFFillStrip cuts it), and data that decodes short raises
  (libtiff's "Not enough data"; Zstandard: tif_zstd.c's one
  ZSTD_decompressStream loop a strip decodes its first frame only, so a
  skippable frame or a second frame leaves it short, a frame longer than
  the strip stops when the strip is full, and a dictionary ID, a bad
  checksum or a window over libzstd's limit fails); Predictor 2 undoes horizontal
  differencing of 8-, 16- and 32-bit samples, Predictor 3 libtiff's
  floating-point differencing of 32-bit floats (byte differences, then
  the byte planes put back), another predictor or depth raises as
  libtiff does; FillOrder 2 reverses the bits of each data byte before
  decoding; 16- and 32-bit samples come from libtiff in native
  (little-endian) order, which Pillow's big-endian signed and float raw
  modes read byte-swapped, and so does this module; planar data with as
  many samples as Pillow's mode has bands reads (16-bit planes by their
  high byte), and other planar data raises as Pillow's reader does;
- uncompressed: StripByteCounts are not read; FillOrder 2 reverses the
  bits of each byte, but for the four raw modes Pillow has no unpacker
  for (L;IR, P;1R, P;2R, P;4R), which raise; planar data takes one
  character of the raw mode per plane as Pillow's tile loop does (a
  plain one-band unpacker: no inversion, no bit reversal, no offset of
  CIELab's a and b), so RGB, RGBA, CMYK and CIELab planes read at 8
  bits, a plane without an unpacker raises ``ImageDecodeError``, and
  planes Pillow would read at the wrong depth (16-bit, or one 2- or
  4-bit sample) raise ``UnsupportedImageFormat``; YCbCr raises
  ``UnsupportedImageFormat`` (Pillow unpacks three samples as RGBX).

JPEG (compression 7), as libtiff's tif_jpeg.c reads each strip or tile:
the JPEGTables stream's tables first, then the strip's own (which
replace them, and stay for the strips after, as in one libjpeg
decompressor); the color space from Photometric, whatever JFIF, Adobe or
the component ids say (6 in one plane: YCbCr → RGB with libjpeg's fancy
upsampling, JPEGCOLORMODE_RGB, which Pillow unpacks as RGB; every other:
the components as they are, so CMYK reads as Pillow's raw CMYK, not the
JPEG reader's inverted one); a strip that ends early reads on through
the EOI libtiff's source manager inserts. JPEGPreDecode's checks raise:
a frame larger than its strip or tile (but a last strip's frame of the
full strip height, which is cut), a component count other than the
samples (one for planar data), sampling factors other than
YCbCrSubsampling for the first component and 1 × 1 for the others
(YCbCrSubsampling, where the tag is absent, is the first strip's, as
JPEGFixupTags reads it, else 2 × 2); a frame smaller than its strip
raises too (libtiff warns and leaves Pillow's rows undefined). 12-bit
JPEG strips (BitsPerSample 12, which Pillow reads as I;12) raise
``UnsupportedImageFormat``.

Old-style JPEG (compression 6), which Pillow reads as YCbCr (Photometric
2, 6 or none; SamplesPerPixel 3 or none), is modelled on tif_ojpeg.c
(``_OldJpeg``): the JPEGInterchangeFormat stream, or the JPEGQTables,
JPEGDCTables and JPEGACTables tags with bare entropy-coded strips, one
libjpeg session over the stream libtiff regenerates (an RST marker
between strips, the restart interval one strip's MCUs), its raw data in
YCbCr data units (native/jpeg.cpp) for the RGBA reader; the SOF's
subsampling replaces YCbCrSubsampling, strips of several must be
multiples of 8 × the vertical subsampling rows, and a restart marker out
of place fails (libtiff's resync_to_restart): its strip reads as zeros, a
strip after it raises. Tiled and planar old-style JPEG and SOF3 are
refused by name.

YCbCr in any other form (LZW, Deflate, PackBits, LZMA, Zstandard, or JPEG
planes) goes, as in Pillow, through libtiff's RGBA reader (tif_getimage.c;
native/tiff_color.cpp converts): packed data units at 4:4, 4:2, 4:1,
2:2, 2:1, 1:2 or 1:1 (planar data 1:1 only), the tables of
YCbCrCoefficients and ReferenceBlackWhite; strips are read for their
rows rounded up to the unit height in libtiff's scanlines (4:4 rows of
an odd number of units come 2 bytes short, which read as zeros) and
tiles skip their units past the image's edge as libtiff does (10 bytes
a 4:4 unit, its putcontig8bitYCbCr44tile's count); a block that does
not decode keeps what did, the rest zeros, as the reader goes on (but
Deflate and LZMA blocks that are corrupt rather than short read as
zeros whole, where libtiff keeps what it inflated first); a block that
cannot be read fails, unless it is a tile after the first of its row,
which reads as zeros; a one-sample YCbCr file, other subsamplings and a
predictor raise.

The samples then map to RGB as Pillow's unpackers and ``convert("RGB")``
map them: 1-, 2- and 4-bit grey × 255, 85, 17 (photometric 0 inverted),
12- and 16-bit grey clipped at 255 (signed: clipped to 0..255), 32-bit
integers clipped to 0..255, 32-bit floats to 0 (and NaN) up to 255,
truncated between, 16-bit colour by its high byte, palettes through
ColorMap // 256, alpha and other extra samples dropped, premultiplied
alpha (ExtraSamples 1) divided out (``c * 255 // a``, 0 where a is 0),
CMYK through Pillow's cmyk2rgb, CIELab through the LittleCMS transform
Pillow's ImageCms builds (native/tiff_color.cpp). The Orientation tag
(274) transposes the result as Pillow's load does
(``ImageOps.exif_transpose``), the RGBA reader's output too. More than
178,956,970 pixels raise, as Pillow's decompression-bomb check does.
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .decode import _I64P, _RAW, _UNITS, _YCC, MAX_PIXELS, ImageDecodeError, JpegTables, UnsupportedImageFormat, \
    _native, cmyk_to_rgb, decode_jpeg_stream, float_to_grey

II, MM = b"II", b"MM"

# tag numbers
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
PLANAR, T4_OPTIONS, PREDICTOR, COLORMAP = 284, 292, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT = 322, 323, 324, 325, 338, 339
JPEG_TABLES, YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BLACK_WHITE = 347, 529, 530, 532
JPEG_IF, JPEG_IF_LENGTH, JPEG_RESTART, JPEG_QTABLES, JPEG_DCTABLES, JPEG_ACTABLES = 513, 514, 515, 519, 520, 521

# field type → (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("l", 4), 10: ("ll", 8), 11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8), 17: ("q", 8),
          18: ("Q", 8)}
_READ = {1: "none", 2: "CCITT modified Huffman", 3: "CCITT T.4", 4: "CCITT T.6", 5: "LZW", 6: "old-style JPEG",
         7: "JPEG", 8: "Deflate", 32773: "PackBits", 32946: "Deflate", 34925: "LZMA", 50000: "Zstandard"}
_REFUSED = {32771: "CCITT RLEW", 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24", 50001: "WebP"}
_PREDICTED = (5, 8, 32946, 34925, 50000)  # the codecs libtiff runs its predictors with

# Pillow's OPEN_INFO rows that are read: (photometric, sample format,
# fill order, bits, extra) → (mode, raw mode), for both byte orders
# except where one is named
_RAWMODES: Dict[tuple, Tuple[str, str]] = {}
for _photo, _inv in ((0, "I"), (1, "")):
    for _fill, _rev in ((1, ""), (2, "R")):
        _RAWMODES[(_photo, (1,), _fill, (1,), ())] = ("1", "1;" + _inv + _rev if _inv or _rev else "1")
        for _b in (2, 4):
            _RAWMODES[(_photo, (1,), _fill, (_b,), ())] = ("L", f"L;{_b}{_inv}{_rev}")
        _RAWMODES[(_photo, (1,), _fill, (8,), ())] = ("L", "L;" + _inv + _rev if _inv or _rev else "L")
_RAWMODES[(1, (2,), 1, (8,), ())] = ("L", "L")
_RAWMODES.update({
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
    (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
})
for _fill, _rev in ((1, ""), (2, "R")):
    for _b in (1, 2, 4):
        _RAWMODES[(3, (1,), _fill, (_b,), ())] = ("P", f"P;{_b}{_rev}")
_RAWMODES[(3, (1,), 1, (8,), ())] = ("P", "P")
_RAWMODES[(3, (1,), 2, (8,), ())] = ("P", "P;R")
# 16-bit grey: Pillow's rows differ by byte order
_GREY16 = {
    (II, 0, (1,), 1): ("I;16", "I;16"), (II, 1, (1,), 1): ("I;16", "I;16"), (MM, 1, (1,), 1): ("I;16B", "I;16B"),
    (II, 1, (1,), 2): ("I;16", "I;16R"), (II, 1, (2,), 1): ("I", "I;16S"), (MM, 1, (2,), 1): ("I", "I;16BS"),
}
# 12- and 32-bit rows, also by byte order: (order, photometric, sample
# format, bits) → (mode, raw mode); fill order 1, no extra samples
_WIDE = {
    (II, 1, (1,), (12,)): ("I;16", "I;12"),
    (II, 0, (3,), (32,)): ("F", "F;32F"), (MM, 0, (3,), (32,)): ("F", "F;32BF"),
    (II, 1, (1,), (32,)): ("I", "I;32N"), (II, 1, (2,), (32,)): ("I", "I;32S"), (MM, 1, (2,), (32,)): ("I", "I;32BS"),
    (II, 1, (3,), (32,)): ("F", "F;32F"), (MM, 1, (3,), (32,)): ("F", "F;32BF"),
}
# raw modes whose samples libtiff hands Pillow in native (little-endian)
# order and Pillow reads in the file's: compressed values come out byte-swapped
_SWAPPED = {"I;16BS", "I;32BS", "F;32BF"}
# raw modes of OPEN_INFO that Pillow's own (uncompressed) reader has no
# unpacker for, and the one-band unpackers its planar tile loop finds
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}
_PLANE_UNPACKERS = {"1": "1", "L": "L", "P": "P", "RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4,
          "CMYK": 4, "LAB": 3}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_FAX_ERRORS = {1: "data ends before the last row", 2: "a bad code word",
               3: "uncompressed mode (not read)"}


class _Directory:
    """The first IFD's tags: {tag: tuple of values} (ASCII and undefined
    fields as bytes)."""

    def __init__(self, raw: bytes):
        order = raw[:2]
        self.order = order
        self.endian = "<" if order == II else ">"
        magic = struct.unpack(self.endian + "H", raw[2:4])[0]
        self.big = magic == 43
        if self.big:
            if struct.unpack(self.endian + "HH", raw[4:8]) != (8, 0):
                raise ImageDecodeError("BigTIFF header is malformed")
            offset = struct.unpack(self.endian + "Q", raw[8:16])[0]
        else:
            offset = struct.unpack(self.endian + "L", raw[4:8])[0]
        count_fmt, entry_size, inline = ("Q", 20, 8) if self.big else ("H", 12, 4)
        head = struct.calcsize(count_fmt)
        if offset < 8 or offset + head > len(raw):
            raise ImageDecodeError(f"TIFF IFD offset {offset} is outside the data")
        n = struct.unpack(self.endian + count_fmt, raw[offset:offset + head])[0]
        if offset + head + n * entry_size > len(raw):
            raise ImageDecodeError("TIFF IFD is truncated")
        self.tags: Dict[int, tuple] = {}
        self.rationals: Dict[int, tuple] = {}  # {tag: ((numerator, denominator), ...)} of RATIONAL fields
        for i in range(n):
            at = offset + head + i * entry_size
            if self.big:
                tag, kind, count = struct.unpack(self.endian + "HHQ", raw[at:at + 12])
                field = raw[at + 12:at + 20]
            else:
                tag, kind, count = struct.unpack(self.endian + "HHL", raw[at:at + 8])
                field = raw[at + 8:at + 12]
            if kind not in _TYPES:
                continue  # Pillow skips a field of an unknown type
            code, size = _TYPES[kind]
            length = size * count
            if length > inline:
                start = struct.unpack(self.endian + ("Q" if self.big else "L"), field[:8 if self.big else 4])[0]
                data = raw[start:start + length]
                if len(data) != length:
                    continue  # Pillow skips a field whose data lies past the end
            else:
                data = field[:length]
            if kind in (2, 7):
                self.tags[tag] = (data,)
                continue
            values = struct.unpack(self.endian + code[0] * (len(code) * count), data)
            if kind in (5, 10):  # rationals
                self.rationals[tag] = tuple(zip(values[::2], values[1::2]))
                values = tuple(a / b if b else 0.0 for a, b in zip(values[::2], values[1::2]))
            self.tags[tag] = values

    def get(self, tag: int, default=None):
        return self.tags.get(tag, default)

    def one(self, tag: int, default=None):
        """A tag Pillow reads as one value (its first)."""
        values = self.tags.get(tag)
        return default if not values else values[0]

    def floats(self, tag: int, count: int, default) -> np.ndarray:
        """A RATIONAL array as libtiff reads it into floats ((float)num /
        (float)den, 0 where den is 0), or `default`."""
        pairs = self.rationals.get(tag)
        if pairs is None or len(pairs) != count:
            return np.array(default, np.float32)
        num, den = (np.array(v, np.float64).astype(np.float32) for v in zip(*pairs))
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(den == 0, np.float32(0), num / np.where(den == 0, np.float32(1), den)).astype(np.float32)


def _lib():
    return _native("tiff")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _inflate(data: bytes, want: int, where: str) -> np.ndarray:
    try:
        out = zlib.decompressobj().decompress(data, want)
    except zlib.error as err:
        raise ImageDecodeError(f"TIFF {where}: Deflate data does not inflate: {err}") from None
    if len(out) < want:
        raise ImageDecodeError(f"TIFF {where}: Deflate data ends after {len(out)} of {want} bytes")
    return np.frombuffer(out, np.uint8)


def _unxz(data: bytes, want: int, where: str) -> np.ndarray:
    """tif_lzma.c: one .xz stream a strip or tile."""
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(data, want)
    except lzma.LZMAError as err:
        raise ImageDecodeError(f"TIFF {where}: LZMA data does not decode: {err}") from None
    if len(out) < want:
        raise ImageDecodeError(f"TIFF {where}: LZMA data ends after {len(out)} of {want} bytes")
    return np.frombuffer(out, np.uint8)


_ZSTD_ERRORS = {1: "ends early", 2: "is corrupt", 3: "names a dictionary (libtiff's decoder has none)",
                4: "needs a window over libzstd's default limit", 5: "fails its content checksum",
                6: "does not start with a Zstandard frame"}


def _unzstd(data: bytes, dst: np.ndarray):
    """tif_zstd.c: the strip's first frame into `dst` (native/zstd.cpp) →
    (status, bytes written); what was not written stays as it was."""
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(2, np.int64)
    status = _native("zstd").zstd_strip(_ptr(src), len(src), _ptr(dst), len(dst), info.ctypes.data_as(_I64P))
    return status, int(info[1])


def _decompress(data: bytes, compression: int, want: int, width: int, rows: int, t4: int, where: str) -> np.ndarray:
    """One strip or tile's data → its `want` decoded bytes."""
    if compression in (8, 32946):
        return _inflate(data, want, where)
    if compression == 34925:
        return _unxz(data, want, where)
    if compression == 50000:
        out = np.zeros(want, np.uint8)
        status, written = _unzstd(data, out)
        if status > 1:
            raise ImageDecodeError(f"TIFF {where}: Zstandard data {_ZSTD_ERRORS[status]}")
        if written < want:
            raise ImageDecodeError(f"TIFF {where}: Zstandard data ends after {written} of {want} bytes")
        return out
    src = np.frombuffer(data, np.uint8)
    out = np.empty(want, np.uint8)
    if compression in (5, 32773):
        fn = _lib().tiff_lzw if compression == 5 else _lib().tiff_packbits
        status = fn(_ptr(src), len(src), _ptr(out), want)
        if status == 1:
            raise ImageDecodeError(f"TIFF {where}: {_READ[compression]} data ends before {want} bytes")
        if status:
            raise ImageDecodeError(f"TIFF {where}: LZW data is corrupt (a code past its table)")
        return out
    row = ctypes.c_int32(0)
    status = _lib().tiff_fax(_ptr(src), len(src), _ptr(out), width, rows, compression, t4, ctypes.byref(row))
    if status:
        raise ImageDecodeError(f"TIFF {where}: {_READ[compression]} data has {_FAX_ERRORS[status]} (row {row.value})")
    return out


def _decompress_into(data: bytes, compression: int, dst: np.ndarray) -> None:
    """A strip or tile decoded as TIFFRGBAImage reads it, which goes on
    past a block that fails: what decodes lands in `dst`, and the rest of
    it reads as zeros."""
    want = len(dst)
    dst[:] = 0
    if compression in (5, 32773):
        src = np.frombuffer(data, np.uint8)
        (_lib().tiff_lzw if compression == 5 else _lib().tiff_packbits)(_ptr(src), len(src), _ptr(dst), want)
        return
    if compression == 50000:
        if _unzstd(data, dst)[0] > 1:
            dst[:] = 0  # ZSTDDecode zeros what ZSTD_decompressStream did not report
        return
    try:
        out = (lzma.LZMADecompressor(lzma.FORMAT_XZ) if compression == 34925 else zlib.decompressobj()).decompress(
            data, want)
    except (zlib.error, lzma.LZMAError):
        return  # corrupt data: the bytes it would have decoded first are not kept
    dst[:len(out)] = np.frombuffer(out, np.uint8)


_UINT = {8: np.uint8, 16: np.uint16, 32: np.uint32}


def _undo_predictor(rows: np.ndarray, width: int, spp: int, bits: int, endian: str) -> np.ndarray:
    """Horizontal differencing (Predictor 2) undone on decoded rows [n,
    bytes], in the file's byte order."""
    if bits == 8:
        s = rows[:, :width * spp].reshape(len(rows), width, spp)
        out = np.cumsum(s, axis=1, dtype=np.uint8)
        return out.reshape(len(rows), -1)
    size, kind = bits // 8, endian + f"u{bits // 8}"
    s = rows[:, :width * spp * size].copy().view(kind).reshape(len(rows), width, spp)
    out = np.cumsum(s, axis=1, dtype=_UINT[bits]).astype(kind)
    return out.reshape(len(rows), -1).view(np.uint8)


def _undo_float_predictor(rows: np.ndarray, width: int, spp: int, endian: str) -> np.ndarray:
    """tif_predict.c's fpAcc (Predictor 3) on 32-bit rows: byte
    differences over `spp` bytes undone, then the four byte planes (most
    significant first) put back together, in the file's byte order."""
    n, cc = len(rows), width * spp * 4
    acc = np.cumsum(rows[:, :cc].reshape(n, -1, spp), axis=1, dtype=np.uint8).reshape(n, 4, cc // 4)
    words = acc.transpose(0, 2, 1)  # big-endian bytes of each word
    return np.ascontiguousarray(words[..., ::-1] if endian == "<" else words).reshape(n, cc)


def _samples(rows: np.ndarray, width: int, spp: int, bits: int, endian: str, rawmode: str) -> np.ndarray:
    """Decoded rows [n, bytes] → samples [n, width, spp] (uint16 at 12 and
    16 bits, int32 or float32 at 32)."""
    n = len(rows)
    if bits == 32:
        kind = "f4" if rawmode.startswith("F") else "i4"
        return rows[:, :width * spp * 4].copy().view(endian + kind).reshape(n, width, spp).astype(kind)
    if bits == 16:
        return rows[:, :width * spp * 2].copy().view(endian + "u2").reshape(n, width, spp).astype(np.uint16)
    if bits == 12:  # Pillow's I;12 unpacker: two samples in three bytes, high bits first
        need = 3 * ((width + 1) // 2)
        b = np.zeros((n, need), np.uint16)
        b[:, :min(need, rows.shape[1])] = rows[:, :need]
        b = b.reshape(n, -1, 3)
        pairs = np.stack([(b[..., 0] << 4) | (b[..., 1] >> 4), ((b[..., 1] & 15) << 8) | b[..., 2]], axis=2)
        return pairs.reshape(n, -1)[:, :width, None]
    if bits == 8:
        return rows[:, :width * spp].reshape(n, width, spp)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
    return unpacked.reshape(n, -1)[:, :width, None]


def _unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    a = alpha.astype(np.int32)[..., None]
    out = np.where(a == 0, 0, np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255))
    return out.astype(np.uint8)


def _lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """Pillow's LAB pixels (L, a ^ 128, b ^ 128) → RGB, as ImageCms's
    transform gives them (native/tiff_color.cpp)."""
    src = np.ascontiguousarray(lab[..., :3], np.uint8)
    out = np.empty(src.shape, np.uint8)
    _native("tiff_color").tiff_lab(_ptr(src), src.size // 3, _ptr(out))
    return out


def _to_rgb(s: np.ndarray, mode: str, rawmode: str, depth: int, premultiplied: bool,
            palette: Optional[np.ndarray]) -> np.ndarray:
    """Samples [H, W, spp] (sub-byte samples as values, the fill order
    already undone) → RGB as Pillow's unpacker for `rawmode` and
    convert("RGB") from `mode` give them."""
    v = s[..., 0]
    if mode in ("1", "L") and s.shape[-1] == 1:
        grey = (v * np.uint8(255 // ((1 << depth) - 1))).astype(np.uint8)
        if "I" in rawmode.split(";", 1)[-1]:  # photometric 0: 1;I, L;2I, L;4I, L;I (and their R forms)
            grey = 255 - grey
    elif mode in ("I;16", "I;16B"):  # I;16 (and I;12) → L clips
        grey = np.minimum(v, 255).astype(np.uint8)
    elif mode == "I":  # signed 16-bit samples, or 32-bit ones: I → L clips to 0..255
        wide = v.astype(np.uint16).view(np.int16) if v.dtype == np.uint16 else v
        grey = np.clip(wide, 0, 255).astype(np.uint8)
    elif mode == "F":
        grey = float_to_grey(v)
    elif mode == "LA":
        grey = v
    elif mode in ("P", "PA"):
        return palette[v]
    elif mode == "LAB":
        return _lab_to_rgb(s)
    else:
        if s.dtype == np.uint16:
            s = (s >> 8).astype(np.uint8)
        if mode == "CMYK":
            return cmyk_to_rgb(s[..., :4])
        if premultiplied:
            return _unpremultiply(s[..., :3], s[..., 3])
        return np.ascontiguousarray(s[..., :3])
    return np.repeat(grey[..., None], 3, axis=2)


_TRANSPOSE = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1],
}


def decode_tiff(raw: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 3) uint8, as Pillow's convert("RGB") gives it."""
    if raw[:4] not in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        raise ImageDecodeError("TIFF data does not start with a TIFF header")
    d = _Directory(raw)
    if 0xBC01 in d.tags:
        raise UnsupportedImageFormat("Windows Media Photo in TIFF")
    compression = d.one(COMPRESSION, 1)
    if compression in _REFUSED:
        raise UnsupportedImageFormat(f"{_REFUSED[compression]}-compressed TIFF (compression {compression})")
    if compression not in _READ:
        raise UnsupportedImageFormat(f"TIFF compression {compression}")
    photo = 6 if compression == 6 else d.one(PHOTOMETRIC, 0)  # Pillow: old-style JPEG is YCbCr
    fill = d.one(FILL_ORDER, 1)
    width, height = d.get(WIDTH), d.get(LENGTH)
    if width is None or height is None:
        raise ImageDecodeError("TIFF has no ImageWidth or ImageLength")
    if len(width) != 1 or len(height) != 1 or not width[0] or not height[0]:
        raise ImageDecodeError("TIFF has an invalid size")
    width, height = int(width[0]), int(height[0])
    if width * height > MAX_PIXELS:
        raise ImageDecodeError(f"TIFF image of {width} × {height} is too large")

    # Pillow's _setup: the key into OPEN_INFO
    sample_format = tuple(d.get(SAMPLE_FORMAT, (1,)))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bits = tuple(d.get(BITS, (1,)))
    extra = tuple(d.get(EXTRA, ()))
    spp = d.one(SAMPLES, 3 if compression == 6 else 1)
    if spp > 6:
        raise ImageDecodeError(f"TIFF has {spp} samples per pixel")
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ImageDecodeError("TIFF BitsPerSample does not match SamplesPerPixel")
    order = d.order
    if (order, photo, sample_format, bits) in _WIDE and fill == 1 and not extra:
        mode, rawmode = _WIDE[(order, photo, sample_format, bits)]
    elif bits == (16,) and (order, photo, sample_format, fill) in _GREY16:
        mode, rawmode = _GREY16[(order, photo, sample_format, fill)]
    elif (photo, sample_format, fill, bits, extra) in _RAWMODES:
        mode, rawmode = _RAWMODES[(photo, sample_format, fill, bits, extra)]
    else:
        raise ImageDecodeError(f"TIFF pixel layout is not one Pillow reads (photometric {photo}, sample format "
                               f"{sample_format}, fill order {fill}, bits {bits}, extra samples {extra})")
    planar = d.one(PLANAR, 1)
    if planar not in (1, 2):
        raise ImageDecodeError(f"TIFF PlanarConfiguration {planar}")
    depth = bits[0]
    if compression in (2, 3, 4) and (depth != 1 or spp != 1):
        raise ImageDecodeError("TIFF CCITT compression needs one 1-bit sample")
    if compression == 7 and depth != 8:
        if depth == 12:  # Pillow reads a 12-bit JPEG strip as I;12 through libjpeg's 12-bit decoder
            raise UnsupportedImageFormat("12-bit JPEG-compressed TIFF")
        raise ImageDecodeError(f"TIFF JPEG data under {depth}-bit samples (libtiff: improper JPEG data precision)")
    if photo == 6 and mode == "L" and compression != 1:
        raise ImageDecodeError("compressed one-sample YCbCr TIFF (libtiff's RGBA reader has no routine for it)")
    if compression == 6 and d.one(PHOTOMETRIC, 6) not in (2, 6):  # libtiff reads RGB as YCbCr, but no other
        raise ImageDecodeError(f"old-style JPEG TIFF with Photometric {d.one(PHOTOMETRIC)} (libtiff fails it)")
    if photo == 6 and mode == "RGB":
        if compression == 1:  # Pillow's raw reader unpacks three samples as RGBX
            raise UnsupportedImageFormat("uncompressed YCbCr TIFF")
        if compression != 7 or planar == 2:
            return _orient(_ycbcr_rgba(raw, d, compression, width, height, planar), d)
        rawmode = "RGB"  # libjpeg converts to RGB, and Pillow unpacks that

    palette = None
    if mode in ("P", "PA"):
        cmap = d.get(COLORMAP)
        if cmap is None:
            raise ImageDecodeError("TIFF palette image has no ColorMap")
        n = len(cmap) // 3
        table = np.zeros((256, 3), np.uint8)
        cmap = np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T[:256] // 256
        table[:len(cmap)] = cmap
        palette = table

    samples, rawmode = _read_samples(raw, d, compression, width, height, spp, depth, planar, fill, rawmode, mode,
                                     photo)
    return _orient(_to_rgb(samples, mode, rawmode, depth, rawmode.startswith("RGBa"), palette), d)


def _orient(out: np.ndarray, d: _Directory) -> np.ndarray:
    """The Orientation tag applied as Pillow's load does (exif_transpose)."""
    orientation = d.one(ORIENTATION, 1)
    return np.ascontiguousarray(_TRANSPOSE[orientation](out)) if orientation in _TRANSPOSE else out


def _check_predictor(predictor: int, depth: int, mode: str) -> None:
    """What tif_predict.c's PredictorSetup accepts for Pillow's rows."""
    if predictor == 2 and depth not in (8, 16, 32):
        raise ImageDecodeError(f"TIFF horizontal predictor with {depth}-bit samples")
    if predictor == 3 and mode != "F":
        raise ImageDecodeError("TIFF floating-point predictor with integer samples")
    if predictor not in (1, 2, 3):
        raise ImageDecodeError(f"TIFF Predictor {predictor}")


def _layout(d: _Directory, width: int, height: int):
    """(tiled, blocks [(x0, y0, w, h)], offsets, byte counts) of the
    strips or tiles of one plane."""
    if TILE_OFFSETS in d.tags:
        tw, th = d.one(TILE_WIDTH), d.one(TILE_LENGTH)
        if not tw or not th or tw * th > MAX_PIXELS:
            raise ImageDecodeError(f"TIFF tiles of {tw} × {th} are empty or too large")
        across, down = -(-width // tw), -(-height // th)
        return True, [(x * tw, y * th, tw, th) for y in range(down) for x in range(across)], \
            d.get(TILE_OFFSETS), d.get(TILE_COUNTS)
    if STRIP_OFFSETS in d.tags:
        rps = d.one(ROWS_PER_STRIP, height) or height
        return False, [(0, y, width, rps) for y in range(0, height, rps)], d.get(STRIP_OFFSETS), d.get(STRIP_COUNTS)
    raise ImageDecodeError("TIFF has neither strips nor tiles")


def _strip_bytes(raw: bytes, offsets, counts, index: int, full: int, fill: int, where: str) -> bytes:
    """A compressed strip or tile's bytes as TIFFFillStrip reads them (a
    count over 1 MiB and over 10 × the decoded size + 4096 cut to that)."""
    offset, count = offsets[index], counts[index]
    if count > 1 << 20 and (count - 4096) // 10 > full:
        count = full * 10 + 4096  # libtiff's "Too large strip byte count ... Limiting to"
    data = raw[offset:offset + count]
    if len(data) < count:
        raise ImageDecodeError(f"TIFF {where} lies past the end of the data")
    return _REVERSED[np.frombuffer(data, np.uint8)].tobytes() if fill == 2 else data


def _read_samples(raw: bytes, d: _Directory, compression: int, width: int, height: int, spp: int, depth: int,
                  planar: int, fill: int, rawmode: str, mode: str, photo: int) -> Tuple[np.ndarray, str]:
    """Every strip or tile → (samples [H, W, spp], the raw mode Pillow
    unpacks them with)."""
    endian = d.endian
    compressed = compression != 1
    predictor = d.one(PREDICTOR, 1) if compression in _PREDICTED else 1
    _check_predictor(predictor, depth, mode)
    planes, per_plane = (spp, 1) if planar == 2 and spp > 1 else (1, spp)
    if planar == 2 and compressed and spp > 1 and spp != _BANDS[mode]:
        raise ImageDecodeError(f"planar TIFF with {spp} samples in {mode} (Pillow's libtiff reader refuses it)")
    if planar == 2 and not compressed:
        # Pillow's tile loop unpacks plane i with the raw mode's i-th character
        letters = rawmode[:planes]
        if not all(c in _PLANE_UNPACKERS.get(mode, "") for c in letters):
            raise ImageDecodeError(f"uncompressed planar TIFF with raw mode {rawmode} (Pillow has no unpacker)")
        if depth != {"1": 1}.get(letters, 8):  # Pillow reads these planes at the wrong depth
            raise UnsupportedImageFormat(f"uncompressed planar TIFF with raw mode {rawmode}")
        # plain one-band unpackers: no inversion, no bit reversal
        rawmode, fill = (letters if planes == 1 else rawmode), 1
    elif not compressed and rawmode in _NO_UNPACKER:
        raise ImageDecodeError(f"uncompressed TIFF with raw mode {rawmode} (Pillow has no unpacker for it)")
    sample_endian = "<" if compressed and rawmode in _SWAPPED else endian
    tiled, blocks, offsets, counts = _layout(d, width, height)
    if not tiled and not compressed and blocks[0][3] >= height and planes == 1 and len(offsets) > 1:
        offsets = offsets[-1:]  # Pillow reads the last offset where one strip covers the image
    if len(offsets) < len(blocks) * planes:
        raise ImageDecodeError(f"TIFF has {len(offsets)} strip or tile offsets for {len(blocks) * planes} blocks")
    if compressed and (counts is None or len(counts) < len(offsets)):
        raise ImageDecodeError("TIFF compressed data has no StripByteCounts or TileByteCounts")
    t4 = d.one(T4_OPTIONS, 0) if compression == 3 else 0
    jpeg = _JpegCodec(raw, d, offsets, counts, per_plane, photo == 6 and planes == 1) if compression == 7 else None

    dtype = {12: np.uint16, 16: np.uint16, 32: np.float32 if mode == "F" else np.int32}.get(depth, np.uint8)
    samples = np.zeros((height, width, spp), dtype)
    for bi, (x0, y0, bw, bh) in enumerate(blocks):
        for plane in range(planes):  # in Pillow's order, which JPEG's tables carried from block to block follow
            index = plane * len(blocks) + bi
            # libtiff decodes whole tiles; Pillow's raw reader only the rows in the image
            rows = bh if tiled and compressed else min(bh, height - y0)
            rowbytes = -(-bw * per_plane * depth // 8)
            want = rows * rowbytes
            where = f"{'tile' if tiled else 'strip'} {index}"
            if compressed:
                full = (bh if tiled else min(bh, height)) * rowbytes  # libtiff's TIFFStripSize / TIFFTileSize
                data = _strip_bytes(raw, offsets, counts, index, full, fill, where)
                if jpeg is not None:
                    got = jpeg.block(data, bw, rows, not tiled and y0 + rows == height, where)
                    h, w = min(rows, height - y0), min(bw, width - x0)
                    samples[y0:y0 + h, x0:x0 + w, plane:plane + per_plane] = got[:h, :w]
                    continue
                flat = _decompress(data, compression, want, bw, rows, t4, where)
            else:
                offset = offsets[index]
                flat = np.frombuffer(raw, np.uint8, count=want, offset=offset) if offset + want <= len(raw) \
                    else None
                if flat is None:
                    raise ImageDecodeError(f"TIFF {where} lies past the end of the data (truncated)")
                if fill == 2:
                    flat = _REVERSED[flat]
            block = flat.reshape(rows, rowbytes)
            if predictor == 2:
                block = _undo_predictor(block, bw, per_plane, depth, endian)
            elif predictor == 3:
                block = _undo_float_predictor(block, bw, per_plane, endian)
            got = _samples(block, bw, per_plane, depth, sample_endian, rawmode)
            h, w = min(rows, height - y0), min(bw, width - x0)
            samples[y0:y0 + h, x0:x0 + w, plane:plane + per_plane] = got[:h, :w]
    if mode == "LAB" and planes == 1:  # Pillow's LAB unpacker; its one-band plane unpackers copy
        samples[..., 1:] ^= 128
    return samples, rawmode


# -- JPEG (compression 7) -----------------------------------------------------------------------


def _jpeg_subsampling(data: bytes, spp: int) -> Optional[Tuple[int, int]]:
    """tif_jpeg.c's JPEGFixupTagsSubsampling: the first strip's luma
    sampling factors, or None where libtiff leaves YCbCrSubsampling as it
    is."""
    pos = 0
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return None
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            return None
        code = data[pos]
        pos += 1
        if code == 0xD8:
            continue
        if pos + 2 > len(data):
            return None
        length = int.from_bytes(data[pos:pos + 2], "big")
        if code in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= code <= 0xEF:
            if length < 2:
                return None
            pos += length
            continue
        if code not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA) or length != 8 + spp * 3 or pos + length > len(data):
            return None
        body = data[pos + 2:pos + length]  # precision, height, width, count, then (id, hv, tq) each
        if any(body[7 + 3 * c] != 0x11 for c in range(1, spp)):
            return None
        h, v = body[7] >> 4, body[7] & 15
        return (h, v) if h in (1, 2, 4) and v in (1, 2, 4) else None


class _JpegCodec:
    """libtiff's JPEG codec over one image: the JPEGTables stream loaded
    first, the tables carried from block to block, and JPEGPreDecode's
    checks of each block's frame."""

    def __init__(self, raw: bytes, d: _Directory, offsets, counts, components: int, ycbcr: bool):
        self.tables = JpegTables()
        stream = d.get(JPEG_TABLES)
        if stream is not None:
            self.tables.load(stream[0] if isinstance(stream[0], bytes) else bytes(stream))
        self.components = components
        self.color = _YCC if ycbcr else _RAW  # JPEGCOLORMODE_RGB, else no color conversion
        self.sampling = (1, 1)  # TIFF 6.0 forbids subsampling of every other photometric
        if ycbcr:
            tag = d.get(YCBCR_SUBSAMPLING)
            if tag is not None and len(tag) == 2:
                self.sampling = tuple(tag)
            else:  # the default, unless the first strip's frame corrects it
                self.sampling = _jpeg_subsampling(raw[offsets[0]:offsets[0] + counts[0]], components) or (2, 2)

    def block(self, data: bytes, width: int, rows: int, last_strip: bool, where: str) -> np.ndarray:
        """One strip or tile's JPEG stream → [rows, width, channels]. A
        stream that ends early reads on as libtiff's source manager lets
        it, through the EOI markers it inserts each time the data runs out
        (two here: a stream cut inside a scan header takes a byte of the
        first)."""
        frame, pixels = decode_jpeg_stream(data + b"\xff\xd9" * 2, self.tables, self.color)
        fw, fh = frame.width, frame.height
        if fw < width or fh < rows:
            raise ImageDecodeError(f"TIFF {where}: its JPEG image of {fw} × {fh} is smaller than the {width} × {rows} "
                                   f"it fills (libtiff leaves the rest undefined)")
        if (fw > width or fh > rows) and not (fw == width and last_strip):
            raise ImageDecodeError(f"TIFF {where}: JPEG image of {fw} × {fh} exceeds the {width} × {rows} expected")
        if len(frame.ids) != self.components:
            raise ImageDecodeError(f"TIFF {where}: JPEG has {len(frame.ids)} components for {self.components}")
        factors = list(zip(frame.h, frame.v))
        if factors[0] != self.sampling or any(f != (1, 1) for f in factors[1:]):
            raise ImageDecodeError(f"TIFF {where}: improper JPEG sampling factors {factors} (expected "
                                   f"{self.sampling} for the first component)")
        return pixels[:rows, :width]


# -- old-style JPEG (compression 6) -------------------------------------------------------------


class _OldJpeg:
    """libtiff's tif_ojpeg.c over one image of YCbCr strips, as the RGBA
    reader drives it: the JPEGInterchangeFormat bytes and then every
    strip's, read as one stream (OJPEGReadBufferFill); its markers up to
    SOS read as OJPEGReadHeaderInfoSec reads them, or, where the stream
    starts with no marker, the frame built from the tags (the tables of
    JPEGQTables, JPEGDCTables and JPEGACTables, YCbCrSubsampling or its
    2 × 2 default, the image's size); the subsampling the stream's SOF
    names taking the tag's place (OJPEGSubsamplingCorrect); one libjpeg
    session over the stream libtiff writes for it (SOI, the tables, DRI,
    SOF and SOS regenerated, then the data after SOS with an RST marker
    after each strip but the last, then EOI for ever), whose raw data (no
    upsampling, no color conversion) comes out in YCbCr data units.

    A strip with no byte count, or one past the end, reads on to the end
    of the file, so strips may repeat the file's bytes many times over:
    the stream is kept as stretches of the file that the decoder reads in
    place. Two bounds a file of one image's strips never meets: the
    markers before SOS are read from the stream's first file-size bytes,
    and a stream of more than _MAX_STREAM bytes raises."""

    _MAX_STREAM = 1 << 32

    def __init__(self, raw: bytes, d: _Directory, width: int, height: int, offsets, counts):
        if TILE_OFFSETS in d.tags:
            raise UnsupportedImageFormat("tiled old-style JPEG TIFF")
        if d.one(PLANAR, 1) != 1:
            raise UnsupportedImageFormat("planar old-style JPEG TIFF")
        rps = d.one(ROWS_PER_STRIP, height) or height
        tag = d.get(YCBCR_SUBSAMPLING)
        hs, vs = tuple(tag) if tag is not None and len(tag) == 2 else (2, 2)
        pieces, ends = self._source(raw, d, offsets, counts)
        header = _OldJpegHeader(_OldJpeg._head(raw, pieces), width, height, sum(n for _, n in pieces) > len(raw))
        if header.sof is not None:  # OJPEGSubsamplingCorrect: the SOF's factors win
            comps = header.sof[3]
            hs, vs = comps[0][1] >> 4, comps[0][1] & 15
            if hs not in (1, 2, 4) or vs not in (1, 2, 4) or any(hv != 0x11 for _, hv, _ in comps[1:]):
                raise ImageDecodeError("old-style JPEG TIFF whose SOF sampling libtiff leaves to libjpeg to "
                                       "upsample (and then refuses: max_h_samp_factor)")
        restart = d.one(JPEG_RESTART, 0) or 0
        if rps < height:
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise ImageDecodeError(f"old-style JPEG TIFF subsampled {hs}×{vs} (libtiff: invalid subsampling)")
            if rps % (8 * vs):
                raise ImageDecodeError(f"old-style JPEG TIFF strips of {rps} rows under vertical subsampling {vs} "
                                       "(libtiff: incompatible strip length)")
            restart = -(-width // (8 * hs)) * (rps // (8 * vs))
        self.hs, self.vs = hs, vs
        stream, data = header.regenerate(d, raw, hs, vs, restart, width, height, pieces, len(pieces) - len(ends))
        frame, units = decode_jpeg_stream(stream, color=_UNITS, pieces=data)
        if frame.hmax != hs or frame.vmax != vs:  # OJPEGWriteHeaderInfo's check after jpeg_start_decompress
            raise ImageDecodeError(f"old-style JPEG sampling {frame.hmax}×{frame.vmax} is not the {hs}×{vs} expected")
        bad_row = frame.resync_at // frame.mcus_x * 8 if frame.resync_at is not None else None  # a unit row
        if header.empty:
            bad_row = 0
        if bad_row is not None and bad_row < -(-height // vs):
            # libtiff's resync_to_restart (or a stream with no data) is an
            # error: the strip reading that iMCU row reads as zeros, and a
            # strip after it fails to start
            strip = bad_row * vs // rps
            if strip < -(-height // rps) - 1:
                raise ImageDecodeError(f"old-style JPEG restart marker out of place in strip {strip} (libtiff fails "
                                       "the strips after it)")
            units[strip * rps // vs:] = 0
        self.units = units  # [unit rows, bytes]

    @staticmethod
    def _source(raw: bytes, d: _Directory, offsets, counts):
        """OJPEGReadBufferFill's stream → (its (offset, length) stretches of
        the file: the JPEGInterchangeFormat bytes if any, then one a strip,
        empty for a strip outside the data; where each strip ends in it)."""
        size = len(raw)
        pieces, ends, pos = [], [], 0
        at, length = d.one(JPEG_IF, 0) or 0, d.one(JPEG_IF_LENGTH, 0) or 0
        if at and at < size:
            if not length or at + length > size:
                length = size - at
            pieces.append((at, length))
            pos += length
        for i, offset in enumerate(offsets):
            count = counts[i] if counts is not None and i < len(counts) else 0
            togo = 0 if not offset or offset >= size else size - offset if not count or offset + count > size \
                else count  # a strip outside the data is skipped
            pieces.append((offset, togo))
            pos += togo
            ends.append(pos)
        if pos > _OldJpeg._MAX_STREAM:
            raise ImageDecodeError(f"old-style JPEG TIFF whose strips read {pos} bytes (past this decoder's bound of "
                                   f"{_OldJpeg._MAX_STREAM}: they repeat the file's {size} bytes over and over)")
        return pieces, ends

    @staticmethod
    def _head(raw: bytes, pieces) -> bytes:
        """The stream's first len(raw) bytes, where its markers are read."""
        head, left = [], len(raw)
        for offset, n in pieces:
            if left <= 0:
                break
            head.append(raw[offset:offset + min(n, left)])
            left -= n
        return b"".join(head)

    def block(self, y0: int, rows: int) -> np.ndarray:
        """The data units of a strip's rows, as OJPEGDecodeRaw packs them."""
        first, count = y0 // self.vs, -(-rows // self.vs)
        got = self.units[first:first + count]
        if len(got) < count:
            raise ImageDecodeError("old-style JPEG image ends before the strip")
        return got.reshape(-1)


_MARKERS = b"".join(bytes([0xFF, 0xD0 + i]) for i in range(8)) + b"\xff\xd9" * 2  # RST0-RST7, EOI twice


class _OldJpegHeader:
    """OJPEGReadHeaderInfoSec: the markers before SOS, kept as libtiff keeps
    them for the stream it writes (DQT and DHT segments by their table's
    slot, SOF and SOS fields, DRI)."""

    def __init__(self, src: bytes, width: int, height: int, cut: bool):
        self.width, self.height = width, height
        self.cut = cut  # the stream goes on past `src`
        self.qtables: Dict[int, bytes] = {}
        self.dctables: Dict[int, bytes] = {}
        self.actables: Dict[int, bytes] = {}
        self.sof = None  # (marker, lines, samples per line, [(id, hv, tq)] * 3)
        self.sos = None  # [(cs, tda)] * 3
        self.restart = None
        pos = 0
        while True:
            if pos >= len(src):
                raise self._ends()
            if src[pos] != 0xFF:
                self.data_at = pos  # no (more) markers: the frame comes from the tags
                return
            while pos < len(src) and src[pos] == 0xFF:
                pos += 1
            if pos + 1 > len(src):
                raise self._ends()
            code = src[pos]
            pos += 1
            if code == 0xD8:
                continue
            if pos + 2 > len(src):
                raise self._ends()
            length = int.from_bytes(src[pos:pos + 2], "big")
            body = src[pos + 2:pos + length]
            if length < 2 or len(body) < length - 2:
                if self.cut and length >= 2:
                    raise self._ends()
                raise ImageDecodeError(f"old-style JPEG marker FF{code:02X} is corrupt or cut")
            if code == 0xDD:
                if length != 4:
                    raise ImageDecodeError("old-style JPEG DRI is corrupt")
                self.restart = int.from_bytes(body, "big")
            elif code == 0xDB:
                self._dqt(body)
            elif code == 0xC4:
                if not body or body[0] >> 4 > 1 or body[0] & 15 > 3:
                    raise ImageDecodeError("old-style JPEG DHT is corrupt")
                (self.actables if body[0] >> 4 else self.dctables)[body[0] & 15] = src[pos - 2:pos + length]
            elif code in (0xC0, 0xC1):
                self._sof(code, body)
            elif code == 0xC3:
                raise UnsupportedImageFormat("lossless old-style JPEG TIFF (SOF3)")
            elif code == 0xDA:
                self._sos(body)
                self.data_at = pos + length
                return
            elif code != 0xFE and not 0xE0 <= code <= 0xEF:  # COM and APPn are skipped
                raise ImageDecodeError(f"old-style JPEG header holds marker FF{code:02X} (libtiff: unknown marker)")
            pos += length

    def _ends(self) -> ImageDecodeError:
        if self.cut:
            return ImageDecodeError("old-style JPEG header runs past the file's length (its strips repeat the "
                                    "file's bytes)")
        return ImageDecodeError("old-style JPEG data ends in its header")

    def _dqt(self, body: bytes) -> None:
        if not body or len(body) % 65:
            raise ImageDecodeError("old-style JPEG DQT is corrupt (libtiff reads 8-bit tables only)")
        for at in range(0, len(body), 65):
            if body[at] >> 4 or body[at] & 15 > 3:
                raise ImageDecodeError("old-style JPEG DQT holds a 16-bit or out-of-range table")
            self.qtables[body[at] & 15] = b"\xff\xdb\x00\x43" + body[at:at + 65]

    def _sof(self, code: int, body: bytes) -> None:
        if self.sof is not None:
            raise ImageDecodeError("old-style JPEG header has a second SOF")
        if len(body) != 15 or body[5] != 3:
            raise ImageDecodeError("old-style JPEG SOF does not have 3 components")
        if body[0] != 8:
            raise ImageDecodeError(f"old-style JPEG of {body[0]}-bit samples")
        lines, samples = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big")
        if lines < self.height or samples != self.width:
            raise ImageDecodeError(f"old-style JPEG frame of {samples} × {lines} for an image of {self.width} × "
                                   f"{self.height}")
        self.sof = (code, lines, samples, [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(3)])

    def _sos(self, body: bytes) -> None:
        if self.sof is None:
            raise ImageDecodeError("old-style JPEG SOS before any SOF")
        if len(body) != 10 or body[0] != 3:
            raise ImageDecodeError("old-style JPEG SOS is corrupt")
        self.sos = [(body[1 + 2 * i], body[2 + 2 * i]) for i in range(3)]

    def regenerate(self, d: _Directory, raw: bytes, hs: int, vs: int, restart: int, width: int, height: int,
                   pieces, first_strip: int):
        """The stream libtiff hands libjpeg (OJPEGWriteStream) → (its
        markers through SOS, the pieces of its data for decode_jpeg_stream:
        the file's bytes with RST and EOI markers after them, and the
        stretches of those read in order)."""
        if self.restart is not None:
            restart = self.restart  # the stream's DRI, read after the strips' interval was set
        if self.sof is None:
            tq, tda = self._tables_from_tags(d, raw)
            sof = (0xC0, height, width, [(c, (hs << 4) | vs if c == 0 else 0x11, tq[c]) for c in range(3)])
            sos = [(c, tda[c]) for c in range(3)]
        elif self.sos is None:  # libtiff's SOS would name components 0, 0, 0, which the frame lacks
            raise ImageDecodeError("old-style JPEG stream has a SOF but no SOS")
        else:
            sof, sos = self.sof, self.sos
        code, lines, samples, comps = sof
        if lines > 0xFFFF or samples > 0xFFFF:
            raise ImageDecodeError(f"old-style JPEG frame of {samples} × {lines} (JPEG's limit is 65535 each way)")
        out = bytearray(b"\xff\xd8")
        for tables in (self.qtables, self.dctables, self.actables):
            for index in range(4):
                out += tables.get(index, b"")
        if restart:
            out += b"\xff\xdd\x00\x04" + restart.to_bytes(2, "big")
        out += bytes([0xFF, code, 0, 17, 8]) + lines.to_bytes(2, "big") + samples.to_bytes(2, "big") + b"\x03"
        out += b"".join(bytes(c) for c in comps)
        out += b"\xff\xda\x00\x0c\x03" + b"".join(bytes(c) for c in sos) + b"\x00\x3f\x00"
        # the data after SOS, an RST marker after each strip but the last
        # that read any of it (the RSTs and EOI follow the file's bytes)
        markers = len(raw)
        data, pos, added, index = [], 0, False, 0
        for k, (offset, n) in enumerate(pieces):
            lo = max(pos, self.data_at)
            if pos + n > lo:
                data.append((offset + lo - pos, pos + n - lo))
                added = True
            pos += n
            strip = k - first_strip
            if strip >= 0:
                if added and strip + 1 < len(pieces) - first_strip:
                    data.append((markers + 2 * index, 2))
                    index = (index + 1) % 8
                added = False
        self.empty = not data  # no data: libjpeg's first read of it fails (OJPEGReadBufferFill at EOF)
        data.append((markers + 16, 4))
        return bytes(out), (np.frombuffer(raw + _MARKERS, np.uint8), np.array(data, np.int64))

    def _tables_from_tags(self, d: _Directory, raw: bytes):
        """OJPEGReadHeaderInfoSecTables{QTable,DcTable,AcTable}: each table
        read at its tag's offset, a component whose offset repeats the one
        before sharing its table → (Tq, Td << 4 | Ta) of each component."""
        tq, tda = [0, 0, 0], [0, 0, 0]
        for tag in (JPEG_QTABLES, JPEG_DCTABLES, JPEG_ACTABLES):
            offsets = (list(d.get(tag, ())) + [0] * 3)[:3]
            if not offsets[0]:
                raise ImageDecodeError("old-style JPEG TIFF has neither JPEGInterchangeFormat nor its JPEG tables "
                                       "(libtiff: missing JPEG tables)")
            for m in range(3):
                if offsets[m] and (m == 0 or offsets[m] != offsets[m - 1]):
                    if any(offsets[m] == offsets[n] for n in range(m - 1)):
                        raise ImageDecodeError(f"old-style JPEG TIFF's tag {tag} repeats an offset")
                    at = offsets[m]
                    if tag == JPEG_QTABLES:
                        table = raw[at:at + 64]
                        if len(table) != 64:
                            raise ImageDecodeError("old-style JPEG TIFF's quantization table lies past the end")
                        self.qtables[m] = b"\xff\xdb\x00\x43" + bytes([m]) + table
                        tq[m] = m
                        continue
                    counts = raw[at:at + 16]
                    symbols = raw[at + 16:at + 16 + sum(counts)]
                    if len(counts) != 16 or len(symbols) != sum(counts):
                        raise ImageDecodeError("old-style JPEG TIFF's Huffman table lies past the end")
                    body = bytes([m if tag == JPEG_DCTABLES else 16 | m]) + counts + symbols
                    segment = b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body
                    if tag == JPEG_DCTABLES:
                        self.dctables[m], tda[m] = segment, m << 4
                    else:
                        self.actables[m], tda[m] = segment, tda[m] | m
                elif m and tag == JPEG_QTABLES:
                    tq[m] = tq[m - 1]
                elif m and tag == JPEG_DCTABLES:
                    tda[m] = tda[m - 1]
                elif m:
                    tda[m] = (tda[m] & 0xF0) | (tda[m - 1] & 0x0F)
        return tq, tda


# -- YCbCr through libtiff's RGBA reader ----------------------------------------------------------


def _ycbcr_units(units: np.ndarray, width: int, rows: int, hs: int, vs: int, skip: int, luma: np.ndarray,
                 ref: np.ndarray) -> np.ndarray:
    """Packed YCbCr data units → RGB [rows, width, 3], `skip` units after
    each unit row (native/tiff_color.cpp's tiff_ycbcr)."""
    out = np.empty((rows, width, 3), np.uint8)
    status = _native("tiff_color").tiff_ycbcr(_ptr(units), len(units), width, rows, hs, vs, skip,
                                              luma.ctypes.data_as(_F32P), ref.ctypes.data_as(_F32P), _ptr(out))
    if status:
        raise ImageDecodeError(f"TIFF YCbCr data libtiff's RGBA reader refuses (status {status})")
    return out


def _ycbcr_rgba(raw: bytes, d: _Directory, compression: int, width: int, height: int, planar: int) -> np.ndarray:
    """Photometric 6 that libjpeg does not convert, read as Pillow's
    _decodeAsRGBA reads it through TIFFRGBAImage: a strip or a row of
    tiles a call, in the file's own row order (the Orientation tag is left
    to Pillow's exif_transpose), reading on past a block that does not
    decode (stoponerr 0: what did decode, then zeros) or, after the call's
    first, cannot be read (zeros)."""
    predictor = d.one(PREDICTOR, 1) if compression in _PREDICTED else 1
    if predictor != 1:
        raise UnsupportedImageFormat("YCbCr TIFF with a predictor")
    old_jpeg = None
    if compression == 6 and STRIP_OFFSETS not in d.tags and TILE_OFFSETS not in d.tags \
            and (d.one(ROWS_PER_STRIP, height) or height) >= height:
        # tif_dirread.c's OJPEG hack: one strip needs no StripOffsets
        tiled, blocks, offsets, counts = False, [(0, 0, width, height)], (), ()
    else:
        tiled, blocks, offsets, counts = _layout(d, width, height)
    if compression == 6:
        # libtiff keeps as many strip offsets as strips, padded with zeros;
        # tif_ojpeg.c reads every strip itself (TIFF_NOREADRAW)
        n = len(blocks)
        offsets, counts = (tuple(a or ())[:n] + (0,) * (n - len(a or ())) for a in (offsets, counts))
        old_jpeg = _OldJpeg(raw, d, width, height, offsets, counts)
    tag = d.get(YCBCR_SUBSAMPLING)
    hs, vs = tuple(tag) if tag is not None and len(tag) == 2 else (2, 2)
    if old_jpeg is not None:  # tif_ojpeg.c answers the tag with the SOF's subsampling
        hs, vs = old_jpeg.hs, old_jpeg.vs
    luma = d.floats(YCBCR_COEFFICIENTS, 3, (0.299, 0.587, 0.114))
    ref = d.floats(REFERENCE_BLACK_WHITE, 6, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    if planar == 2 and (hs, vs) != (1, 1):
        raise ImageDecodeError(f"planar YCbCr TIFF subsampled {hs}×{vs} (libtiff's RGBA reader reads only 1×1)")
    if (hs << 4 | vs) not in (0x44, 0x42, 0x41, 0x22, 0x21, 0x12, 0x11):
        raise ImageDecodeError(f"YCbCr TIFF subsampled {hs}×{vs} (libtiff's RGBA reader has no routine for it)")
    planes = 3 if planar == 2 else 1
    if len(offsets) < len(blocks) * planes:
        raise ImageDecodeError(f"TIFF has {len(offsets)} strip or tile offsets for {len(blocks) * planes} blocks")
    if counts is None or len(counts) < len(offsets):
        raise ImageDecodeError("TIFF compressed data has no StripByteCounts or TileByteCounts")
    jpeg = _JpegCodec(raw, d, offsets, counts, 1, False) if compression == 7 else None

    bw, bh = blocks[0][2], blocks[0][3] if tiled else min(blocks[0][3], height)
    unit = hs * vs + 2 if planes == 1 else 1
    across = -(-bw // hs)
    size = -(-bh // vs) * across * unit  # TIFFStripSize / TIFFTileSize, subsampled
    # gtStripContig asks for the strip's rows rounded up to vs, in
    # scanlines of the subsampled row size over vs (a 4×4 row of an odd
    # number of units comes out 2 bytes short, which stay zero)
    scanline = across * unit // vs if planes == 1 and not tiled else None
    out = np.empty((height, width, 3), np.uint8)
    for bi, (x0, y0, _, _) in enumerate(blocks):
        if x0 == 0:
            buffers = None  # Pillow calls TIFFRGBAImageGet a strip or a row of tiles at a time: a new buffer each
        rows = bh if tiled else min(bh, height - y0)
        need = -(-rows // vs) * across * unit
        want = min(need, -(-rows // vs) * vs * scanline) if scanline is not None else need
        for plane in range(planes):
            index = plane * len(blocks) + bi
            where = f"{'tile' if tiled else 'strip'} {index}"
            if old_jpeg is not None:  # TIFF_NOREADRAW: tif_ojpeg.c reads its own stream
                if buffers is None:
                    buffers = np.zeros((planes, size), np.uint8)
                if want % (across * unit) == 0:  # else OJPEGDecodeRaw: "Fractional scanline not read"
                    buffers[plane, :want] = old_jpeg.block(y0, rows)[:want]
                continue
            try:
                data = _strip_bytes(raw, offsets, counts, index, size, 1, where)
            except ImageDecodeError:
                if buffers is None:
                    raise  # the call's first block read makes its buffer
                buffers[plane] = 0  # a later one reads as zeros
                continue
            if buffers is None:
                buffers = np.zeros((planes, size), np.uint8)
            if jpeg is None:
                _decompress_into(data, compression, buffers[plane, :want])
                continue
            try:
                buffers[plane, :rows * bw] = jpeg.block(data, bw, rows, not tiled and y0 + rows == height,
                                                        where).reshape(-1)
            except ImageDecodeError:
                buffers[plane] = 0  # JPEGPreDecode refused the block before any row
        units = buffers[0, :need] if planes == 1 else np.ascontiguousarray(buffers[:, :need].T).reshape(-1)
        # the put routine sees the tile clipped to the image: its units
        # past the right edge are skipped as libtiff skips them
        h, w = min(rows, height - y0), min(bw, width - x0)
        step = hs if planes == 1 else 1
        out[y0:y0 + h, x0:x0 + w] = _ycbcr_units(units, w, h, step, vs if planes == 1 else 1, (bw - w) // step,
                                                 luma, ref)
    return out
