"""Image bytes → RGB uint8 without Pillow (the reference decodes with
``Image.open(...).convert("RGB")``, dsocr_tpu/server/messages.py and
cli/app.py; the card's machine has no Pillow).

``decode_image(raw)`` returns (H, W, 3) uint8, bit-equal to Pillow's
``convert("RGB")`` (Pillow 12.1 over libjpeg-turbo 3.1, libtiff 4.7,
LittleCMS 2.17 and libwebp 1.6), for PNG and JPEG (here), and TIFF, BMP,
GIF and WebP (image/tiff.py, bmp.py, gif.py and webp.py, which the
dispatch below imports at first use; their codecs are native/tiff.cpp,
tiff_color.cpp, bmp.cpp, gif.cpp, webp_lossless.cpp and webp_lossy.cpp,
built and loaded by ``_native``).

PNG in full: color types 0, 2, 3, 4 and 6 at every bit depth the spec
allows (1, 2, 4, 8, 16), palettes, ``tRNS`` (alpha is dropped, not
composited, as ``convert("RGB")`` does), Adam7 interlace, the five filter
types (unfiltered by native/png.cpp) and any number of ``IDAT`` chunks;
every chunk's CRC is checked. Where Pillow maps samples the conversion
follows it:

- 1-, 2- and 4-bit grey scale to 0..255 (× 255, 85, 17);
- 16-bit grey (Pillow's "I;16") clips at 255, as Pillow's I;16 → L does;
- 16-bit RGB, RGBA and grey+alpha keep the high byte;
- a palette index past the PLTE entries reads black.

JPEG (ITU-T T.81): Huffman-coded baseline, extended sequential and
progressive frames (SOF0, SOF1, SOF2) at 8 bits with 1, 3 or 4
components, any integer sampling ratio, interleaved and non-interleaved
scans, restart intervals, 8- and 16-bit quantization tables, tables
redefined between scans and libjpeg's standard Huffman tables where a
sequential file defines none (Motion-JPEG frames). This module parses
the markers and picks the color space as libjpeg does (JFIF → YCbCr;
else Adobe transform 0 → RGB, another → YCbCr; else component ids R, G,
B → RGB; 4 components: CMYK, or YCCK under an Adobe transform other
than 0), unless the caller names one: ``decode_jpeg_stream`` is the
entry point for one JPEG-in-TIFF strip or tile, with the tables the
decoder holds from JPEGTables and the strips before (``JpegTables``) and
the color space libtiff sets from Photometric (YCbCr → RGB, or the
components as they are, for which jpeg_output writes every component);
native/jpeg.cpp decodes each scan and then dequantizes, runs libjpeg's
``islow`` IDCT, upsamples (libjpeg's fancy upsampling) and converts into
the output. 4-component files go through Pillow's inverted "CMYK;I"
reading and its CMYK → RGB. Neither EXIF orientation nor an ICC profile
is applied (Pillow's ``convert`` applies neither). Refused by name with
``UnsupportedImageFormat``: arithmetic coding (SOF9-11, SOF13-15),
lossless (SOF3), hierarchical (SOF5-7, DHP), a precision other than 8
bits, a component count other than 1, 3 or 4, and a progressive file
whose scans leave some of the first nine AC coefficients' bits unsent,
which libjpeg would smooth (block smoothing is not ported; Pillow's
writer always completes them). Bytes libjpeg rejects (an unknown
marker, a table missing or malformed, scan parameters out of range, more
than 178,956,970 pixels as Pillow's decompression-bomb limit) raise
``ImageDecodeError``, as does data that ends before EOI, but for one
case: a one-pass file (a single baseline scan) whose scan is whole
decodes as Pillow keeps it, unless its data ends less than libjpeg's
57-bit read-ahead after the scan (Pillow's outcome there depends on its
bit reader's state; the port raises). Damaged entropy data that libjpeg
only warns about decodes as libjpeg decodes it.

Bytes with no known magic raise ``UnsupportedImageFormat``, as do the
variants each decoder refuses by name (old-style JPEG-in-TIFF, Zstandard
TIFF, BMP with embedded JPEG or PNG, ...); broken data raises
``ImageDecodeError``.
"""

from __future__ import annotations

import ctypes
import pathlib
import struct
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"), (b"MM\x00+", "TIFF"))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_U8P, _I16P, _U16P = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int16, ctypes.c_uint16))
_I32P, _I64P, _I, _I64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "png": {"png_unfilter": [_U8P, _I, _I, _I, _U8P]},
    "tiff": {"tiff_lzw": [_U8P, _I64, _U8P, _I64], "tiff_packbits": [_U8P, _I64, _U8P, _I64],
             "tiff_fax": [_U8P, _I64, _U8P, _I, _I, _I, _I, _I32P]},
    "tiff_color": {"tiff_ycbcr": [_U8P, _I64, _I, _I, _I, _I, _I, _F32P, _F32P, _U8P], "tiff_lab": [_U8P, _I64, _U8P]},
    "bmp": {"bmp_rle": [_U8P, _I64, _I64, _I, _I, _I, _U8P, _I64P]},
    "gif": {"gif_lzw": [_U8P, _I64, _I, _U8P, _I64]},
    "webp_lossless": {"webp_lossless": [_U8P, _I64, _U8P, _I64, _I, _I, _I],
                      "webp_alpha_lossless": [_U8P, _I64, _I, _I, _U8P], "webp_alpha_unfilter": [_U8P, _I, _I, _I]},
    "webp_lossy": {"webp_lossy": [_U8P, _I64, _U8P, _I64, _I, _I, _I]},
    "jpeg": {"jpeg_scan": [_U8P, _I64, _I64, _I32P, _U8P, _I16P, _I64P, _I64P, ctypes.c_char_p, _I],
             "jpeg_output": [_I16P, _I64P, _I32P, _U16P, _U8P]},
}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class ImageDecodeError(ValueError):
    """Image bytes that do not decode."""


class UnsupportedImageFormat(ImageDecodeError):
    """An image format the decoder does not read; ``format`` names it."""

    def __init__(self, fmt: str):
        super().__init__(f"{fmt} images are not supported (PNG, Huffman-coded JPEG, TIFF, BMP, GIF and WebP are read)")
        self.format = fmt


def image_format(raw: bytes) -> str:
    """The format named by the magic bytes: PNG, JPEG, GIF, WebP, BMP,
    TIFF or "unknown"."""
    if raw.startswith(PNG_SIGNATURE):
        return "PNG"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _MAGIC:
        if raw.startswith(magic):
            return name
    return "unknown"


def decode_image(raw: bytes) -> np.ndarray:
    """Image bytes → (H, W, 3) uint8, as Pillow's convert("RGB") gives it."""
    fmt = image_format(bytes(raw[:16]))
    if fmt == "PNG":
        return decode_png(bytes(raw))
    if fmt == "JPEG":
        return decode_jpeg(bytes(raw))
    if fmt == "TIFF":
        from .tiff import decode_tiff

        return decode_tiff(bytes(raw))
    if fmt == "BMP":
        from .bmp import decode_bmp

        return decode_bmp(bytes(raw))
    if fmt == "GIF":
        from .gif import decode_gif

        return decode_gif(bytes(raw))
    if fmt == "WebP":
        from .webp import decode_webp

        return decode_webp(bytes(raw))
    if fmt == "unknown":
        raise UnsupportedImageFormat("unrecognized (no known magic bytes)")
    raise UnsupportedImageFormat(fmt)


def _native(stem: str) -> ctypes.CDLL:
    """native/<stem>.cpp built (at first use) and loaded, its functions
    typed (the format modules call it too)."""
    with _lock:
        if stem not in _libs:
            from ..native.resample import build

            handle = ctypes.CDLL(str(build(pathlib.Path(__file__).resolve().parents[1] / "native" / f"{stem}.cpp")))
            for name, argtypes in _SIGNATURES[stem].items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[stem] = handle
        return _libs[stem]


def _unfilter(data: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    src = np.frombuffer(data, np.uint8)
    dst = np.empty((rows, stride), np.uint8)
    bad = _native("png").png_unfilter(src.ctypes.data_as(_U8P), rows, stride, bpp, dst.ctypes.data_as(_U8P))
    if bad >= 0:
        raise ImageDecodeError(f"PNG row {bad} has filter type {data[bad * (stride + 1)]} (0-4 allowed)")
    return dst


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered scanlines → (h, width, channels) samples (uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, width, channels)
    # depth 1, 2, 4: one channel (grey or palette index), high bits first
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return unpacked.reshape(h, -1)[:, :width, None]


def _chunks(raw: bytes):
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(raw):
            raise ImageDecodeError("PNG data is truncated (no IEND chunk)")
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        crc = raw[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageDecodeError(f"PNG data is truncated inside the {kind.decode('latin-1')} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ImageDecodeError(f"PNG CRC error in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def decode_png(raw: bytes) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _chunks(raw):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageDecodeError("PNG has no IHDR chunk")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ImageDecodeError(f"PNG color type {ctype} at bit depth {depth} is not valid")
    if compression != 0 or filter_method != 0 or interlace not in (0, 1):
        raise ImageDecodeError(f"PNG compression {compression}, filter method {filter_method} or "
                               f"interlace {interlace} is not valid")
    if width == 0 or height == 0:
        raise ImageDecodeError("PNG has an empty size")
    if ctype == 3 and palette is None:
        raise ImageDecodeError("PNG palette image without a PLTE chunk")
    if not idat:
        raise ImageDecodeError("PNG has no IDAT chunk")
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise ImageDecodeError(f"PNG image data does not inflate: {err}") from None

    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        size = ph * (stride + 1)
        if pos + size > len(data):
            raise ImageDecodeError(f"PNG image data is truncated ({len(data)} bytes inflated)")
        rows = _unfilter(data[pos:pos + size], ph, stride, bpp)
        pos += size
        samples[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)

    if depth == 16:  # Pillow: I;16 → L clips, the 16-bit color modes keep the high byte
        samples = np.minimum(samples, 255) if ctype == 0 else samples >> 8
        samples = samples.astype(np.uint8)
    elif depth < 8 and ctype == 0:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        table[:len(entries)] = entries
        return table[samples[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(samples[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(samples[:, :, :3])


# -- JPEG ----------------------------------------------------------------------------------

# libjpeg's standard Huffman tables (T.81 Annex K.3), which libjpeg-turbo's
# sequential decoder takes for tables 0 and 1 where a file defines none
# (Motion-JPEG frames): counts, then symbols
_STD_HUFFMAN = {
    (0, 0): "00010501010101010100000000000000" "000102030405060708090a0b",
    (0, 1): "00030101010101010101010000000000" "000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d"
            "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
            "292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83848586878889"
            "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
            "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (1, 1): "00020102040403040705040400010277"
            "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
            "2728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a828384858687"
            "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
            "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}
_REFUSED_SOF = {0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
                0xC7: "hierarchical JPEG (SOF7)", 0xDE: "hierarchical JPEG (DHP)",
                0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded progressive JPEG (SOF10)",
                0xCB: "arithmetic-coded lossless JPEG (SOF11)", 0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
                0xCE: "arithmetic-coded hierarchical JPEG (SOF14)", 0xCF: "arithmetic-coded hierarchical JPEG (SOF15)"}
# jdcoefct.c's smoothing_ok: the zigzag positions 1-9 in natural order
_SMOOTHED = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
                    6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                    38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # Pillow's DecompressionBombError limit, every format's
_MAX_DIMENSION = 65500  # libjpeg's JPEG_MAX_DIMENSION
_GREY, _YCC, _RGB, _CMYK, _YCCK, _RAW = range(6)  # jpeg_output's color spaces


def _huffman_spec(counts: bytes, symbols: bytes) -> np.ndarray:
    spec = np.zeros(272, np.uint8)
    spec[:16] = np.frombuffer(counts, np.uint8)
    spec[16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    return spec


class _Frame:
    """A SOF's frame and the whole-image coefficient planes its scans fill."""

    def __init__(self, kind: int, body: bytes, at: int):
        if len(body) < 6:
            raise ImageDecodeError(f"JPEG SOF{kind - 0xC0} at byte {at} is too short")
        precision, self.height, self.width, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise UnsupportedImageFormat(f"{precision}-bit JPEG")
        if n not in (1, 3, 4):
            raise UnsupportedImageFormat(f"{n}-component JPEG")
        if len(body) != 6 + 3 * n:
            raise ImageDecodeError(f"JPEG SOF{kind - 0xC0} at byte {at} has a bad length")
        if self.height == 0 or self.width == 0:
            raise ImageDecodeError("JPEG frame has an empty size (a height defined by DNL is not read)")
        if self.height > _MAX_DIMENSION or self.width > _MAX_DIMENSION or self.width * self.height > MAX_PIXELS:
            raise ImageDecodeError(f"JPEG frame of {self.width} × {self.height} is too large")
        self.progressive = kind == 0xC2
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ImageDecodeError(f"JPEG component {cid} has sampling factors {hv >> 4}×{hv & 15} (1-4 allowed)")
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcus_x = -(-self.width // (8 * self.hmax))
        self.mcus_y = -(-self.height // (8 * self.vmax))
        sizes = [self.mcus_x * h * self.mcus_y * v * 64 for h, v in zip(self.h, self.v)]
        self.offsets = np.cumsum([0] + sizes[:-1]).astype(np.int64)
        self.coefs = np.zeros(sum(sizes), np.int16)
        self.quant: List[Optional[np.ndarray]] = [None] * n  # latched at each component's first scan
        self.coef_bits = np.full((n, 64), -1, np.int32)  # progressive: the Al each coefficient last took

    def blocks(self, ci: int):
        """(plane stride, blocks a row, block rows) of component ci."""
        dw = -(-self.width * self.h[ci] // self.hmax)
        dh = -(-self.height * self.v[ci] // self.vmax)
        return self.mcus_x * self.h[ci], -(-dw // 8), -(-dh // 8)

    def smoothed(self) -> bool:
        """libjpeg-turbo would smooth this progressive image (smoothing_ok)."""
        if not self.progressive:
            return False
        for ci, q in enumerate(self.quant):
            if q is None or not q[0] or not all(q[k] for k in _SMOOTHED) or self.coef_bits[ci, 0] < 0:
                return False
        return bool((self.coef_bits[:, 1:10] != 0).any())


def _color_space(frame: _Frame, jfif: bool, adobe: Optional[int]) -> int:
    """libjpeg's default_decompress_parms."""
    if len(frame.ids) == 1:
        return _GREY
    if len(frame.ids) == 4:
        return _CMYK if adobe is None or adobe == 0 else _YCCK
    if jfif:
        return _YCC
    if adobe is not None:
        return _RGB if adobe == 0 else _YCC
    return _RGB if frame.ids == [82, 71, 66] else _YCC


def _next_marker(raw: bytes, pos: int):
    """jdmarker.c's next_marker: skip to FF, FF fill bytes and FF00 pairs
    → (marker code, offset after it), or None at the end of the data."""
    while True:
        pos = raw.find(b"\xff", pos)
        if pos < 0:
            return None
        while pos < len(raw) and raw[pos] == 0xFF:
            pos += 1
        if pos >= len(raw):
            return None
        if raw[pos]:
            return raw[pos], pos + 1
        pos += 1


class JpegTables:
    """The quantization and Huffman tables a libjpeg decompressor holds:
    they carry over from one stream to the next (a TIFF's JPEGTables,
    then each strip or tile in turn), and a stream's own DQT and DHT
    segments replace them."""

    def __init__(self):
        self.quant: List[Optional[np.ndarray]] = [None] * 4
        self.huffman: Dict[tuple, np.ndarray] = {}

    def load(self, raw: bytes) -> "JpegTables":
        """An abbreviated tables-only stream (SOI, DQT and DHT segments,
        EOI), as libjpeg's jpeg_read_header(FALSE) reads TIFF's
        JPEGTables; anything else there raises."""
        if raw[:2] != b"\xff\xd8":
            raise ImageDecodeError("TIFF JPEGTables does not start with SOI")
        pos = 2
        while True:
            found = _next_marker(raw, pos)
            if found is None:
                raise ImageDecodeError("TIFF JPEGTables ends before EOI")
            code, pos = found
            if code == 0xD9:
                return self
            if 0xD0 <= code <= 0xD7 or code == 0x01 or code == 0xD8:
                continue
            if code == 0xDA or code < 0xC0:
                raise ImageDecodeError(f"TIFF JPEGTables holds marker FF{code:02X} (tables only allowed)")
            length = struct.unpack(">H", raw[pos:pos + 2])[0] if pos + 2 <= len(raw) else None
            if length is None or length < 2 or pos + length > len(raw):
                raise ImageDecodeError("TIFF JPEGTables is truncated")
            body, at = raw[pos + 2:pos + length], pos - 2
            pos += length
            if code == 0xC4:
                _read_dht(body, at, self.huffman)
            elif code == 0xDB:
                _read_dqt(body, at, self.quant)


def decode_jpeg(raw: bytes) -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8, as Pillow's convert("RGB") gives it."""
    return decode_jpeg_stream(raw)[1]


def decode_jpeg_stream(raw: bytes, tables: Optional[JpegTables] = None, color: Optional[int] = None):
    """One JPEG stream → (its frame, its pixels). `tables`: the tables the
    decoder holds before the stream (updated by the stream's own); `color`
    a color space that replaces the one the markers name, as libtiff's
    JPEGPreDecode sets it (_YCC: YCbCr → RGB, _RAW: the components as they
    are, (H, W, components)). JPEG-in-TIFF strips and tiles
    (image/tiff.py) come through here."""
    if raw[:2] != b"\xff\xd8":
        raise ImageDecodeError("JPEG data does not start with SOI")
    data = np.frombuffer(raw, np.uint8)
    frame: Optional[_Frame] = None
    tables = tables or JpegTables()
    quant, huffman = tables.quant, tables.huffman
    forced = color
    restart, jfif, adobe, color, scans = 0, False, None, None, 0
    # A one-pass frame (one sequential scan of every component) is output
    # as its scan decodes; libjpeg then reads on to EOI, and Pillow keeps
    # the image if the data ends on the way. Other frames are read whole
    # before output: for them the end of the data before EOI is an error.
    read_whole = True
    pos = 2
    while True:
        found = _next_marker(raw, pos)
        if found is None:
            if not read_whole:
                break
            raise ImageDecodeError("JPEG data is truncated (it ends before EOI)")
        code, pos = found
        at = pos - 2
        if code == 0xD9:
            break
        if code == 0xD8:
            raise ImageDecodeError(f"JPEG has a second SOI marker at byte {at}")
        if 0xD0 <= code <= 0xD7 or code == 0x01:  # RSTn and TEM carry no segment
            continue
        if code < 0xC0 or code in (0xC8, 0xDF) or 0xF0 <= code <= 0xFD:  # reserved, JPG, EXP, JPGn
            raise ImageDecodeError(f"JPEG has an unknown marker FF{code:02X} at byte {at}")
        if code in _REFUSED_SOF:
            raise UnsupportedImageFormat(_REFUSED_SOF[code])
        if code in (0xC0, 0xC1, 0xC2) and frame is not None:  # libjpeg checks before reading on
            raise ImageDecodeError(f"JPEG has a second SOF marker at byte {at}")
        length = struct.unpack(">H", raw[pos:pos + 2])[0] if pos + 2 <= len(raw) else None
        if length is not None and length < 2:
            raise ImageDecodeError(f"JPEG marker FF{code:02X} at byte {at} has length {length}")
        if length is None or pos + length > len(raw):
            if not read_whole:
                break
            raise ImageDecodeError("JPEG data is truncated (it ends before EOI)")
        body = raw[pos + 2:pos + length]
        pos += length
        if code in (0xC0, 0xC1, 0xC2):
            frame = _Frame(code, body, at)
        elif code == 0xC4:
            _read_dht(body, at, huffman)
        elif code == 0xDB:
            _read_dqt(body, at, quant)
        elif code == 0xDD:
            if length != 4:
                raise ImageDecodeError(f"JPEG DRI at byte {at} has a bad length")
            restart = struct.unpack(">H", body)[0]
        elif code == 0xE0 and color is None and len(body) >= 14 and body.startswith(b"JFIF\x00"):
            jfif = True  # APP markers count only before the first scan, as in libjpeg
        elif code == 0xEE and color is None and len(body) >= 12 and body.startswith(b"Adobe"):
            adobe = body[11]
        elif code == 0xDA:
            if frame is None:
                raise ImageDecodeError(f"JPEG SOS at byte {at} comes before any SOF")
            if not read_whole:
                raise ImageDecodeError(f"JPEG has a scan at byte {at} after a one-pass frame's scan (EOI expected)")
            if color is None:
                color = _color_space(frame, jfif, adobe) if forced is None else forced
                if color == _YCC and len(frame.ids) != 3:
                    raise ImageDecodeError(f"JPEG with {len(frame.ids)} components read as YCbCr")
            scans += 1
            pos, unread_bits = _scan(frame, data, body, pos, at, scans, quant, huffman, restart)
            if scans == 1 and not frame.progressive and body[0] == len(frame.ids):
                if 0 <= unread_bits < 57:  # libjpeg's reader may have wanted bytes past the end
                    raise ImageDecodeError(f"JPEG data is truncated: it ends {unread_bits} bits after the scan")
                read_whole = False
        # the rest (APPn, COM, DNL, DAC) is skipped
    if frame is None or not scans:
        raise ImageDecodeError("JPEG has no image (EOI before any scan)")
    if frame.smoothed():
        raise UnsupportedImageFormat("progressive JPEG with incomplete AC refinement (libjpeg's block smoothing)")

    nc = len(frame.ids)
    params = [frame.width, frame.height, nc, color, frame.hmax, frame.vmax]
    for ci in range(nc):
        params += [frame.h[ci], frame.v[ci], frame.blocks(ci)[0]]
    latched = np.zeros((nc, 64), np.uint16)
    for ci, q in enumerate(frame.quant):
        if q is not None:
            latched[ci] = q
    params = np.array(params, np.int32)
    out = np.empty((frame.height, frame.width, nc if color == _RAW else 3), np.uint8)
    bad = _native("jpeg").jpeg_output(frame.coefs.ctypes.data_as(_I16P), frame.offsets.ctypes.data_as(_I64P),
                                      params.ctypes.data_as(_I32P), latched.ctypes.data_as(_U16P),
                                      out.ctypes.data_as(_U8P))
    if bad:
        raise ImageDecodeError(f"JPEG sampling factors {list(zip(frame.h, frame.v))} are no integer ratio")
    return frame, out


def _read_dht(body: bytes, at: int, huffman: Dict[tuple, np.ndarray]) -> None:
    pos = 0
    while len(body) - pos > 16:
        index = body[pos]
        counts = body[pos + 1:pos + 17]
        n = sum(counts)
        if n > 256 or n > len(body) - pos - 17 or index & 0x0F > 3 or index >> 4 > 1:
            raise ImageDecodeError(f"JPEG DHT at byte {at} is malformed")
        huffman[(index >> 4, index & 0x0F)] = _huffman_spec(counts, body[pos + 17:pos + 17 + n])
        pos += 17 + n
    if pos != len(body):
        raise ImageDecodeError(f"JPEG DHT at byte {at} has a bad length")


def _read_dqt(body: bytes, at: int, quant: List[Optional[np.ndarray]]) -> None:
    pos = 0
    while pos < len(body):
        precision, index = body[pos] >> 4, body[pos] & 0x0F
        size = 128 if precision else 64
        if index > 3 or pos + 1 + size > len(body):
            raise ImageDecodeError(f"JPEG DQT at byte {at} is malformed")
        values = np.frombuffer(body, ">u2" if precision else np.uint8, 64, pos + 1)
        table = np.zeros(64, np.uint16)
        table[_ZIGZAG] = values
        quant[index] = table
        pos += 1 + size


def _scan(frame: _Frame, data: np.ndarray, body: bytes, pos: int, at: int, number: int,
          quant: List[Optional[np.ndarray]], huffman: Dict[tuple, np.ndarray], restart: int) -> int:
    """One SOS: check its header, latch its quantization tables, decode
    its entropy-coded data natively → (the offset where markers resume,
    the data bits left to the end of the file, or -1 where a marker comes
    first)."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise ImageDecodeError(f"JPEG SOS at byte {at} has a bad length")
    Ss, Se, Ah, Al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    where = f"JPEG scan {number} (SOS at byte {at})"
    comps = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in frame.ids or frame.ids.index(cid) in [c for c, _, _ in comps]:
            raise ImageDecodeError(f"{where}: component id {cid} is not in the frame or repeated")
        comps.append((frame.ids.index(cid), tables >> 4, tables & 15))
    if ns > 1 and sum(frame.h[c] * frame.v[c] for c, _, _ in comps) > 10:
        raise ImageDecodeError(f"{where}: an MCU of more than 10 blocks")
    if frame.progressive:  # jdphuff.c's start_pass_phuff_decoder
        dc = Ss == 0
        if (dc and Se != 0) or (not dc and (Ss > Se or Se > 63 or ns != 1)) or (Ah and Al != Ah - 1) or Al > 13:
            raise ImageDecodeError(f"{where}: bad progression parameters Ss={Ss} Se={Se} Ah={Ah} Al={Al}")
        for c, _, _ in comps:
            frame.coef_bits[c, Ss:Se + 1] = Al
    need_dc = not frame.progressive or (Ss == 0 and Ah == 0)
    need_ac = not frame.progressive or Ss > 0
    tables = np.zeros((ns, 2, 272), np.uint8)
    params = [int(frame.progressive), ns, Ss, Se, Ah, Al, restart, frame.mcus_x, frame.mcus_y]
    for i, (c, td, ta) in enumerate(comps):
        if frame.quant[c] is None:
            if frame.tq[c] > 3 or quant[frame.tq[c]] is None:
                raise ImageDecodeError(f"{where}: quantization table {frame.tq[c]} is not defined")
            frame.quant[c] = quant[frame.tq[c]].copy()
        for k, (needed, index) in enumerate(((need_dc, td), (need_ac, ta))):
            if not needed:
                continue
            spec = huffman.get((k, index))
            if spec is None and index <= 1 and not frame.progressive:  # jdhuff.c's, not jdphuff.c's
                std = bytes.fromhex(_STD_HUFFMAN[(k, index)])
                spec = _huffman_spec(std[:16], std[16:])
            if spec is None:
                raise ImageDecodeError(f"{where}: {'AC' if k else 'DC'} Huffman table {index} is not defined")
            tables[i, k] = spec
        params += [c, frame.h[c], frame.v[c], *frame.blocks(c)]
    params = np.array(params, np.int32)
    out = np.zeros(3, np.int64)
    msg = ctypes.create_string_buffer(160)
    status = _native("jpeg").jpeg_scan(data.ctypes.data_as(_U8P), len(data), pos, params.ctypes.data_as(_I32P),
                                       tables.ctypes.data_as(_U8P), frame.coefs.ctypes.data_as(_I16P),
                                       frame.offsets.ctypes.data_as(_I64P), out.ctypes.data_as(_I64P), msg, len(msg))
    if status == 1:
        raise ImageDecodeError(f"JPEG data is truncated: {where} ends at MCU {out[1]}")
    if status:
        raise ImageDecodeError(f"{where}, MCU {out[1]}: {msg.value.decode()}")
    return int(out[0]), int(out[2])
