"""TIFF bytes → RGB uint8, bit-equal to Pillow's ``Image.open(...).convert("RGB")``
(Pillow 12.1 over libtiff 4.7), without Pillow.

The first IFD only (what ``Image.open`` gives), classic or BigTIFF, either
byte order. Pillow's own table (``TiffImagePlugin.OPEN_INFO``) decides what
opens: the key (byte order, photometric, sample format, fill order, bits
per sample, extra samples), built as Pillow builds it, names a raw mode.
This module reads the rows of that table with photometric 0, 1, 2, 3 or 5
at 1, 2, 4, 8 or 16 bits (``_RAWMODES``); a key outside the table raises
``ImageDecodeError`` as Pillow's "unknown pixel mode" does, and the rows
of the table this module does not read (12- and 32-bit samples, YCbCr,
CIELab) raise ``UnsupportedImageFormat`` naming them.

Data: strips or tiles, PlanarConfiguration 1 and 2, compression 1 (none),
32773 (PackBits), 5 (LZW, new and old style), 8 and 32946 (Deflate), 2
(CCITT modified Huffman), 3 (T.4, 1-D and 2-D) and 4 (T.6); the codecs
but Deflate are native/tiff.cpp's. JPEG-in-TIFF (6, 7) and every other
compression raise ``UnsupportedImageFormat``. Pillow decodes compressed
data through libtiff and uncompressed data with its own unpackers, and
the two differ; each is followed:

- compressed: the strip's StripByteCounts bytes decode to its rows (a
  count over 1 MiB and over 10 × the strip's size + 4096 cut to that, as
  libtiff's TIFFFillStrip cuts it), and data that decodes short raises
  (libtiff's "Not enough data"); Predictor
  2 undoes horizontal differencing of 8- and 16-bit samples (another
  predictor, or one at another depth, raises as libtiff does); FillOrder 2
  reverses the bits of each data byte before decoding; planar data with
  as many samples as Pillow's mode has bands reads (16-bit planes by
  their high byte), and other planar data raises as Pillow's reader does;
- uncompressed: StripByteCounts are not read; FillOrder 2 reverses the
  bits of each byte, but for the four raw modes Pillow has no unpacker
  for (L;IR, P;1R, P;2R, P;4R), which raise; planar data takes one
  character of the raw mode per plane as Pillow's tile loop does (a
  plain one-band unpacker: no inversion, no bit reversal), so RGB, RGBA
  and CMYK planes read at 8 bits, a plane without an unpacker raises
  ``ImageDecodeError``, and planes Pillow would read at the wrong depth
  (16-bit, or one 2- or 4-bit sample) raise ``UnsupportedImageFormat``.

The samples then map to RGB as Pillow's unpackers and ``convert("RGB")``
map them: 1-, 2- and 4-bit grey × 255, 85, 17 (photometric 0 inverted),
16-bit grey clipped at 255 (signed: clipped to 0..255), 16-bit colour by
its high byte, palettes through ColorMap // 256, alpha and other extra
samples dropped, premultiplied alpha (ExtraSamples 1) divided out
(``c * 255 // a``, 0 where a is 0), CMYK through Pillow's cmyk2rgb. The
Orientation tag (274) transposes the result as Pillow's load does
(``ImageOps.exif_transpose``). More than 178,956,970 pixels raise, as
Pillow's decompression-bomb check does.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .decode import MAX_PIXELS, ImageDecodeError, UnsupportedImageFormat, _native

II, MM = b"II", b"MM"

# tag numbers
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
PLANAR, T4_OPTIONS, PREDICTOR, COLORMAP = 284, 292, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT = 322, 323, 324, 325, 338, 339

# field type → (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("l", 4), 10: ("ll", 8), 11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8), 17: ("q", 8),
          18: ("Q", 8)}
_READ = {1: "none", 2: "CCITT modified Huffman", 3: "CCITT T.4", 4: "CCITT T.6", 5: "LZW", 8: "Deflate",
         32773: "PackBits", 32946: "Deflate"}
_REFUSED = {6: "old-style JPEG", 7: "JPEG", 32771: "CCITT RLEW", 32809: "ThunderScan", 34676: "SGILog",
            34677: "SGILog24", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}

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
# OPEN_INFO rows not read here: (photometric, bits) → what they are
_UNREAD = {(1, (12,)): "12-bit grey TIFF", (0, (32,)): "32-bit TIFF", (1, (32,)): "32-bit TIFF",
           (6, (8,)): "YCbCr TIFF", (6, (8, 8, 8)): "YCbCr TIFF", (8, (8, 8, 8)): "CIELab TIFF"}
# raw modes of OPEN_INFO that Pillow's own (uncompressed) reader has no
# unpacker for, and the one-band unpackers its planar tile loop finds
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}
_PLANE_UNPACKERS = {"1": "1", "L": "L", "P": "P", "RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

_U8P = ctypes.POINTER(ctypes.c_uint8)
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
                values = tuple(a / b if b else 0.0 for a, b in zip(values[::2], values[1::2]))
            self.tags[tag] = values

    def get(self, tag: int, default=None):
        return self.tags.get(tag, default)

    def one(self, tag: int, default=None):
        """A tag Pillow reads as one value (its first)."""
        values = self.tags.get(tag)
        return default if not values else values[0]


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


def _decompress(data: bytes, compression: int, want: int, width: int, rows: int, t4: int, where: str) -> np.ndarray:
    """One strip or tile's data → its `want` decoded bytes."""
    if compression in (8, 32946):
        return _inflate(data, want, where)
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


def _undo_predictor(rows: np.ndarray, width: int, spp: int, bits: int, endian: str) -> np.ndarray:
    """Horizontal differencing undone on decoded rows [n, bytes]."""
    if bits == 8:
        s = rows[:, :width * spp].reshape(len(rows), width, spp)
        out = np.cumsum(s, axis=1, dtype=np.uint8)
        return out.reshape(len(rows), -1)
    s = rows[:, :width * spp * 2].copy().view(endian + "u2").reshape(len(rows), width, spp)
    out = np.cumsum(s, axis=1, dtype=np.uint16).astype(endian + "u2")
    return out.reshape(len(rows), -1).view(np.uint8)


def _samples(rows: np.ndarray, width: int, spp: int, bits: int, endian: str) -> np.ndarray:
    """Decoded rows [n, bytes] → samples [n, width, spp] (uint16 at 16 bits)."""
    n = len(rows)
    if bits == 16:
        return rows[:, :width * spp * 2].copy().view(endian + "u2").reshape(n, width, spp).astype(np.uint16)
    if bits == 8:
        return rows[:, :width * spp].reshape(n, width, spp)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
    return unpacked.reshape(n, -1)[:, :width, None]


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb: nk - MULDIV255(c, nk), nk = 255 - k."""
    c = cmyk[..., :3].astype(np.int32)
    nk = 255 - cmyk[..., 3:4].astype(np.int32)
    t = c * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    a = alpha.astype(np.int32)[..., None]
    out = np.where(a == 0, 0, np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255))
    return out.astype(np.uint8)


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
    elif mode in ("I;16", "I;16B"):
        grey = np.minimum(v, 255).astype(np.uint8)
    elif mode == "I":  # signed 16-bit samples
        grey = np.clip(v.astype(np.uint16).view(np.int16), 0, 255).astype(np.uint8)
    elif mode == "LA":
        grey = v
    elif mode in ("P", "PA"):
        return palette[v]
    else:
        if s.dtype == np.uint16:
            s = (s >> 8).astype(np.uint8)
        if mode == "CMYK":
            return _cmyk_to_rgb(s[..., :4])
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
    photo = d.one(PHOTOMETRIC, 0)
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
    spp = d.one(SAMPLES, 1)
    if spp > 6:
        raise ImageDecodeError(f"TIFF has {spp} samples per pixel")
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ImageDecodeError("TIFF BitsPerSample does not match SamplesPerPixel")
    order = d.order
    if bits == (16,) and (order, photo, sample_format, fill) in _GREY16:
        mode, rawmode = _GREY16[(order, photo, sample_format, fill)]
    elif (photo, sample_format, fill, bits, extra) in _RAWMODES:
        mode, rawmode = _RAWMODES[(photo, sample_format, fill, bits, extra)]
    elif (photo, bits) in _UNREAD or (photo in (0, 1) and bits == (32,)):
        raise UnsupportedImageFormat(_UNREAD.get((photo, bits), "32-bit TIFF"))
    else:
        raise ImageDecodeError(f"TIFF pixel layout is not one Pillow reads (photometric {photo}, sample format "
                               f"{sample_format}, fill order {fill}, bits {bits}, extra samples {extra})")
    planar = d.one(PLANAR, 1)
    if planar not in (1, 2):
        raise ImageDecodeError(f"TIFF PlanarConfiguration {planar}")
    depth = bits[0]
    if compression in (2, 3, 4) and (depth != 1 or spp != 1):
        raise ImageDecodeError("TIFF CCITT compression needs one 1-bit sample")

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

    samples, rawmode = _read_samples(raw, d, compression, width, height, spp, depth, planar, fill, rawmode, mode)
    out = _to_rgb(samples, mode, rawmode, depth, rawmode.startswith("RGBa"), palette)
    orientation = d.one(ORIENTATION, 1)
    if orientation in _TRANSPOSE:
        out = np.ascontiguousarray(_TRANSPOSE[orientation](out))
    return out


def _read_samples(raw: bytes, d: _Directory, compression: int, width: int, height: int, spp: int, depth: int,
                  planar: int, fill: int, rawmode: str, mode: str) -> Tuple[np.ndarray, str]:
    """Every strip or tile → (samples [H, W, spp], the raw mode Pillow
    unpacks them with)."""
    endian = d.endian
    compressed = compression != 1
    predictor = d.one(PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise ImageDecodeError(f"TIFF Predictor {predictor} is not read for integer samples")
    if predictor == 2 and depth not in (8, 16):
        raise ImageDecodeError(f"TIFF horizontal predictor with {depth}-bit samples")
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
    # libtiff hands Pillow native-order samples, which Pillow's I;16BS
    # unpacker reads as big-endian: the values come out byte-swapped
    sample_endian = "<" if compressed and rawmode == "I;16BS" else endian
    tiled = TILE_OFFSETS in d.tags
    if tiled:
        tw, th = d.one(TILE_WIDTH), d.one(TILE_LENGTH)
        if not tw or not th or tw * th > MAX_PIXELS:
            raise ImageDecodeError(f"TIFF tiles of {tw} × {th} are empty or too large")
        offsets, counts = d.get(TILE_OFFSETS), d.get(TILE_COUNTS)
        across, down = -(-width // tw), -(-height // th)
        blocks = [(x * tw, y * th, tw, th) for y in range(down) for x in range(across)]
    elif STRIP_OFFSETS in d.tags:
        rps = d.one(ROWS_PER_STRIP, height) or height
        offsets, counts = d.get(STRIP_OFFSETS), d.get(STRIP_COUNTS)
        blocks = [(0, y, width, rps) for y in range(0, height, rps)]
        if not compressed and rps >= height and planes == 1 and len(offsets) > 1:
            offsets = offsets[-1:]  # Pillow reads the last offset where one strip covers the image
    else:
        raise ImageDecodeError("TIFF has neither strips nor tiles")
    if len(offsets) < len(blocks) * planes:
        raise ImageDecodeError(f"TIFF has {len(offsets)} strip or tile offsets for {len(blocks) * planes} blocks")
    if compressed and (counts is None or len(counts) < len(offsets)):
        raise ImageDecodeError("TIFF compressed data has no StripByteCounts or TileByteCounts")
    t4 = d.one(T4_OPTIONS, 0) if compression == 3 else 0

    dtype = np.uint16 if depth == 16 else np.uint8
    samples = np.zeros((height, width, spp), dtype)
    for plane in range(planes):
        for bi, (x0, y0, bw, bh) in enumerate(blocks):
            index = plane * len(blocks) + bi
            # libtiff decodes whole tiles; Pillow's raw reader only the rows in the image
            rows = bh if tiled and compressed else min(bh, height - y0)
            rowbytes = -(-bw * per_plane * depth // 8)
            want = rows * rowbytes
            where = f"{'tile' if tiled else 'strip'} {index}"
            offset = offsets[index]
            if compressed:
                count = counts[index]
                full = (bh if tiled else min(bh, height)) * rowbytes  # libtiff's TIFFStripSize / TIFFTileSize
                if count > 1 << 20 and (count - 4096) // 10 > full:
                    count = full * 10 + 4096  # libtiff's "Too large strip byte count ... Limiting to"
                data = raw[offset:offset + count]
                if len(data) < count:
                    raise ImageDecodeError(f"TIFF {where} lies past the end of the data")
                if fill == 2:
                    data = _REVERSED[np.frombuffer(data, np.uint8)].tobytes()
                flat = _decompress(data, compression, want, bw, rows, t4, where)
            else:
                flat = np.frombuffer(raw, np.uint8, count=want, offset=offset) if offset + want <= len(raw) \
                    else None
                if flat is None:
                    raise ImageDecodeError(f"TIFF {where} lies past the end of the data (truncated)")
                if fill == 2:
                    flat = _REVERSED[flat]
            block = flat.reshape(rows, rowbytes)
            if predictor == 2:
                block = _undo_predictor(block, bw, per_plane, depth, endian)
            got = _samples(block, bw, per_plane, depth, sample_endian)
            h, w = min(rows, height - y0), min(bw, width - x0)
            samples[y0:y0 + h, x0:x0 + w, plane:plane + per_plane] = got[:h, :w]
    return samples, rawmode
