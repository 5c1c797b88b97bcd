"""BMP bytes → RGB uint8, bit-equal to Pillow's ``Image.open(...).convert("RGB")``
(PIL/BmpImagePlugin.py of Pillow 12.1), without Pillow.

Every header Pillow reads: BITMAPCOREHEADER (12 bytes, 16-bit sizes,
3-byte palette entries) and the 40-, 52-, 56-, 64-, 108- and 124-byte
info headers (4-byte entries; a negative height is a top-down image,
else rows run bottom-up). Pillow's choices are followed one by one:

- depths 1, 4, 8 (palette), 16 (5-5-5), 24 and 32 (BGRX: the fourth byte
  is not alpha); another depth raises;
- BI_RGB; BI_RLE8 and BI_RLE4, decoded by native/bmp.cpp as Pillow's
  Python RLE decoder reads them; BI_BITFIELDS with exactly the masks
  Pillow accepts (32 bits: BGRX, XBGR, BGXR, ABGR, RGBA, BGRA, BGAR and
  all-zero masks as BGRA; 24 bits: BGR; 16 bits: 5-6-5 and 5-5-5), read
  from the header where it holds them (52 bytes and up; the alpha mask
  from 56) and after a 40-byte header otherwise; embedded JPEG or PNG
  (compression 4, 5) raises ``UnsupportedImageFormat``, and any other
  compression or mask ``ImageDecodeError``;
- the palette holds the header's colour count (2^bits where it says 0,
  at most 65,536) and is read from right after the header; a palette of
  black and white (2 colours) or a grey ramp (0, 1, 2, ...) makes Pillow
  read the data as "1" or "L" (which for a depth other than 1 or 8 it
  reads at the wrong depth, or refuses where the rows are too short);
  indices past a short palette read black; where the data offset points
  right after the header, the data starts 4 × colours later;
- 5-bit and 6-bit fields scale by × 255 // 31 and × 255 // 63;
- rows are padded to 4 bytes; data that ends before the last row's
  pixels raises, as Pillow's "image file is truncated" does; RLE data
  that leaves rows unfilled raises ("not enough image data").

More than 178,956,970 pixels raise, as Pillow's decompression-bomb check
does.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .decode import MAX_PIXELS, ImageDecodeError, UnsupportedImageFormat, _native

_U8P = ctypes.POINTER(ctypes.c_uint8)
_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
             32: ("RGB", "BGRX")}
_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX", (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR", (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA", (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR", (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR", (16, (0xF800, 0x7E0, 0x1F)): "BGR;16", (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# raw mode → bits per pixel as Pillow unpacks it
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _unpack(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """Rows [h, bytes] → what Pillow's unpacker gives: indices or grey
    [h, width], or RGB [h, width, 3]."""
    h = len(rows)
    bits = _RAW_BITS.get(rawmode, 32)
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)).reshape(h, -1)[:, :width]
        return v * np.uint8(255) if rawmode == "1" else v
    if bits == 8:
        return rows[:, :width]
    if bits == 16:
        v = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
        gbits, rshift = (6, 11) if rawmode == "BGR;16" else (5, 10)
        gmax = (1 << gbits) - 1
        r, g, b = (v >> rshift) & 31, (v >> 5) & gmax, v & 31
        return np.stack([r * 255 // 31, g * 255 // gmax, b * 255 // 31], axis=2).astype(np.uint8)
    px = rows[:, :bits // 8 * width].reshape(h, width, bits // 8)
    order = rawmode.replace(";", "")
    return np.stack([px[..., order.index(c)] for c in "RGB"], axis=2)


def decode_bmp(raw: bytes) -> np.ndarray:
    """BMP bytes → (H, W, 3) uint8, as Pillow's convert("RGB") gives it."""
    if raw[:2] != b"BM" or len(raw) < 18:
        raise ImageDecodeError("BMP data does not start with a BMP header")
    offset = struct.unpack("<I", raw[10:14])[0]
    header_size = struct.unpack("<I", raw[14:18])[0]
    if header_size not in _HEADERS:
        raise ImageDecodeError(f"BMP header of {header_size} bytes is not one Pillow reads")
    head = raw[18:14 + header_size]
    if len(head) != header_size - 4:
        raise ImageDecodeError("BMP header is truncated")
    pos = 14 + header_size
    if header_size == 12:
        width, height, _, bits = struct.unpack("<HHHH", head[:8])
        compression, colors, padding, direction = 0, 0, 3, -1
    else:
        top_down = head[7] == 0xFF
        width, height = struct.unpack("<II", head[:8])
        if top_down:
            height = 2 ** 32 - height
        bits, compression = struct.unpack("<HI", head[10:16])
        colors = struct.unpack("<I", head[28:32])[0]
        padding, direction = 4, (1 if top_down else -1)
        if compression == 3:
            if len(head) >= 48:
                masks = struct.unpack("<III", head[36:48]) + (struct.unpack("<I", head[48:52]) if len(head) >= 52
                                                              else (0,))
            else:
                if len(raw) < pos + 12:
                    raise ImageDecodeError("BMP bit field masks are truncated")
                masks = struct.unpack("<III", raw[pos:pos + 12]) + (0,)
                pos += 12
    if width * height > MAX_PIXELS:
        raise ImageDecodeError(f"BMP image of {width} × {height} is too large")
    if not width or not height:
        raise ImageDecodeError("BMP image has an empty size")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ImageDecodeError(f"BMP depth {bits} is not one Pillow reads")
    mode, rawmode = _BIT2MODE[bits]
    rle = False
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASKS:
            raise ImageDecodeError(f"BMP bit field masks {[hex(m) for m in masks]} at {bits} bits are not read")
        rawmode = _MASKS[key]
    elif compression in (1, 2):
        rle = True
    elif compression in (4, 5):
        raise UnsupportedImageFormat(f"BMP with embedded {'JPEG' if compression == 4 else 'PNG'} (compression "
                                     f"{compression})")
    elif compression != 0:
        raise ImageDecodeError(f"BMP compression {compression} is not one Pillow reads")

    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ImageDecodeError(f"BMP palette of {colors} colours")
        table = raw[pos:pos + padding * colors]
        pos += len(table)
        entries = np.frombuffer(table[:len(table) // padding * padding], np.uint8).reshape(-1, padding)
        indices = np.array([0, 255]) if colors == 2 else np.arange(colors) & 255
        grey = len(entries) >= colors and all(
            (entries[:colors, :3] == indices[:, None]).all(axis=1))
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            palette = np.zeros((256, 3), np.uint8)
            rgb = entries[:256, 2::-1]
            palette[:len(rgb)] = rgb
    start = offset or pos

    if rle:
        if mode == "1":
            raise ImageDecodeError("BMP run-length data of a black-and-white palette (Pillow has no unpacker)")
        out = np.empty(width * height, np.uint8)
        length = ctypes.c_int64(0)
        src = np.frombuffer(raw, np.uint8)
        status = _native("bmp").bmp_rle(src.ctypes.data_as(_U8P), len(src), start, width, height,
                                        int(compression == 2), out.ctypes.data_as(_U8P), ctypes.byref(length))
        if status:
            raise ImageDecodeError("BMP run-length delta is truncated")
        if length.value < width * height:
            raise ImageDecodeError("BMP run-length data ends before the image is filled")
        values = out.reshape(height, width)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = -(-width * _RAW_BITS.get(rawmode, 32) // 8)
        if need > stride:
            raise ImageDecodeError(f"BMP rows of {stride} bytes are too short for raw mode {rawmode}")
        if start + stride * (height - 1) + need > len(raw):
            raise ImageDecodeError("BMP data is truncated")
        data = np.frombuffer(raw, np.uint8, count=min(stride * height, len(raw) - start), offset=start)
        rows = np.zeros((height, stride), np.uint8)
        rows.reshape(-1)[:len(data)] = data
        values = _unpack(rows, width, rawmode)
    if direction == -1:
        values = values[::-1]
    if values.ndim == 3:
        return np.ascontiguousarray(values)
    if palette is not None:
        return palette[values]
    return np.repeat(values[:, :, None], 3, axis=2)
