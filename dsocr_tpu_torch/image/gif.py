"""GIF bytes → RGB uint8 of the first frame, bit-equal to Pillow's
``Image.open(...).convert("RGB")`` (PIL/GifImagePlugin.py of Pillow 12.1),
without Pillow.

What Pillow's first frame is, step by step:

- the canvas is the logical screen, grown to hold the frame where the
  frame's rectangle reaches past it;
- outside the frame the canvas holds index 0, or the transparency index
  where a graphic control extension before the frame sets one (not the
  screen's background colour);
- the frame's indices are decoded by native/gif.cpp's LZW (see there for
  what is an error) and written row by row, in the four interlace passes
  where the frame is interlaced;
- indices map to colours through the local colour table, else the
  global one; a table that is the identity grey ramp (entry i = i, i, i)
  counts as none, except that an identity local table leaves the global
  table in use; with no table the index is the grey level; an index past
  the table reads black;
- extensions are skipped by their sub-blocks, and a byte that starts no
  block is skipped; a file that ends before the first frame raises.

More than 178,956,970 pixels raise, as Pillow's decompression-bomb check
does.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from .decode import MAX_PIXELS, ImageDecodeError, _native

_U8P = ctypes.POINTER(ctypes.c_uint8)
_LZW_ERRORS = {1: "ends before the frame is full", 2: "has a code past its table"}


class _Reader:
    def __init__(self, raw: bytes, pos: int):
        self.raw, self.pos = raw, pos

    def read(self, n: int) -> bytes:
        out = self.raw[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> Optional[bytes]:
        """One data sub-block, or None at a terminator or the end."""
        size = self.read(1)
        return self.read(size[0]) if size and size[0] else None


def _needed(table: bytes) -> bool:
    """Pillow's _is_palette_needed: the table is not the identity ramp."""
    entries = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return not (entries == np.arange(len(entries))[:, None]).all()


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])


def decode_gif(raw: bytes) -> np.ndarray:
    """GIF bytes → (H, W, 3) uint8 of the first frame, as Pillow's
    convert("RGB") gives it."""
    if raw[:6] not in (b"GIF87a", b"GIF89a") or len(raw) < 13:
        raise ImageDecodeError("GIF data does not start with a GIF header")
    width, height, flags = struct.unpack("<HHB", raw[6:11])
    r = _Reader(raw, 13)
    global_table = None
    if flags & 0x80:
        table = r.read(3 << ((flags & 7) + 1))
        if len(table) % 3:
            raise ImageDecodeError("GIF global colour table is truncated")
        global_table = table if _needed(table) else None

    transparency = None
    while True:
        s = r.read(1)
        if not s or s == b";":
            raise ImageDecodeError("GIF has no image before its end")
        if s == b"!":
            label = r.read(1)
            block = r.block()
            if label == b"\xf9" and block is not None:  # graphic control extension
                if len(block) < 4:
                    raise ImageDecodeError("GIF graphic control extension is too short")
                if block[0] & 1:
                    transparency = block[3]
            while block is not None:  # the rest of the extension's sub-blocks
                block = r.block()
        elif s == b",":
            desc = r.read(9)
            if len(desc) < 9:
                raise ImageDecodeError("GIF image descriptor is truncated")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", desc)
            break
        # any other byte starts nothing and is skipped, as Pillow skips it

    width, height = max(width, x0 + fw), max(height, y0 + fh)
    if width * height > MAX_PIXELS:
        raise ImageDecodeError(f"GIF image of {width} × {height} is too large")
    if not width or not height:
        raise ImageDecodeError("GIF image has an empty size")
    palette_table = global_table
    if fflags & 0x80:
        local = r.read(3 << ((fflags & 7) + 1))
        if len(local) % 3:
            raise ImageDecodeError("GIF local colour table is truncated")
        if _needed(local):
            palette_table = local
    code_size = r.read(1)
    if not code_size:
        raise ImageDecodeError("GIF image data is missing")
    data = bytearray()
    while True:
        block = r.block()
        if block is None:
            break
        data += block

    canvas = np.full((height, width), transparency or 0, np.uint8)
    if fw and fh:
        pixels = np.empty(fw * fh, np.uint8)
        src = np.frombuffer(bytes(data), np.uint8)
        status = _native("gif").gif_lzw(src.ctypes.data_as(_U8P), len(src), code_size[0],
                                        pixels.ctypes.data_as(_U8P), len(pixels))
        if status:
            raise ImageDecodeError(f"GIF image data {_LZW_ERRORS[status]}")
        frame = pixels.reshape(fh, fw)
        if fflags & 0x40:
            placed = np.empty_like(frame)
            placed[_interlaced_rows(fh)] = frame
            frame = placed
        canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette_table is None:
        return np.repeat(canvas[:, :, None], 3, axis=2)
    lut = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(palette_table, np.uint8).reshape(-1, 3)[:256]
    lut[:len(entries)] = entries
    return lut[canvas]
