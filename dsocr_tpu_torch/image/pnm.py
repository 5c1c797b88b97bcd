"""PNM bytes → RGB uint8, bit-equal to Pillow's ``Image.open(...).convert("RGB")``
(Pillow 12.1's ``PpmImagePlugin``), without Pillow.

The magic (up to six bytes, ended by whitespace) names the mode: P1 and P4
"1", P2 and P5 "L", P3 and P6 "RGB", Pf "F", and Pillow's own P0CMYK and
PyCMYK "CMYK", PyP "P", PyRGBA "RGBA"; any other magic is a file Pillow
does not identify (``UnsupportedImageFormat``). The header's tokens follow
``_read_token``: whitespace is the six bytes of ``_WHITESPACE``, ``#``
starts a comment that runs to CR or LF and joins the bytes around it into
one token, a token of more than 10 bytes raises, as does the end of the
data inside the header. Width, height and maxval are Python ints of their
tokens; Pf reads a float scale instead (finite and non-zero, its sign picks
little- or big-endian floats, rows bottom to top). 0 < maxval < 65536, and
L over maxval 255 is mode I. A size of 0 or less is not identified, and
more than 178,956,970 pixels raise (Pillow's decompression-bomb check).

Samples: raw data at maxval 255 (P4 packed, a set bit black; P5 at maxval
65535 as I;16B) is read as it is and must be whole ("image file is
truncated"); raw data at another maxval is ``PpmDecoder``'s (1 byte a
sample below 256, 2 big-endian above; ``min(out_max, round(v / maxval *
out_max))``, out_max 65535 for I, else 255, Python's half-to-even
``round`` of the float64 quotient); plain P1-P3 data is
``PpmPlainDecoder``'s, read as it reads it in 1 MiB blocks (comments
stripped in each block, P1 digits without separators, a token of more
than 10 bytes or a value past maxval raises, values scaled as above), and
data that ends early raises ("not enough image data"). Bytes after the
image are ignored. The modes then map to RGB as ``convert("RGB")`` maps
them: I clipped to 255, F as Pillow's F → L (0 for NaN and below 1, 255
from 255 up, truncated between), CMYK through Pillow's cmyk2rgb, P (no
palette) black, RGBA without its alpha.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from .decode import _I64P, _U8P, MAX_PIXELS, ImageDecodeError, UnsupportedImageFormat, _native, cmyk_to_rgb, \
    float_to_grey

MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F",
         b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_WHITESPACE = b" \t\n\x0b\x0c\r"
_COMMENTS = re.compile(rb"(?:#[^\r\n]*[\r\n]?)*")  # each up to and with CR or LF, or to the end
_SKIPPED = re.compile(rb"(?:[ \t\n\x0b\x0c\r]+|#[^\r\n]*[\r\n]?)*")  # whitespace and comments before a token
_MAX_TOKEN = 10


def _magic(raw: bytes) -> Tuple[bytes, int]:
    """_read_magic: up to six bytes, ended (and the ending byte consumed)
    by whitespace or the end of the data."""
    pos = 0
    while pos < min(6, len(raw)):
        c = raw[pos]
        pos += 1
        if c in _WHITESPACE:
            return raw[:pos - 1], pos
    return raw[:pos], pos


def _token(raw: bytes, pos: int) -> Tuple[bytes, int]:
    """_read_token from `pos` → (token, the position after it), each run
    of whitespace and comments skipped in one linear match."""
    token = bytearray()
    pos = _SKIPPED.match(raw, pos).end()
    while len(token) <= _MAX_TOKEN and pos < len(raw):
        c = raw[pos]
        if c in _WHITESPACE:
            pos += 1
            break
        if c == 0x23:  # comments inside a token join the bytes around them
            pos = _COMMENTS.match(raw, pos).end()
        else:
            token.append(c)
            pos += 1
    if not token:
        raise ImageDecodeError("PNM header ends early (Pillow: reached EOF while reading header)")
    if len(token) > _MAX_TOKEN:
        raise ImageDecodeError(f"PNM header token {bytes(token)!r} is longer than {_MAX_TOKEN} bytes")
    return bytes(token), pos


def _number(token: bytes, kind=int):
    try:
        return kind(token)
    except ValueError:
        raise ImageDecodeError(f"PNM header token {token!r} is not a number") from None


def decode_pnm(raw: bytes) -> np.ndarray:
    """PNM bytes → (H, W, 3) uint8, as Pillow's convert("RGB") gives it."""
    magic, pos = _magic(raw)
    mode = MODES.get(magic)
    if mode is None:
        raise UnsupportedImageFormat(f"PNM with magic {magic!r}")
    token, pos = _token(raw, pos)
    width = _number(token)
    token, pos = _token(raw, pos)
    height = _number(token)
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = None
    if mode == "F":
        token, pos = _token(raw, pos)
        scale = _number(token, float)
        if scale == 0.0 or not np.isfinite(scale):
            raise ImageDecodeError("PNM Pf scale must be finite and non-zero")
    elif mode != "1":
        token, pos = _token(raw, pos)
        maxval = _number(token)
        if not 0 < maxval < 65536:
            raise ImageDecodeError(f"PNM maxval {maxval} is not in 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        raise UnsupportedImageFormat(f"PNM of {width} × {height} (Pillow does not identify an empty image)")
    if width * height > MAX_PIXELS:
        raise ImageDecodeError(f"PNM image of {width} × {height} is over Pillow's decompression-bomb limit "
                               f"of {MAX_PIXELS} pixels")

    bands = _BANDS[mode]
    count = width * height * bands
    if plain and mode == "1":
        values = _plain(raw, pos, count, 0, True)
    elif plain:
        values = _scaled(_plain(raw, pos, count, maxval, False), maxval, 65535 if mode == "I" else 255)
    elif mode == "1":  # raw "1;I": rows padded to a byte, a set bit black
        bits = np.unpackbits(_raw_bytes(raw, pos, (width + 7) // 8 * height).reshape(height, -1), axis=1)
        values = np.where(bits[:, :width], 0, 255).astype(np.uint8)
    elif mode == "F":
        data = _raw_bytes(raw, pos, 4 * count)
        values = data.view("<f4" if scale < 0 else ">f4").reshape(height, width)[::-1]
    elif maxval == 255 or (mode == "I" and maxval == 65535):
        size = 2 if mode == "I" else 1
        values = _raw_bytes(raw, pos, size * count).view(">u2" if size == 2 else np.uint8)
    else:  # PpmDecoder
        size = 1 if maxval < 256 else 2
        data = raw[pos:pos + size * count]
        if len(data) < size * count:
            raise ImageDecodeError("PNM data ends early (Pillow: not enough image data)")
        samples = np.frombuffer(data, np.uint8 if size == 1 else ">u2")
        out_max = 65535 if mode == "I" else 255
        values = np.minimum(out_max, _scaled(samples, maxval, out_max))
    return _to_rgb(np.asarray(values).reshape(height, width, bands), mode)


def _raw_bytes(raw: bytes, pos: int, size: int) -> np.ndarray:
    if len(raw) - pos < size:
        raise ImageDecodeError(f"PNM data is truncated ({max(0, len(raw) - pos)} of {size} bytes)")
    return np.frombuffer(raw, np.uint8, size, pos)


def _scaled(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(value / maxval * out_max), half to even, in float64 as Python computes it."""
    return np.rint(values.astype(np.float64) / maxval * out_max).astype(np.int64)


def _to_rgb(s: np.ndarray, mode: str) -> np.ndarray:
    v = s[..., 0]
    if mode in ("1", "L"):
        grey = v.astype(np.uint8)
    elif mode == "I":
        grey = np.minimum(v, 255).astype(np.uint8)
    elif mode == "F":
        grey = float_to_grey(v)
    elif mode == "P":  # no palette: Pillow's convert gives black
        return np.zeros(s.shape[:2] + (3,), np.uint8)
    elif mode == "CMYK":
        return cmyk_to_rgb(s.astype(np.uint8))
    else:  # RGB, RGBA (a copy: raw samples are a view of the file's bytes)
        return np.array(s[..., :3], np.uint8)
    return np.repeat(grey[..., None], 3, axis=2)


_PLAIN_ERRORS = {1: "ends early (Pillow: not enough image data)", 2: "holds a token longer than 10 bytes",
                 3: "holds a token that is not an integer", 4: "holds a value past maxval",
                 5: "holds a byte other than 0 and 1 (P1)"}


def _plain(raw: bytes, pos: int, count: int, maxval: int, bitonal: bool) -> np.ndarray:
    """PpmPlainDecoder's values (native/pnm.cpp), raw integers or, for P1,
    0 and 255."""
    data = np.frombuffer(raw, np.uint8)[pos:]
    if count > (len(data) if bitonal else (len(data) + 1) // 2):  # a value takes a byte, and a token a separator
        raise ImageDecodeError(f"PNM plain data ends early (Pillow: not enough image data): {len(data)} bytes "
                               f"for {count} values")
    out = np.empty(count, np.int64)
    info = np.zeros(2, np.int64)
    status = _native("pnm").pnm_plain(data.ctypes.data_as(_U8P), len(data), count, maxval, int(bitonal),
                                      out.ctypes.data_as(_I64P), info.ctypes.data_as(_I64P))
    if status:
        raise ImageDecodeError(f"PNM plain data {_PLAIN_ERRORS[status]} (after {info[0]} values)")
    return out
