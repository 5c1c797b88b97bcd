"""image/bmp.py and native/bmp.cpp against Pillow 12.1's BmpImagePlugin:
every case decodes bit-equal to ``Image.open(...).convert("RGB")``, or
both refuse it.

- Pillow-written files: every mode Pillow writes as BMP ("1", "L", "P"
  with short palettes, "RGB", "RGBA") at widths that leave every row
  padding;
- files written here: the 12-, 40-, 52-, 56-, 64-, 108- and 124-byte
  headers at 1, 4, 8, 16, 24 and 32 bits, bottom-up and top-down rows,
  palettes short, absent (a colour count of 0), black-and-white and grey
  ramps, every bit-field mask set Pillow accepts (masks after a 40-byte
  header or inside a longer one), RLE8 and RLE4 with encoded and
  absolute runs, odd absolute runs, end of line, end of bitmap and
  deltas, and a data offset that skips the palette;
- refusals: embedded JPEG and PNG by name; depths, masks, compressions
  and headers Pillow refuses; truncated raw and RLE data.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image


def pillow_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def assert_same_as_pillow(raw: bytes) -> bool:
    """Equal to Pillow's pixels (True), or refused where Pillow refuses (False)."""
    try:
        want = pillow_rgb(raw)
    except Exception:  # noqa: BLE001 - Pillow's refusals are OSError, ValueError, ...
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return False
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return True


def page(rng, w: int, h: int, top: int = 255) -> np.ndarray:
    """Text-like strokes of low values on `top`, some noise: [h, w]."""
    img = np.full((h, w), top, np.int64)
    for _ in range(max(1, w * h // 30)):
        x, y = rng.integers(0, w), rng.integers(0, h)
        img[y:y + rng.integers(1, 3), x:x + rng.integers(1, 7)] = rng.integers(0, top // 3 + 1)
    noise = rng.random((h, w)) < 0.08
    img[noise] = rng.integers(0, top + 1, int(noise.sum()))
    return img


# -- Pillow-written ----------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("width", [1, 2, 3, 5, 13, 33])
def test_pillow_written_bmp_decodes_equal(mode, width):
    rng = np.random.default_rng(width)
    grey = page(rng, width, 9).astype(np.uint8)
    rgba = np.stack([grey, np.roll(grey, 1, axis=1), rng.integers(0, 256, grey.shape), grey], axis=2)
    im = Image.fromarray(rgba.astype(np.uint8), "RGBA")
    if mode == "P":
        im = im.convert("RGB").convert("P", palette=Image.Palette.ADAPTIVE, colors=int(rng.integers(2, 40)))
    else:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "BMP")
    assert assert_same_as_pillow(buf.getvalue())


# -- a BMP writer --------------------------------------------------------------------------------------


def rle_encode(rows: np.ndarray, rle4: bool, delta_at=None) -> bytes:
    """Rows [h, w] of indices (bottom row first) → RLE8/RLE4 commands:
    runs of 3 or more as encoded runs, the rest as absolute runs (3 or
    more pixels) or single encoded pixels, EOL after each row, EOB at the
    end; `delta_at` (row, col, right, up) inserts a delta there, its pair
    written twice as Pillow reads it."""
    out = bytearray()
    h, w = rows.shape
    for y in range(h):
        row = [int(v) for v in rows[y]]
        x = 0
        while x < w:
            if delta_at and (y, x) == delta_at[:2]:
                out += bytes([0, 2, delta_at[2], delta_at[3], delta_at[2], delta_at[3]])
            j = x
            while j + 1 < w and row[j + 1] == row[x] and j - x < 254:
                j += 1
            if j - x >= 2:
                n = j - x + 1
                out += bytes([n, row[x] * 17 if rle4 else row[x]])
                x = j + 1
                continue
            j = x
            while j + 1 < w and j - x < 254 and not (j + 2 < w and row[j + 1] == row[j + 2]):
                j += 1
            n = j - x + 1
            if n >= 3:
                lit = row[x:j + 1]
                if rle4:
                    lit = lit + [0] * (len(lit) % 2)
                    body = bytes(lit[i] << 4 | lit[i + 1] for i in range(0, len(lit), 2))
                else:
                    body = bytes(lit)
                out += bytes([0, n]) + body
                if len(out) % 2:
                    out += b"\0"
            else:
                for v in row[x:j + 1]:
                    out += bytes([1, v * 17 if rle4 else v])
            x = j + 1
        out += b"\0\0"
    return bytes(out + b"\0\1")


def write_bmp(values: np.ndarray, bits: int, *, header: int = 40, compression: int = 0, palette=None,
              colors=None, masks=None, top_down: bool = False, offset_skips_palette: bool = False,
              data: bytes = None) -> bytes:
    """values [h, w] (indices or 16-bit words) or [h, w, c] (bytes in file
    order) → a BMP file."""
    h, w = values.shape[:2]
    if data is None:
        rows = values if top_down else values[::-1]
        stride = ((w * bits + 31) >> 3) & ~3
        body = bytearray()
        for row in rows:
            if bits < 8:
                per = 8 // bits
                padded = np.zeros(-(-w // per) * per, np.uint8)
                padded[:w] = row
                shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
                line = (padded.reshape(-1, per) << shifts).sum(axis=1).astype(np.uint8).tobytes()
            elif bits == 16:
                line = row.astype("<u2").tobytes()
            else:
                line = row.astype(np.uint8).tobytes()
            body += line.ljust(stride, b"\0")
        data = bytes(body)
    pal = b""
    if palette is not None:
        entry = 3 if header == 12 else 4
        pal = b"".join(bytes([b, g, r, 0][:entry]) for r, g, b in palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(data),
                           2835, 2835, len(palette) if colors is None and palette is not None else (colors or 0), 0)
        tail = bytearray(header - 40)
        if masks and header >= 52:
            for i, m in enumerate(masks[:4 if header >= 56 else 3]):
                tail[i * 4:i * 4 + 4] = struct.pack("<I", m)
        info += bytes(tail)
    extra = struct.pack("<III", *masks[:3]) if masks and header == 40 else b""
    start = 14 + len(info) + len(extra) + len(pal)
    # an offset right after the header: Pillow starts 4 × colours later
    offset = 14 + header if offset_skips_palette else start
    return b"BM" + struct.pack("<IHHI", start + len(data), 0, 0, offset) + info + extra + pal + data


def colour_palette(rng, n):
    return [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(n)]


def _raw_cases():
    cases = []
    for header in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8, 16, 24, 32):
            cases.append(dict(header=header, bits=bits))
    for bits in (1, 4, 8, 24, 32):
        for header in (40, 124):
            cases.append(dict(header=header, bits=bits, top_down=True))
    for bits, n in ((1, 1), (4, 5), (4, 0), (8, 3), (8, 200), (8, 0)):
        cases.append(dict(header=40, bits=bits, colors=n))  # short or absent palettes
    for bits in (1, 8):
        cases.append(dict(header=40, bits=bits, grey="bw"))
    cases.append(dict(header=40, bits=8, grey="ramp"))
    cases.append(dict(header=40, bits=4, grey="ramp", refused=True))  # Pillow reads 4-bit data as "L": too short
    cases.append(dict(header=40, bits=4, grey="ramp", width=1))  # ... or read at the wrong depth
    cases.append(dict(header=40, bits=8, grey="bw", width=16))  # 8-bit data read as "1"
    cases.append(dict(header=40, bits=8, offset_skips_palette=True))
    cases.append(dict(header=12, bits=8, offset_skips_palette=True, refused=True))  # 4-byte entries skipped: truncated
    return cases


@pytest.mark.parametrize("case", _raw_cases(), ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_hand_built_bmp_decodes_equal(case):
    case = dict(case)
    rng = np.random.default_rng(zlib.crc32(repr(sorted(case.items())).encode()))
    bits = case.pop("bits")
    refused = case.pop("refused", False)
    w = case.pop("width", 23)
    h = 11
    grey = case.pop("grey", None)
    colors = case.pop("colors", None)
    palette = None
    if bits <= 8:
        top = (1 << bits) - 1
        values = page(rng, w, h, top)
        if grey == "bw":
            palette = [(0, 0, 0), (255, 255, 255)]
            values = values % 2
        elif grey == "ramp":
            palette = [(i, i, i) for i in range(top + 1)]
        else:
            n = colors if colors else top + 1
            palette = colour_palette(rng, n)
            if colors == 0:
                colors = None
                palette = colour_palette(rng, top + 1)
                case["colors"] = 0
        if colors:
            case["colors"] = colors
    elif bits == 16:
        values = page(rng, w, h, 0x7FFF)
    else:
        grey_v = page(rng, w, h).astype(np.uint8)
        values = np.stack([grey_v, np.roll(grey_v, 2, axis=1), rng.integers(0, 256, (h, w))] +
                          ([rng.integers(0, 256, (h, w))] if bits == 32 else []), axis=2)
    raw = write_bmp(values, bits, palette=palette, **case)
    assert assert_same_as_pillow(raw) != refused


MASK_SETS = {
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0), (0xFF000000, 0xFF00, 0xFF, 0x0),
         (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)],
    24: [(0xFF0000, 0xFF00, 0xFF, 0)],
    16: [(0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0)],
}


@pytest.mark.parametrize("header", [40, 52, 56, 108, 124])
@pytest.mark.parametrize("bits, masks", [(b, m) for b, sets in MASK_SETS.items() for m in sets],
                         ids=lambda v: str(v))
def test_bitfields_decode_equal(header, bits, masks):
    """Every mask set Pillow accepts; the alpha mask counts only where the
    header holds it (56 bytes and up), so some sets are refused by both
    under a shorter header."""
    rng = np.random.default_rng(bits + header + sum(masks))
    h, w = 7, 9
    values = (rng.integers(0, 1 << 16, (h, w)) if bits == 16
              else rng.integers(0, 256, (h, w, bits // 8)))
    assert_same_as_pillow(write_bmp(values, bits, header=header, compression=3, masks=masks))


# -- run-length data ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("variant", ["plain", "delta", "odd_absolute", "top_down", "grey"])
def test_rle_decodes_equal(rle4, variant):
    rng = np.random.default_rng(int(rle4) * 10 + len(variant))
    bits = 4 if rle4 else 8
    h, w = 9, 29
    values = page(rng, w, h, (1 << bits) - 1)
    palette = ([(i, i, i) for i in range(1 << bits)] if variant == "grey" and not rle4
               else colour_palette(rng, 1 << bits))
    rows = values if variant == "top_down" else values[::-1]
    data = rle_encode(rows, rle4, delta_at=(2, 5, 3, 1) if variant == "delta" else None)
    if variant == "odd_absolute":  # an absolute run of 5: RLE4 reads two bytes of it
        data = bytes([0, 5, 0x12, 0x34, 0x50, 0]) + data
    raw = write_bmp(values, bits, compression=2 if rle4 else 1, palette=palette, top_down=variant == "top_down",
                    data=data)
    assert assert_same_as_pillow(raw)


@pytest.mark.parametrize("case", ["early_eob", "ends", "delta_cut", "bw_palette"])
def test_rle_both_refuse(case):
    rng = np.random.default_rng(9)
    values = page(rng, 12, 6, 255)
    data = rle_encode(values[::-1], False)
    palette = colour_palette(rng, 256)
    if case == "early_eob":
        data = data[:len(data) // 2] + b"\0\1"
    elif case == "ends":
        data = data[:len(data) // 2]
    elif case == "delta_cut":
        data = bytes([0, 2, 1, 1, 1])
    else:
        palette = [(0, 0, 0), (255, 255, 255)]
        values %= 2
        data = rle_encode(values[::-1], False)
    assert not assert_same_as_pillow(write_bmp(values, 8, compression=1, palette=palette, data=data))


# -- refusals ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("compression, name", [(4, "JPEG"), (5, "PNG")])
def test_embedded_jpeg_and_png_raise_by_name(compression, name):
    raw = write_bmp(np.zeros((4, 4, 3), np.uint8), 24, compression=compression, data=b"\xff\xd8\xff\xe0" * 4)
    with pytest.raises(UnsupportedImageFormat, match=f"embedded {name}") as err:
        decode_image(raw)
    assert "BMP" in err.value.format


@pytest.mark.parametrize("case", ["depth2", "compression6", "bad_masks", "bitfields_8bit", "header20",
                                  "truncated", "last_row_padding"])
def test_bmp_refusals_match_pillow(case):
    rng = np.random.default_rng(1)
    values = rng.integers(0, 256, (5, 7, 3))
    if case == "depth2":
        raw = write_bmp(rng.integers(0, 4, (5, 7)), 2, palette=colour_palette(rng, 4))
    elif case == "compression6":
        raw = write_bmp(values, 24, compression=6)
    elif case == "bad_masks":
        raw = write_bmp(values, 24, compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0))
    elif case == "bitfields_8bit":
        raw = write_bmp(rng.integers(0, 256, (5, 7)), 8, compression=3, masks=(0xFF, 0, 0, 0),
                        palette=colour_palette(rng, 256))
    elif case == "header20":
        raw = write_bmp(values, 24)
        raw = raw[:14] + struct.pack("<I", 20) + raw[18:]
    elif case == "truncated":
        raw = write_bmp(values, 24)[:-30]
    else:  # the last row's padding cut off: Pillow reads the row without it
        raw = write_bmp(values, 24)[:-3]
        assert assert_same_as_pillow(raw)
        return
    assert not assert_same_as_pillow(raw)
