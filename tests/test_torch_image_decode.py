"""The port's PNG decoder (dsocr_tpu_torch/image/decode.py) bit-equal to
Pillow's ``Image.open(...).convert("RGB")``: PNGs written by Pillow, and
by hand for every color type and bit depth, each filter type, Adam7 and
split IDAT chunks, with and without tRNS; broken PNGs, the formats it
does not read and the JPEG variants it refuses raise by name (JPEG itself:
tests/test_torch_jpeg.py)."""

import io
import re
import struct
import zlib

import numpy as np
import pytest

from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image

Image = pytest.importorskip("PIL.Image")

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
COMBOS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
          (4, 8), (4, 16), (6, 8), (6, 16)]


def pillow_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples → (h, stride) bytes."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.reshape(h, w * ch).astype(np.uint8)
    per = 8 // depth
    flat = samples.reshape(h, w).astype(np.uint8)
    flat = np.pad(flat, ((0, 0), (0, -w % per)))
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat.reshape(h, -1, per) << shifts).sum(axis=2, dtype=np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """The PNG filters as the spec defines them (on the original bytes)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[:len(row)]
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])[:len(row)]
        b = prior
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(f)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def encode_png(samples, depth, ctype, filters=(0,), interlace=False, plte=None, trns=None, idat_parts=1):
    h, w, _ = samples.shape
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack_rows(sub, depth), bpp, filters)
    comp = zlib.compress(data)
    cut = np.linspace(0, len(comp), idat_parts + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += b"".join(chunk(b"IDAT", comp[a:b]) for a, b in zip(cut[:-1], cut[1:]))
    return out + chunk(b"IEND", b"")


def random_samples(rng, h, w, ctype, depth):
    top = (1 << depth) - 1
    return rng.integers(0, top + 1, size=(h, w, CHANNELS[ctype]), dtype=np.int64).astype(
        np.uint16 if depth == 16 else np.uint8)


def _trns(rng, ctype, depth, palette_len):
    if ctype == 3:
        return bytes(rng.integers(0, 256, size=min(palette_len, 5), dtype=np.uint8))
    if ctype in (0, 2):
        return struct.pack(">" + "H" * CHANNELS[ctype], *[int(v) for v in rng.integers(0, 1 << depth, CHANNELS[ctype])])
    return None


# tRNS is not allowed with an alpha channel (PNG spec 11.3.2.1)
TRNS_COMBOS = [(c, d, t) for c, d in COMBOS for t in (False, True) if not (t and c in (4, 6))]


@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "adam7"])
@pytest.mark.parametrize("ctype, depth, with_trns", TRNS_COMBOS,
                         ids=[f"type{c}-{d}bit-{'trns' if t else 'opaque'}" for c, d, t in TRNS_COMBOS])
def test_hand_written_every_type_and_depth(ctype, depth, with_trns, interlace):
    rng = np.random.default_rng(ctype * 100 + depth)
    samples = random_samples(rng, 13, 11, ctype, depth)
    plte = None
    if ctype == 3:
        # fewer entries than indices: an index past the palette reads black
        n = max(1, (1 << depth) - 1) if depth < 8 else 200
        plte = bytes(rng.integers(0, 256, size=3 * n, dtype=np.uint8))
    trns = _trns(rng, ctype, depth, len(plte) // 3 if plte else 0) if with_trns else None
    raw = encode_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4), interlace=interlace, plte=plte, trns=trns)
    assert np.array_equal(decode_image(raw), pillow_rgb(raw))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("ctype, depth", [(2, 8), (6, 16), (0, 1), (4, 8)])
def test_each_filter_type(filt, ctype, depth):
    rng = np.random.default_rng(filt)
    samples = random_samples(rng, 9, 23, ctype, depth)
    raw = encode_png(samples, depth, ctype, filters=(filt,), idat_parts=3)
    assert np.array_equal(decode_image(raw), pillow_rgb(raw))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1", "I;16", "P-transparency", "RGB-transparency",
                                  "P-4bit"])
@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "adam7"])
def test_pillow_written(mode, interlace):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    rgb[10:20] = rgb[10:11]  # flat rows, where Pillow's encoder picks other filters
    save = {"format": "PNG", "interlace": int(interlace)}
    if mode == "I;16":
        image = Image.fromarray(rng.integers(0, 65536, size=(37, 53)).astype(np.uint16))
    elif mode == "P-transparency":
        image = Image.fromarray(rgb).convert("P")
        save["transparency"] = 3
    elif mode == "RGB-transparency":
        image = Image.fromarray(rgb)
        save["transparency"] = tuple(int(v) for v in rgb[0, 0])
    elif mode == "P-4bit":
        image = Image.fromarray(rgb).quantize(16)
        save["bits"] = 4
    else:
        image = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    image.save(buf, **save)
    assert np.array_equal(decode_image(buf.getvalue()), pillow_rgb(buf.getvalue()))


def test_page_sized_png():
    rng = np.random.default_rng(0)
    page = rng.integers(0, 256, size=(300, 500, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(page).save(buf, format="PNG", optimize=True)
    assert np.array_equal(decode_image(buf.getvalue()), page)


def _good_png() -> bytes:
    return encode_png(random_samples(np.random.default_rng(0), 8, 8, 2, 8), 8, 2, filters=(4,))


def test_bad_crc_raises():
    raw = bytearray(_good_png())
    raw[33 + 8 + 5] ^= 0xFF  # a byte inside the IDAT data
    with pytest.raises(ImageDecodeError, match="CRC error in the IDAT chunk"):
        decode_image(bytes(raw))


@pytest.mark.parametrize("cut", [20, 40, -20, -12])
def test_truncated_raises(cut):
    with pytest.raises(ImageDecodeError, match="truncated|no IEND"):
        decode_image(_good_png()[:cut])


def test_short_image_data_raises():
    samples = random_samples(np.random.default_rng(0), 8, 8, 2, 8)
    raw = encode_png(samples, 8, 2)
    header = raw[:33]
    short = zlib.compress(b"\x00" * 10)
    with pytest.raises(ImageDecodeError, match="image data is truncated"):
        decode_image(header + chunk(b"IDAT", short) + chunk(b"IEND", b""))


def test_bad_filter_type_raises():
    data = b"\x07" + b"\x00" * 3
    raw = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))
    with pytest.raises(ImageDecodeError, match="filter type 7"):
        decode_image(raw)


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF", "WEBP"])
def test_other_formats_decode_equal_to_pillow(fmt):
    """GIF, BMP, TIFF and WebP decode (image/gif.py, bmp.py, tiff.py,
    webp.py; their own test files hold the matrices)."""
    img = np.random.default_rng(5).integers(0, 256, (8, 9, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(decode_image(buf.getvalue()), want)


@pytest.mark.parametrize("fmt, name", [("TIFF-32809", "ThunderScan-compressed TIFF (compression 32809)"),
                                       ("TIFF-6", "old-style JPEG-compressed TIFF (compression 6)")])
def test_other_formats_raise_by_name(fmt, name):
    buf = io.BytesIO()
    try:
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format=fmt.split("-")[0])
    except (KeyError, OSError):
        pytest.skip(f"this Pillow cannot write {fmt}")
    raw = buf.getvalue()
    if fmt.startswith("TIFF"):  # the Compression entry (SHORT, 1, none) set to the named one
        at = raw.index(struct.pack("<HHLHH", 259, 3, 1, 1, 0))
        raw = raw[:at + 8] + struct.pack("<H", int(fmt.split("-")[1])) + raw[at + 10:]
    with pytest.raises(UnsupportedImageFormat, match=re.escape(name)) as err:
        decode_image(raw)
    assert err.value.format == name


@pytest.mark.parametrize("sof, precision, name", [
    (0xC9, 8, "arithmetic-coded JPEG (SOF9)"), (0xC3, 8, "lossless JPEG (SOF3)"),
    (0xC5, 8, "hierarchical JPEG (SOF5)"), (0xC0, 12, "12-bit JPEG")])
def test_refused_jpeg_variants_raise_by_name(sof, precision, name):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    raw = bytearray(buf.getvalue())
    at = raw.index(b"\xff\xc0")
    raw[at + 1], raw[at + 4] = sof, precision
    with pytest.raises(UnsupportedImageFormat, match=re.escape(name)) as err:
        decode_image(bytes(raw))
    assert err.value.format == name


def test_unknown_bytes_raise():
    with pytest.raises(UnsupportedImageFormat, match="unrecognized"):
        decode_image(b"hello world, not an image")
