"""image/tiff.py and native/tiff.cpp against Pillow 12.1 over libtiff 4.7:
every case decodes bit-equal to ``Image.open(...).convert("RGB")``, or
both refuse it.

- Pillow-written files: every mode Pillow writes as TIFF ("1", "L", "LA",
  "P", "PA", "I;16", "I;16B", "RGB", "RGBX", "RGBA", "CMYK") × every
  compression it writes for that mode (none, LZW, Deflate, PackBits; G3,
  G4 and modified Huffman for "1") × one strip or several × Predictor 2
  (LZW and Deflate), plus photometric 0, FillOrder 2, the Orientation
  tag, T.4 2-D coding with and without fill bits, and BigTIFF;
- files written here for what Pillow cannot write: tiles, planar
  configuration 2, big-endian files, old-style (LSB-first) LZW and LZW
  past 4096 codes with Clear codes, compression 32946, 1-, 2- and 4-bit
  grey and palettes in both fill orders, 16-bit grey (signed, photometric
  0, FillOrder 2), premultiplied and other extra samples, 16-bit
  premultiplied RGBA and CMYK;
- refusals by name (ThunderScan, RLEW, SGILog, SGILog24, other
  compressions, uncompressed YCbCr and planar data Pillow misreads), and
  data both refuse:
  a layout outside Pillow's table, truncated strips of every codec, a
  predictor libtiff refuses, a decompression bomb.

Pillow's writer runs only with valid (mode, compression) pairs: group3,
group4 and tiff_ccitt on a non-"1" image, or jpeg on a "1" image, crash
the interpreter.
"""

import io
import lzma
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image
from dsocr_tpu_torch.image.tiff import decode_tiff


def pillow_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def assert_equal_to_pillow(raw: bytes) -> np.ndarray:
    want = pillow_rgb(raw)
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def assert_same_as_pillow(raw: bytes) -> None:
    """Equal to Pillow's pixels, or refused where Pillow refuses."""
    try:
        pillow_rgb(raw)
    except Exception:  # noqa: BLE001 - Pillow's refusals are OSError, SyntaxError, ValueError, ...
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return
    assert_equal_to_pillow(raw)


def assert_both_refuse(raw: bytes, match: str = "") -> None:
    with pytest.raises(Exception):
        pillow_rgb(raw)
    with pytest.raises(ImageDecodeError, match=match):
        decode_image(raw)


# -- page-like content ---------------------------------------------------------------------------


def page(rng, w: int, h: int) -> np.ndarray:
    """Text-like dark strokes on white with some noise: [h, w] uint8."""
    img = np.full((h, w), 255, np.uint8)
    for _ in range(max(1, w * h // 40)):
        x, y = rng.integers(0, w), rng.integers(0, h)
        img[y:y + rng.integers(1, 4), x:x + rng.integers(1, 9)] = rng.integers(0, 90)
    noise = rng.random((h, w)) < 0.05
    img[noise] = rng.integers(0, 256, int(noise.sum()))
    return img


def pillow_image(mode: str, rng, w: int = 45, h: int = 29) -> Image.Image:
    grey = page(rng, w, h)
    colour = np.stack([grey, np.roll(grey, 3, axis=1), rng.integers(0, 256, (h, w), dtype=np.uint8)], axis=2)
    if mode == "1":
        return Image.fromarray(grey).convert("1")
    if mode == "L":
        return Image.fromarray(grey)
    if mode == "LA":
        return Image.fromarray(np.stack([grey, colour[..., 2]], axis=2), "LA")
    if mode in ("I;16", "I;16B"):
        v = grey.astype(np.uint16) * 257 - rng.integers(0, 300, (h, w)).astype(np.uint16) * (grey > 0)
        v[0, :8] = [0, 1, 2, 254, 255, 256, 1000, 65535]
        return Image.frombytes(mode, (w, h), v.astype("<u2" if mode == "I;16" else ">u2").tobytes())
    if mode in ("P", "PA"):
        im = Image.fromarray(colour).convert("P", palette=Image.Palette.ADAPTIVE, colors=64)
        return im.convert("PA") if mode == "PA" else im
    if mode == "RGB":
        return Image.fromarray(colour)
    four = np.concatenate([colour, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2)
    return Image.frombytes(mode, (w, h), four.tobytes())


MODES = ["1", "L", "LA", "P", "PA", "I;16", "I;16B", "RGB", "RGBX", "RGBA", "CMYK"]
COMPRESSIONS = ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"]
FAX = ["group3", "group4", "tiff_ccitt"]


def _pillow_cases():
    cases = []
    for mode in MODES:
        for comp in COMPRESSIONS + (FAX if mode == "1" else []):
            cases.append((mode, comp, {}))
            cases.append((mode, comp, {278: 7}))  # several strips
            if comp in ("tiff_lzw", "tiff_adobe_deflate") and mode != "1":
                cases.append((mode, comp, {317: 2}))
                cases.append((mode, comp, {317: 2, 278: 5}))
    for mode in ("1", "L"):
        for comp in COMPRESSIONS + (FAX if mode == "1" else []):
            cases.append((mode, comp, {262: 0}))
    for mode in ("1", "L", "RGB", "P", "I;16"):
        for comp in ("raw", "tiff_lzw") + (("group4",) if mode == "1" else ()):
            cases.append((mode, comp, {266: 2}))
    for options in (1, 4, 5):  # T4Options: 2-D, fill bits, both
        cases.append(("1", "group3", {292: options}))
        cases.append(("1", "group3", {292: options, 278: 3}))
    return cases


@pytest.mark.parametrize("mode, compression, tags", _pillow_cases(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_pillow_written_tiff_decodes_equal(mode, compression, tags):
    rng = np.random.default_rng(zlib.crc32(repr((mode, compression, tags)).encode()))
    buf = io.BytesIO()
    pillow_image(mode, rng).save(buf, "TIFF", compression=compression, tiffinfo=tags)
    assert_equal_to_pillow(buf.getvalue())


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw"])
def test_orientation_transposes_as_pillow_does(orientation, compression):
    buf = io.BytesIO()
    pillow_image("RGB", np.random.default_rng(orientation)).save(
        buf, "TIFF", compression=compression, tiffinfo={274: orientation})
    got = assert_equal_to_pillow(buf.getvalue())
    assert got.shape[:2] == ((45, 29) if orientation >= 5 else (29, 45))


@pytest.mark.parametrize("mode", ["RGB", "1", "L"])
def test_bigtiff_decodes_equal(mode):
    """Pillow writes BigTIFF on its own (uncompressed) writer only."""
    buf = io.BytesIO()
    pillow_image(mode, np.random.default_rng(3)).save(buf, "TIFF", big_tiff=True, tiffinfo={278: 10})
    assert buf.getvalue()[2:4] in (b"+\x00", b"\x00+")
    assert_equal_to_pillow(buf.getvalue())


def test_a_scanned_page_sized_g4_page():
    """A 1728-pixel fax width (the codes' makeup range) and runs past 2560."""
    rng = np.random.default_rng(11)
    grey = page(rng, 2600, 60)
    grey[10:14, :] = 0  # full-width black runs
    buf = io.BytesIO()
    Image.fromarray(grey).convert("1").save(buf, "TIFF", compression="group4")
    assert_equal_to_pillow(buf.getvalue())
    for comp in ("group3", "tiff_ccitt"):
        buf = io.BytesIO()
        Image.fromarray(grey).convert("1").save(buf, "TIFF", compression=comp, tiffinfo={292: 1})
        assert_equal_to_pillow(buf.getvalue())


# -- a TIFF writer for what Pillow cannot write ---------------------------------------------------


def lzw_encode(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW: Clear first, 9- to 12-bit codes, Clear again at 4094
    entries; new style MSB-first with the early width change, old style
    LSB-first at the table's edge."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
            acc &= (1 << nacc) - 1

    grow = (lambda n: n >= (1 << nbits) + 1) if old_style else (lambda n: n >= (1 << nbits))
    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = data[:1]
    for c in data[1:]:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if grow(nxt) and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([c])
    if w:
        put(table[w])
    put(257)
    if nacc:
        put_bits = (acc << (8 - nacc)) & 0xFF if not old_style else acc & 0xFF
        out.append(put_bits)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < len(data) and data[j + 1] != data[j] and j - i < 127:
            j += 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


ENCODERS = {1: lambda b: b, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress, 32773: packbits_encode,
            34925: lzma.compress, "lzw_old": lambda b: lzw_encode(b, old_style=True)}


def write_tiff(samples: np.ndarray, bits, photometric: int, *, endian: str = "<", compression=1, planar: int = 1,
               tile=None, rows_per_strip=None, extra=(), sample_format=None, fill_order=1, predictor=1,
               colormap=None, tags=None) -> bytes:
    """samples [H, W, spp] (values; uint16 at 16 bits) → a TIFF file:
    strips or tiles, planes, any byte order; the data encoded here."""
    h, w, spp = samples.shape
    depth = bits[0]
    code = 5 if compression == "lzw_old" else compression
    encode = ENCODERS[compression]

    def pack(block: np.ndarray) -> bytes:
        """[rows, cols, n] values → row-padded bytes, predictor and fill order applied."""
        rows, cols, n = block.shape
        if predictor == 2:
            wide = np.int64 if depth == 16 else np.int16
            diff = np.diff(block.astype(wide), axis=1, prepend=0)
            diff[:, 0] = block[:, 0]
            block = (diff % (1 << depth)).astype(block.dtype)
        if depth == 16:
            data = block.astype(endian + "u2").tobytes()
        elif depth == 8:
            data = block.astype(np.uint8).tobytes()
        else:
            per = 8 // depth
            padded = np.zeros((rows, -(-cols // per) * per), np.uint8)
            padded[:, :cols] = block[..., 0]
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            data = (padded.reshape(rows, -1, per) << shifts).sum(axis=2).astype(np.uint8).tobytes()
        return data

    def reverse(data: bytes) -> bytes:  # FillOrder 2: the stored bytes, after any compression
        return bytes(int(f"{b:08b}"[::-1], 2) for b in data) if fill_order == 2 else data

    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    blocks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    part = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    src = plane[y:y + th, x:x + tw]
                    part[:src.shape[0], :src.shape[1]] = src
                    blocks.append(reverse(encode(pack(part))))
        else:
            rps = rows_per_strip or h
            blocks += [reverse(encode(pack(plane[y:y + rps]))) for y in range(0, h, rps)]
    body = bytearray(8)
    offsets = []
    for b in blocks:
        offsets.append(len(body))
        body += b
        if len(body) % 2:
            body += b"\0"
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, list(bits)), 259: (3, [code]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if sample_format:
        entries[339] = (3, list(sample_format))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if tile:
        entries.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, offsets),
                        325: (4, [len(b) for b in blocks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [rows_per_strip or h]), 279: (4, [len(b) for b in blocks])})
    entries.update(tags or {})
    ifd_at = len(body)
    values = bytearray()
    head = 2 + 12 * len(entries) + 4
    table = struct.pack(endian + "H", len(entries))
    for tag in sorted(entries):
        kind, vals = entries[tag]
        fmt = {3: "H", 4: "L"}[kind]
        data = struct.pack(endian + fmt * len(vals), *vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack(endian + "L", ifd_at + head + len(values))
            values += data
            if len(values) % 2:
                values += b"\0"
        table += struct.pack(endian + "HHL", tag, kind, len(vals)) + field
    table += b"\0\0\0\0"
    order = b"II*\x00" if endian == "<" else b"MM\x00*"
    body[:8] = order + struct.pack(endian + "L", ifd_at)
    return bytes(body + table + values)


def values(rng, h, w, spp, depth):
    """Samples [h, w, spp]: page strokes in every sample, some noise."""
    top = (1 << depth) - 1
    base = (page(rng, w, h).astype(np.int64) * top // 255)
    out = np.stack([np.roll(base, 2 * i, axis=1) for i in range(spp)], axis=2)
    noise = rng.random(out.shape) < 0.1
    out[noise] = rng.integers(0, top + 1, int(noise.sum()))
    return out.astype(np.uint16 if depth == 16 else np.uint8)


# (photometric, bits per sample, extra samples, sample format)
LAYOUTS = {
    "L": (1, (8,), (), None), "RGB": (2, (8, 8, 8), (), None), "RGBA": (2, (8,) * 4, (2,), None),
    "RGBa": (2, (8,) * 4, (1,), None), "RGBX": (2, (8,) * 4, (0,), None), "RGBXX": (2, (8,) * 5, (0, 0), None),
    "RGBaX": (2, (8,) * 5, (1, 0), None), "RGBAX": (2, (8,) * 5, (2, 0), None), "RGBA999": (2, (8,) * 4, (999,), None),
    "RGB16": (2, (16,) * 3, (), None), "RGBA16": (2, (16,) * 4, (2,), None), "RGBa16": (2, (16,) * 4, (1,), None),
    "RGBX16": (2, (16,) * 4, (0,), None), "CMYK": (5, (8,) * 4, (), None), "CMYKX": (5, (8,) * 5, (0,), None),
    "CMYK16": (5, (16,) * 4, (), None), "LA": (1, (8, 8), (2,), None), "PX": (3, (8, 8), (0,), None),
    "PA": (3, (8, 8), (2,), None), "1": (1, (1,), (), None), "1inv": (0, (1,), (), None),
    "L2": (1, (2,), (), None), "L2inv": (0, (2,), (), None), "L4": (1, (4,), (), None), "L4inv": (0, (4,), (), None),
    "Linv": (0, (8,), (), None), "Lsigned": (1, (8,), (), (2,)), "P1": (3, (1,), (), None),
    "P2": (3, (2,), (), None), "P4": (3, (4,), (), None), "P8": (3, (8,), (), None),
    "I16": (1, (16,), (), None), "I16inv": (0, (16,), (), None), "I16signed": (1, (16,), (), (2,)),
}


def hand_built(name, rng, *, h=29, w=45, **kw) -> bytes:
    photometric, bits, extra, fmt = LAYOUTS[name]
    samples = values(rng, h, w, len(bits), bits[0])
    colormap = None
    if photometric == 3:
        n = 1 << bits[0]
        colormap = rng.integers(0, 65536, 3 * n).tolist()
    return write_tiff(samples, bits, photometric, extra=extra, sample_format=fmt, colormap=colormap, **kw)


def _hand_cases():
    cases = []
    for name in LAYOUTS:
        for compression in (1, 5, 8, 32773):
            cases.append((name, dict(compression=compression)))
        cases.append((name, dict(compression=5, endian=">", rows_per_strip=10)))
    for name in ("1", "1inv", "L2", "L4inv", "Linv", "P1", "P2", "P4", "P8", "RGB", "I16"):
        for compression in (1, 5):
            cases.append((name, dict(compression=compression, fill_order=2)))
    for name in ("L", "RGB", "RGBA", "RGB16", "CMYK", "I16", "I16signed", "LA"):
        for compression in (5, 8):
            cases.append((name, dict(compression=compression, predictor=2)))
            cases.append((name, dict(compression=compression, predictor=2, endian=">")))
    for name in ("L", "RGB", "RGBa", "RGB16", "CMYK", "LA", "PA", "RGBA16", "CMYKX"):
        for compression in (5, 8, 32773):
            cases.append((name, dict(compression=compression, planar=2, rows_per_strip=8)))
        cases.append((name, dict(compression=5, planar=2, predictor=2)))
    for name in ("L", "RGB", "RGBA", "LA", "CMYK", "PX"):
        cases.append((name, dict(compression=1, planar=2, rows_per_strip=8)))
    for name in ("1", "L4", "L", "RGB", "RGBA", "RGB16", "CMYK", "I16", "P8"):
        for compression in (1, 5, 8, 32773):
            cases.append((name, dict(compression=compression, tile=(16, 16))))
        cases.append((name, dict(compression=5, tile=(32, 16), endian=">", predictor=2 if name in (
            "L", "RGB", "RGB16", "I16") else 1)))
    for name in ("RGB", "RGBA", "CMYK", "RGB16"):
        cases.append((name, dict(compression=8, tile=(16, 16), planar=2)))
        if name != "RGB16":  # Pillow reads uncompressed 16-bit planes at 8 bits: refused here
            cases.append((name, dict(compression=1, tile=(16, 32), planar=2)))
    for name in ("RGBX", "PX", "CMYKX", "RGBaX", "LA", "PA", "1inv", "Linv", "RGBa"):  # rules of Pillow's readers
        cases.append((name, dict(compression=1, planar=2, fill_order=2)))
        cases.append((name, dict(compression=8, planar=2)))
    for name in ("L", "RGB", "1", "RGB16"):
        cases.append((name, dict(compression="lzw_old")))
        cases.append((name, dict(compression="lzw_old", rows_per_strip=6, predictor=2 if name != "1" else 1)))
    cases.append(("L", dict(compression=32946, predictor=2)))
    return cases


@pytest.mark.parametrize("name, kw", _hand_cases(), ids=lambda v: str(v).replace(" ", ""))
def test_hand_built_tiff_decodes_equal(name, kw):
    rng = np.random.default_rng(zlib.crc32(repr((name, kw)).encode()))
    assert_same_as_pillow(hand_built(name, rng, **kw))


def test_lzw_past_4096_codes_with_clears():
    """A noisy 200 × 120 RGB strip runs the table to 12 bits and Clear
    codes, new style and old style."""
    rng = np.random.default_rng(5)
    samples = rng.integers(0, 256, (120, 200, 3), dtype=np.uint8)
    for comp in (5, "lzw_old"):
        raw = write_tiff(samples, (8, 8, 8), 2, compression=comp)
        got = assert_equal_to_pillow(raw)
        np.testing.assert_array_equal(got, samples)


def test_short_palette_and_grey_ramp_past_it():
    """A ColorMap shorter than the depth's 2^bits entries: what Pillow
    reads for indices past it."""
    rng = np.random.default_rng(8)
    samples = rng.integers(0, 16, (10, 12, 1), dtype=np.uint8)
    raw = write_tiff(samples, (4,), 3, colormap=rng.integers(0, 65536, 3 * 8).tolist())
    assert_equal_to_pillow(raw)


# -- refusals --------------------------------------------------------------------------------------


@pytest.mark.parametrize("compression, name", [
    (32809, "ThunderScan-compressed TIFF"), (32771, "CCITT RLEW-compressed TIFF"), (34676, "SGILog-compressed TIFF"),
    (34677, "SGILog24"), (9999, "TIFF compression 9999")])
def test_refused_compressions_raise_by_name(compression, name):
    raw = hand_built("RGB", np.random.default_rng(0), tags={259: (3, [compression])})
    with pytest.raises(UnsupportedImageFormat, match=name) as err:
        decode_tiff(raw)
    assert name in err.value.format


@pytest.mark.parametrize("photometric, bits, tags, name", [
    (6, (8, 8, 8), {}, "uncompressed YCbCr TIFF"), (6, (8, 8, 8), {530: (3, [2, 2])}, "uncompressed YCbCr TIFF"),
    (6, (8, 8, 8), {259: (3, [5]), 317: (3, [2])}, "YCbCr TIFF with a predictor"),
    (1, (12,), {259: (3, [7])}, "12-bit JPEG-compressed TIFF"), (1, (8,), {0xBC01: (3, [1])}, "Windows Media Photo")])
def test_unread_pillow_layouts_raise_by_name(photometric, bits, tags, name):
    """Layouts of Pillow's table this module still refuses by name (the
    data is never read: the refusal comes first)."""
    samples = np.zeros((4, 6, len(bits)), np.uint8)
    raw = write_tiff(samples, (8,) * len(bits), photometric, tags={258: (3, list(bits)), **tags})
    with pytest.raises(UnsupportedImageFormat, match=name):
        decode_tiff(raw)


@pytest.mark.parametrize("name", ["RGB16", "CMYK16", "L2"])
def test_uncompressed_planar_data_pillow_misreads_is_refused(name):
    raw = hand_built(name, np.random.default_rng(1), compression=1, planar=2)
    with pytest.raises(UnsupportedImageFormat, match="planar TIFF"):
        decode_tiff(raw)


@pytest.mark.parametrize("case", ["layout", "predictor3", "predictor2_4bit", "bomb", "no_strips"])
def test_data_both_refuse(case):
    rng = np.random.default_rng(2)
    if case == "layout":  # RGB with two samples: not in Pillow's table
        raw = write_tiff(np.zeros((4, 4, 2), np.uint8), (8, 8), 2)
    elif case == "predictor3":
        raw = hand_built("L", rng, compression=5, tags={317: (3, [3])})
    elif case == "predictor2_4bit":
        raw = hand_built("L4", rng, compression=5, tags={317: (3, [2])})
    elif case == "bomb":
        raw = write_tiff(np.zeros((4, 4, 1), np.uint8), (8,), 1, tags={256: (4, [20000]), 257: (4, [10000])})
    else:
        raw = write_tiff(np.zeros((4, 4, 1), np.uint8), (8,), 1)
        at = raw.index(struct.pack("<HHL", 273, 4, 1))
        raw = raw[:at] + struct.pack("<HHL", 999, 4, 1) + raw[at + 8:]
    assert_both_refuse(raw)


def _fax_page(compression: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(page(np.random.default_rng(4), 64, 40)).convert("1").save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _set_strip_count(raw: bytes, count: int) -> bytes:
    for kind, fmt in ((4, "<L"), (3, "<HH")):
        key = struct.pack("<HHL", 279, kind, 1)
        if key in raw:
            at = raw.index(key)
            value = struct.pack(fmt, count) if kind == 4 else struct.pack(fmt, count, 0)
            return raw[:at + 8] + value + raw[at + 12:]
    raise AssertionError("no one-strip StripByteCounts entry")


@pytest.mark.parametrize("compression", [5, 8, 32773, "tiff_ccitt", 1])
def test_truncated_strips_both_refuse(compression):
    """Strips whose data ends before their rows: libtiff's "Not enough
    data", and Pillow's "image file is truncated" for raw data."""
    if compression == "tiff_ccitt":
        raw = _fax_page(compression)
        count = Image.open(io.BytesIO(raw)).tag_v2[279][0]
        raw = _set_strip_count(raw, count // 3)
    elif compression == 1:
        raw = hand_built("RGB", np.random.default_rng(4), compression=1)[:200]
    else:
        raw = hand_built("RGB", np.random.default_rng(4), compression=compression)
        short = ENCODERS[compression](b"\x01" * 10)
        raw = _set_strip_count(raw[:8] + short + raw[8 + len(short):], len(short))
    assert_both_refuse(raw)


@pytest.mark.parametrize("compression", ["group3", "group4"])
def test_truncated_t4_t6_strips_raise(compression):
    """libtiff pads a T.4 or T.6 strip that ends early with zero bits and
    decodes on (bad code words padded white, a G4 strip's unreached rows
    left as they were); the port raises (ROADMAP Queue 3)."""
    raw = _fax_page(compression)
    raw = _set_strip_count(raw, Image.open(io.BytesIO(raw)).tag_v2[279][0] // 3)
    with pytest.raises(ImageDecodeError, match="ends before the last row"):
        decode_image(raw)


# -- fax runs that end past the width, short of it, or past 32 bits -------------------------------

EOL = "000000000001"
WHITE_10, WHITE_0, BLACK_2, BLACK_0 = "00111", "00110101", "11", "0000110111"
MAKEUP_64_BLACK, MAKEUP_2560 = "0000001111", "000000011111"  # 2560: the makeup code both colours share
HORIZONTAL, VR3 = "001", "0000011"


def _bits(s: str) -> bytes:
    return np.packbits(np.frombuffer(s.encode(), np.uint8) - ord("0")).tobytes()


def fax_tiff(compression: int, data: bytes, width: int, rows: int, t4: int = 0) -> bytes:
    """A one-strip bilevel TIFF (photometric 0) around fax-coded `data`."""
    entries = [(256, 4, width), (257, 4, rows), (258, 3, 1), (259, 3, compression), (262, 3, 0),
               (273, 4, 8), (277, 3, 1), (278, 4, rows), (279, 4, len(data))]
    if compression == 3:
        entries.append((292, 4, t4))
    pad = len(data) & 1
    out = b"II*\x00" + struct.pack("<L", 8 + len(data) + pad) + data + b"\x00" * pad
    out += struct.pack("<H", len(entries))
    for tag, kind, v in entries:
        out += struct.pack("<HHL", tag, kind, 1) + (struct.pack("<HH", v, 0) if kind == 3 else struct.pack("<L", v))
    return out + b"\x00" * 4


@pytest.mark.parametrize("compression, t4, width, code", [
    (2, 0, 64, WHITE_10 + MAKEUP_2560 + BLACK_0),  # a black run past the width
    (3, 0, 64, EOL + WHITE_10 + MAKEUP_2560 + BLACK_0 + EOL),
    (3, 0, 64, EOL + WHITE_10 + BLACK_2 + EOL),  # an EOL ends the row short of the width
    (3, 0, 64, EOL + WHITE_10 + EOL),
    (3, 0, 128, EOL + WHITE_10 + MAKEUP_64_BLACK + EOL),  # a makeup code, then the EOL
    (3, 1, 64, EOL + "0" + VR3 + EOL),  # a 2-D change past the width
    (4, 0, 64, VR3 + VR3),
], ids=["mh_past", "t4_past", "t4_short", "t4_short_white", "t4_makeup_eol", "t4_2d_past", "t6_past"])
def test_fax_rows_past_or_short_of_the_width_decode_equal(compression, t4, width, code):
    """libtiff's CLEANUP_RUNS: changes past the width go, and the row ends
    white."""
    assert_equal_to_pillow(fax_tiff(compression, _bits(code), width, 1, t4))


@pytest.mark.parametrize("rows", [2, 1000], ids=["strip_limited", "whole_strip"])
@pytest.mark.parametrize("compression, t4, head, tail", [
    (2, 0, "", WHITE_0 + BLACK_0 + EOL),
    (3, 0, EOL, WHITE_0 + BLACK_0 + EOL),
    (3, 1, EOL + "0" + HORIZONTAL, WHITE_0 + BLACK_0 + EOL),
    (4, 0, HORIZONTAL, WHITE_0 + BLACK_0 + EOL + EOL),
], ids=["mh", "t4", "t4_2d", "t6"])
def test_fax_run_past_32_bits_raises(compression, t4, head, tail, rows):
    """A white run of 838,862 makeup codes of 2560 (1.26 MB of strip)
    sums past 2**31. Over a 64 × 2 image libtiff reads only 10 × the
    strip's 16 bytes + 4096 of it, as the port does: the data ends
    inside the run (Pillow refuses the modified Huffman and 2-D T.4
    strips and pads the others, ROADMAP Queue 3). Over 1024 × 1000 the
    whole strip is read and the run is refused as a bad code word."""
    n = 838_862
    bits = np.frombuffer((head + MAKEUP_2560 * n + tail).encode(), np.uint8) - ord("0")
    raw = fax_tiff(compression, np.packbits(bits).tobytes(), 64 if rows == 2 else 1024, rows, t4)
    match = "ends before the last row" if rows == 2 else "a bad code word"
    with pytest.raises(ImageDecodeError, match=match):
        decode_image(raw)
    if rows == 2 and (compression == 2 or t4 == 1):
        with pytest.raises(Exception):
            pillow_rgb(raw)


# -- CIELab, 12- and 32-bit samples, LZMA ---------------------------------------------------------


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "tiff_lzma"])
@pytest.mark.parametrize("mode", ["LAB", "I", "F", "I;16", "L", "RGB"])
def test_pillow_written_lab_wide_and_lzma(mode, compression):
    """Pillow's own LAB, I (I;32S) and F (F;32F) files, and LZMA for the
    modes it writes."""
    rng = np.random.default_rng(zlib.crc32(repr((mode, compression)).encode()))
    if mode in ("I", "F"):
        v = rng.normal(120, 150, (29, 45)).astype(np.float32)
        v[0, :8] = [-5.5, 0.4, 0.5, 1.5, 254.6, 300.0, np.inf, np.nan] if mode == "F" else [-5, 0, 100, 255, 256,
                                                                                              70000, -1, 2 ** 31 - 1]
        im = Image.frombytes(mode, (45, 29), (v if mode == "F" else v.astype(np.int32)).tobytes())
    elif mode == "LAB":
        im = Image.frombytes("LAB", (45, 29), rng.integers(0, 256, (29, 45, 3), dtype=np.uint8).tobytes())
    else:
        im = pillow_image(mode, rng)
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression)
    assert_equal_to_pillow(buf.getvalue())


def _wide_file(values: np.ndarray, kind: str, photometric: int, *, endian="<", compression=1, predictor=1,
               rows_per_strip=None, fmt=None, tags=None) -> bytes:
    """32-bit samples [h, w] of `kind` (i4, u4, f4) → a TIFF, the
    predictor applied here; written through write_tiff as bytes."""
    h, w = values.shape
    raw = values.astype(endian + kind)
    if predictor == 2:
        u = raw.view(endian + "u4").astype(np.uint64)
        raw = (np.diff(u, axis=1, prepend=0) % (1 << 32)).astype(endian + "u4")
    data = np.frombuffer(raw.tobytes(), np.uint8).reshape(h, w * 4)
    if predictor == 3:  # byte planes, most significant first, then byte differences
        be = data.reshape(h, w, 4)[..., ::-1] if endian == "<" else data.reshape(h, w, 4)
        planes = be.transpose(0, 2, 1).reshape(h, w * 4)
        data = np.diff(planes.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    fmt = fmt or {"i4": 2, "u4": 1, "f4": 3}[kind]
    extra = {256: (4, [w]), 258: (3, [32]), 277: (3, [1]), 339: (3, [fmt])}
    if predictor != 1:
        extra[317] = (3, [predictor])
    extra.update(tags or {})
    return write_tiff(data.reshape(h, w * 4, 1), (8,), photometric, endian=endian, compression=compression,
                      rows_per_strip=rows_per_strip, tags=extra)


def _wide_values(rng, kind: str, h=13, w=21) -> np.ndarray:
    if kind == "f4":
        v = rng.normal(100, 200, (h, w)).astype(np.float32)
        v[0, :10] = [-5.5, 0.4, 0.5, 1.5, 254.6, 254.99, 255.0, np.inf, -np.inf, np.nan]
        return v
    v = rng.integers(-400, 600, (h, w)).astype(np.int64)
    v[0, :6] = [-2 ** 31, 2 ** 31 - 1, 0, 255, 256, 70000]
    return v.astype(np.int32 if kind == "i4" else np.int64).astype(kind.replace("i4", "int32").replace(
        "u4", "uint32"))


@pytest.mark.parametrize("compression", [1, 5, 8, 34925])
@pytest.mark.parametrize("kind, photometric, endian, predictor", [
    ("i4", 1, "<", 1), ("i4", 1, ">", 1), ("u4", 1, "<", 1), ("f4", 1, "<", 1), ("f4", 1, ">", 1),
    ("f4", 0, "<", 1), ("f4", 0, ">", 1), ("i4", 1, "<", 2), ("i4", 1, ">", 2), ("f4", 1, "<", 2),
    ("f4", 1, "<", 3), ("f4", 1, ">", 3), ("f4", 0, "<", 3), ("u4", 1, ">", 1), ("i4", 0, "<", 1)])
def test_thirty_two_bit_samples(kind, photometric, endian, predictor, compression):
    """I;32N, I;32S, I;32BS, F;32F and F;32BF: clipped to 0..255 (F
    truncated, NaN 0); compressed big-endian values come out byte-swapped
    (libtiff hands over native order, Pillow reads the file's); Predictor
    2 and 3 (floating point) as libtiff undoes them. Photometric 0 reads F
    uninverted; big-endian unsigned and photometric-0 integers are no row
    of Pillow's table."""
    if predictor != 1 and compression == 1:
        predictor = 1
    rng = np.random.default_rng(zlib.crc32(repr((kind, photometric, endian, predictor, compression)).encode()))
    assert_same_as_pillow(_wide_file(_wide_values(rng, kind), kind, photometric, endian=endian,
                                     compression=compression, predictor=predictor, rows_per_strip=5))


def _twelve_bit_file(values: np.ndarray, *, endian="<", compression=1, predictor=1) -> bytes:
    h, w = values.shape
    padded = np.zeros((h, w + (w & 1)), np.uint16)
    padded[:, :w] = values
    a, b = padded[:, 0::2], padded[:, 1::2]
    packed = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], axis=2).reshape(h, -1).astype(np.uint8)
    packed = packed[:, :-(-w * 12 // 8)]
    tags = {256: (4, [w]), 258: (3, [12])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    return write_tiff(packed[..., None], (8,), 1, endian=endian, compression=compression, rows_per_strip=4,
                      tags=tags)


@pytest.mark.parametrize("width", [1, 2, 7, 20])
@pytest.mark.parametrize("compression", [1, 5, 8, 34925])
def test_twelve_bit_grey(compression, width):
    """I;12 → I;16 → clipped at 255; odd widths end on half a byte."""
    rng = np.random.default_rng(width * 10 + compression)
    v = rng.integers(0, 4096, (9, width))
    v[0, 0] = 255
    assert_equal_to_pillow(_twelve_bit_file(v, compression=compression))


@pytest.mark.parametrize("case", ["big_endian", "predictor2", "predictor3_integer", "fill_order2"])
def test_twelve_bit_layouts_both_refuse(case):
    v = np.random.default_rng(3).integers(0, 4096, (6, 9))
    if case == "big_endian":  # Pillow's 12-bit row is little-endian only
        raw = _twelve_bit_file(v, endian=">")
    elif case == "predictor2":
        raw = _twelve_bit_file(v, compression=5, predictor=2)
    elif case == "predictor3_integer":
        raw = _wide_file(_wide_values(np.random.default_rng(1), "i4"), "i4", 1, compression=5, predictor=3)
    else:
        raw = _twelve_bit_file(v)
        at = raw.index(struct.pack("<HHL", 262, 3, 1))
        raw = raw[:at] + struct.pack("<HHLHH", 266, 3, 1, 2, 0) + raw[at + 12:]  # Photometric → FillOrder 2
    assert_both_refuse(raw)


@pytest.mark.parametrize("kw", [dict(compression=1), dict(compression=5, predictor=2), dict(compression=8),
                                dict(compression=1, planar=2), dict(compression=5, planar=2),
                                dict(compression=34925, tile=(16, 16)), dict(compression=32773, endian=">")],
                         ids=lambda v: str(v).replace(" ", ""))
def test_hand_built_cielab(kw):
    """CIELab: contiguous samples through Pillow's LAB unpacker (a and b
    offset by 128); planes through its one-band unpackers, which copy."""
    rng = np.random.default_rng(zlib.crc32(repr(kw).encode()))
    samples = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    assert_same_as_pillow(write_tiff(samples, (8, 8, 8), 8, **kw))


def lab_grid_matches_pillow(stride: int) -> int:
    """Every `stride`-th of the 2^24 (L, a, b) triples as an uncompressed
    CIELab TIFF, decoded here and by Pillow: the number of triples."""
    v = np.arange(0, 1 << 24, stride, dtype=np.uint32)
    v = np.concatenate([v, np.zeros(-len(v) % 4096, np.uint32)])
    lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], axis=1).astype(np.uint8).reshape(-1, 4096, 3)
    raw = write_tiff(lab, (8, 8, 8), 8)
    np.testing.assert_array_equal(decode_image(raw), pillow_rgb(raw))
    return len(v)


def test_cielab_matches_pillow_on_a_strided_subset():
    """LittleCMS's Lab → sRGB transform as native/tiff_color.cpp rebuilds
    it, on every 61st input (275,000 of them). The whole 2^24 is
    ``lab_grid_matches_pillow(1)`` (a 4096 × 4096 file, ~10 s)."""
    assert lab_grid_matches_pillow(61) >= (1 << 24) // 61
