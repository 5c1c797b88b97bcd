"""JPEG-in-TIFF (compression 7) and YCbCr TIFF through libtiff's RGBA
reader, image/tiff.py against Pillow 12.1 over libtiff 4.7 and against the
reference's ``dsocr_tpu.server.messages.load_image`` on data:image/tiff
URLs: every case decodes to the same array in all three, or the port
raises ``ImageDecodeError`` where Pillow raises.

- Pillow-written files: JPEG in RGB, L, YCbCr (1×1) and CMYK, one strip
  or several; LZW, Deflate, PackBits and LZMA YCbCr (1×1);
- files written here for what Pillow cannot or must not write (its
  libtiff writer corrupts the heap on subsampled YCbCr JPEG): YCbCr JPEG
  strips and tiles at 4:4, 4:2, 4:1, 2:2, 2:1, 1:2 and 1:1 from the
  NumPy baseline encoder of tests/test_torch_jpeg.py, with JPEGTables or
  tables in each strip, YCbCrSubsampling given or read from the first
  strip; markers that disagree with Photometric; frames larger or smaller
  than their strip; restart intervals and progressive strips; planar
  data; truncated strips; packed YCbCr data units under LZW, Deflate,
  PackBits and LZMA at every subsampling, odd sizes, strips and tiles,
  other YCbCrCoefficients and ReferenceBlackWhite, every Orientation;
- what stays refused by name (12-bit JPEG strips, old-style JPEG,
  Zstandard, RLEW, ThunderScan, SGILog, SGILog24, WebP, uncompressed
  YCbCr).
"""

import base64
import io
import lzma
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu.server.messages import load_image as reference_load_image
from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image
from dsocr_tpu_torch.server.messages import load_image
from tests.test_torch_jpeg import encode_baseline, planes_for
from tests.test_torch_tiff import lzw_encode, packbits_encode

ENCODE = {5: lzw_encode, 8: zlib.compress, 32773: packbits_encode, 34925: lambda b: lzma.compress(b)}
SUBSAMPLINGS = [(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)]


def data_url(raw: bytes) -> str:
    return "data:image/tiff;base64," + base64.standard_b64encode(raw).decode()


def pillow_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def assert_same(raw: bytes) -> np.ndarray:
    """Equal to Pillow's pixels and the reference's load_image, or
    refused where Pillow refuses."""
    try:
        want = pillow_rgb(raw)
    except Exception:  # noqa: BLE001 - Pillow's refusals are OSError, SyntaxError, ValueError, ...
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return None
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_image(data_url(raw)), reference_load_image(data_url(raw)))
    return got


# -- assembling files ------------------------------------------------------------------------------


def tiff(blocks, width: int, height: int, bits, photometric: int, compression: int, *, tile=None, rps=None,
         planar: int = 1, endian: str = "<", tags=None) -> bytes:
    """Encoded strips or tiles (in file order) → a TIFF file. `tags`:
    {tag: (type, values)}; type 5 takes (numerator, denominator) pairs, 7
    bytes."""
    spp = len(bits)
    body = bytearray(8)
    offsets = []
    for b in blocks:
        offsets.append(len(body))
        body += b
        if len(body) % 2:
            body += b"\0"
    entries = {256: (4, [width]), 257: (4, [height]), 258: (3, list(bits)), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        entries.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, offsets),
                        325: (4, [len(b) for b in blocks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [rps or height]), 279: (4, [len(b) for b in blocks])})
    entries.update(tags or {})
    ifd_at = len(body)
    values = bytearray()
    head = 2 + 12 * len(entries) + 4
    table = struct.pack(endian + "H", len(entries))
    for tag in sorted(entries):
        kind, vals = entries[tag]
        if kind == 7:
            data, count = bytes(vals), len(vals)
        elif kind == 5:
            data, count = struct.pack(endian + "L" * 2 * len(vals), *[x for pair in vals for x in pair]), len(vals)
        else:
            data, count = struct.pack(endian + {3: "H", 4: "L"}[kind] * len(vals), *vals), len(vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack(endian + "L", ifd_at + head + len(values))
            values += data
            if len(values) % 2:
                values += b"\0"
        table += struct.pack(endian + "HHL", tag, kind, count) + field
    table += b"\0\0\0\0"
    body[:8] = (b"II*\x00" if endian == "<" else b"MM\x00*") + struct.pack(endian + "L", ifd_at)
    return bytes(body + table + values)


def split_tables(stream: bytes):
    """A JPEG stream → (a tables-only stream of its DQT and DHT segments,
    the stream without them)."""
    pos, tables, rest = 2, b"", b"\xff\xd8"
    while True:
        code = stream[pos + 1]
        if code == 0xDA:
            return b"\xff\xd8" + tables + b"\xff\xd9", rest + stream[pos:]
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        segment = stream[pos:pos + 2 + length]
        if code in (0xDB, 0xC4):
            tables += segment
        else:
            rest += segment
        pos += 2 + length


def pillow_jpeg(pixels: np.ndarray, mode: str = "RGB", **options) -> bytes:
    buf = io.BytesIO()
    Image.frombytes(mode, (pixels.shape[1], pixels.shape[0]), np.ascontiguousarray(pixels).tobytes()).save(
        buf, "JPEG", **options)
    return buf.getvalue()


def noise(rng, h: int, w: int, c: int) -> np.ndarray:
    """Smooth fields with some noise, so that JPEG keeps detail."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (3 + i) + y * (5 - i)) % 256 for i in range(c)], axis=2)
    return np.clip(base + rng.integers(-40, 40, (h, w, c)), 0, 255).astype(np.uint8)


def ycbcr_jpeg_strips(rng, width, height, factors, rps, *, tables=True, last_full=False, **kw):
    """YCbCr samples cut into strips of `rps` rows, each a baseline JPEG
    (component ids 1, 2, 3) at `factors` for the luma → (blocks, JPEGTables
    or None)."""
    img = noise(rng, height, width, 3)
    fs = [factors, (1, 1), (1, 1)]
    blocks = []
    for y in range(0, height, rps):
        part = img[y:y + rps]
        if last_full and part.shape[0] < rps:
            part = np.concatenate([part, np.repeat(part[-1:], rps - part.shape[0], axis=0)])
        blocks.append(encode_baseline(planes_for(part, fs), fs, width, part.shape[0], **kw))
    if not tables:
        return blocks, None
    shared = split_tables(blocks[0])[0]
    return [split_tables(b)[1] for b in blocks], shared


def jpeg_tiff(blocks, shared, width, height, photometric, spp, *, sampling=None, rps=None, tile=None, tags=None):
    extra = dict(tags or {})
    if shared is not None:
        extra[347] = (7, shared)
    if sampling is not None:
        extra[530] = (3, list(sampling))
    return tiff(blocks, width, height, (8,) * spp, photometric, 7, rps=rps, tile=tile, tags=extra)


# -- Pillow-written files --------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [60, 95])
@pytest.mark.parametrize("rows", [None, 16])
@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr", "CMYK"])
def test_pillow_written_jpeg_tiff(mode, rows, quality):
    rng = np.random.default_rng(zlib.crc32(repr((mode, rows, quality)).encode()))
    px = noise(rng, 37, 45, 4)
    im = Image.fromarray(px[..., :3]).convert(mode) if mode != "CMYK" else Image.frombytes(
        "CMYK", (45, 37), px.tobytes())
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression="jpeg", quality=quality, tiffinfo={278: rows} if rows else {})
    assert_same(buf.getvalue())


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate", "packbits", "tiff_lzma"])
@pytest.mark.parametrize("rows", [None, 7])
def test_pillow_written_ycbcr(compression, rows):
    """YCbCr 1×1 that libtiff's RGBA reader converts (Pillow's own
    YCbCr → RGB differs from it by 1 in about half the values)."""
    px = noise(np.random.default_rng(3), 48, 32, 3)
    buf = io.BytesIO()
    Image.frombytes("YCbCr", (32, 48), px.tobytes()).save(buf, "TIFF", compression=compression,
                                                          tiffinfo={278: rows} if rows else {})
    assert_same(buf.getvalue())


# -- JPEG files written here -----------------------------------------------------------------------


@pytest.mark.parametrize("size", [(37, 29), (45, 70)], ids=["37x29", "45x70"])
@pytest.mark.parametrize("tables", [True, False], ids=["jpegtables", "inline"])
@pytest.mark.parametrize("factors", SUBSAMPLINGS, ids=lambda f: f"{f[0]}{f[1]}")
def test_subsampled_ycbcr_jpeg_strips(factors, tables, size):
    width, height = size
    rng = np.random.default_rng(zlib.crc32(repr((factors, tables, size)).encode()))
    blocks, shared = ycbcr_jpeg_strips(rng, width, height, factors, 32, tables=tables)
    assert_same(jpeg_tiff(blocks, shared, width, height, 6, 3, sampling=factors, rps=32))


@pytest.mark.parametrize("factors", SUBSAMPLINGS, ids=lambda f: f"{f[0]}{f[1]}")
def test_ycbcr_subsampling_read_from_the_first_strip(factors):
    """No YCbCrSubsampling tag: libtiff takes the first strip's factors
    (JPEGFixupTags), where the default 2×2 would refuse most of them."""
    rng = np.random.default_rng(sum(factors))
    blocks, shared = ycbcr_jpeg_strips(rng, 29, 40, factors, 32)
    assert_same(jpeg_tiff(blocks, shared, 29, 40, 6, 3, rps=32))


@pytest.mark.parametrize("tag, stream", [((1, 1), (2, 2)), ((2, 1), (2, 2)), ((2, 2), (1, 1)), ((4, 4), (2, 2))])
def test_ycbcr_subsampling_tag_that_disagrees_with_the_strips(tag, stream):
    rng = np.random.default_rng(4)
    blocks, shared = ycbcr_jpeg_strips(rng, 33, 20, stream, 32)
    raw = jpeg_tiff(blocks, shared, 33, 20, 6, 3, sampling=tag, rps=32)
    with pytest.raises(Exception):
        pillow_rgb(raw)
    with pytest.raises(ImageDecodeError, match="sampling"):
        decode_image(raw)


@pytest.mark.parametrize("photometric, kind", [
    (2, "jfif"), (2, "ids123"), (2, "adobe1"), (6, "adobe0"), (6, "rgb_ids"), (1, "grey"), (0, "grey"),
    (5, "cmyk")])
def test_photometric_decides_the_color_space(photometric, kind):
    """libtiff sets the color space from Photometric (YCbCr → RGB for 6,
    none for the rest), whatever JFIF, Adobe or the component ids say."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    px = noise(rng, 32, 40, 4)
    if kind == "jfif":
        stream = pillow_jpeg(px[..., :3], subsampling=0)
    elif kind == "grey":
        stream = pillow_jpeg(px[..., 0], "L")
    elif kind == "cmyk":
        stream = pillow_jpeg(px, "CMYK")
    else:
        ids = [82, 71, 66] if kind == "rgb_ids" else [1, 2, 3]
        fs = [(1, 1)] * 3
        stream = encode_baseline(planes_for(px[..., :3], fs), fs, 40, 32, ids=ids)
        if kind.startswith("adobe"):
            app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, int(kind[-1])])
            stream = stream[:2] + b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big") + app14 + stream[2:]
    spp = {1: 1, 0: 1, 5: 4}.get(photometric, 3)
    assert_same(jpeg_tiff([stream], None, 40, 32, photometric, spp, sampling=(1, 1) if photometric == 6 else None))


@pytest.mark.parametrize("case", ["last_full_height", "taller", "wider", "shorter", "narrower", "last_taller_still"])
def test_strip_frames_larger_or_smaller_than_their_strip(case):
    """libtiff reads a last strip whose frame still has the full strip
    height; any other frame larger than its strip is an error, and one
    smaller leaves Pillow's rows undefined, so the port refuses it."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    width, height, rps = 40, 44, 16
    blocks, shared = ycbcr_jpeg_strips(rng, width, height, (2, 2), rps, last_full=case == "last_full_height")
    fs = [(2, 2), (1, 1), (1, 1)]
    img = noise(rng, 40, 48, 3)
    if case == "taller":  # the first strip's frame has 24 rows
        blocks[0] = split_tables(encode_baseline(planes_for(img[:24, :width], fs), fs, width, 24))[1]
    elif case == "wider":
        blocks[1] = split_tables(encode_baseline(planes_for(img[:16, :48], fs), fs, 48, 16))[1]
    elif case == "shorter":
        blocks[0] = split_tables(encode_baseline(planes_for(img[:8, :width], fs), fs, width, 8))[1]
    elif case == "narrower":
        blocks[0] = split_tables(encode_baseline(planes_for(img[:16, :32], fs), fs, 32, 16))[1]
    elif case == "last_taller_still":  # more rows than the strip could hold
        blocks[-1] = split_tables(encode_baseline(planes_for(img[:24, :width], fs), fs, width, 24))[1]
    raw = jpeg_tiff(blocks, shared, width, height, 6, 3, sampling=(2, 2), rps=rps)
    if case in ("shorter", "narrower"):
        with pytest.raises(ImageDecodeError, match="smaller"):
            decode_image(raw)
        return
    got = assert_same(raw)
    assert (got is not None) == (case in ("last_full_height", "last_taller_still"))


@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
@pytest.mark.parametrize("kind", ["ycbcr22", "ycbcr11", "rgb", "grey"])
def test_jpeg_tiles(kind, tile):
    rng = np.random.default_rng(zlib.crc32(repr((kind, tile)).encode()))
    width, height = 45, 37
    tw, th = tile
    img = noise(rng, -(-height // th) * th, -(-width // tw) * tw, 3)
    blocks = []
    for y in range(0, height, th):
        for x in range(0, width, tw):
            part = img[y:y + th, x:x + tw]
            if kind.startswith("ycbcr"):
                fs = [(2, 2) if kind == "ycbcr22" else (1, 1), (1, 1), (1, 1)]
                blocks.append(encode_baseline(planes_for(part, fs), fs, tw, th))
            else:
                blocks.append(pillow_jpeg(part[..., 0], "L") if kind == "grey" else pillow_jpeg(part, subsampling=0))
    photometric, spp = {"rgb": (2, 3), "grey": (1, 1)}.get(kind, (6, 3))
    sampling = (2, 2) if kind == "ycbcr22" else (1, 1) if kind == "ycbcr11" else None
    assert_same(jpeg_tiff(blocks, None, width, height, photometric, spp, sampling=sampling, tile=tile))


@pytest.mark.parametrize("kind", ["restart", "progressive", "optimize"])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_restart_and_progressive_strips(kind, subsampling):
    """Pillow-encoded JFIF strips (inline tables) under photometric 6."""
    rng = np.random.default_rng(zlib.crc32(repr((kind, subsampling)).encode()))
    img = noise(rng, 40, 37, 3)
    options = {"restart": {"restart_marker_blocks": 2}, "progressive": {"progressive": True},
               "optimize": {"optimize": True}}[kind]
    blocks = [pillow_jpeg(img[y:y + 16], subsampling=subsampling, **options) for y in range(0, 40, 16)]
    factors = (2, 2) if subsampling == 2 else (1, 1)
    assert_same(jpeg_tiff(blocks, None, 37, 40, 6, 3, sampling=factors, rps=16))


def test_tables_carry_from_strip_to_strip():
    """With no JPEGTables, the tables of one strip stay with libjpeg for
    the next strips that carry none."""
    rng = np.random.default_rng(6)
    blocks, shared = ycbcr_jpeg_strips(rng, 30, 48, (2, 2), 16, tables=False)
    blocks = [blocks[0]] + [split_tables(b)[1] for b in blocks[1:]]
    assert_same(jpeg_tiff(blocks, None, 30, 48, 6, 3, sampling=(2, 2), rps=16))
    with pytest.raises(ImageDecodeError):  # the first strip without tables has none to use
        decode_image(jpeg_tiff([split_tables(b)[1] for b in blocks], None, 30, 48, 6, 3, sampling=(2, 2), rps=16))


@pytest.mark.parametrize("photometric, sampling", [(2, None), (6, (1, 1)), (6, None)])
def test_planar_jpeg(photometric, sampling):
    """Each plane a one-component JPEG: RGB through Pillow's planar
    reader, YCbCr 1×1 through libtiff's RGBA reader, and YCbCr left at
    the default 2×2 refused by both."""
    rng = np.random.default_rng(photometric)
    img = noise(rng, 24, 29, 3)
    blocks = [pillow_jpeg(img[y:y + 16, :, c], "L") for c in range(3) for y in range(0, 24, 16)]
    assert_same(tiff(blocks, 29, 24, (8, 8, 8), photometric, 7, rps=16, planar=2,
                     tags={530: (3, list(sampling))} if sampling else None))


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_jpeg_strips_read_on_as_libtiff_does(cut, progressive):
    """A strip whose JPEG data ends early: libtiff's source manager
    inserts an EOI, and the rows past the data decode as libjpeg leaves
    them; a byte count past the end of the file is refused by both."""
    rng = np.random.default_rng(int(cut * 100) + progressive)
    img = noise(rng, 32, 40, 3)
    blocks = [pillow_jpeg(img[y:y + 16], subsampling=2, progressive=progressive) for y in (0, 16)]
    blocks[1] = blocks[1][:int(len(blocks[1]) * cut)]
    assert_same(jpeg_tiff(blocks, None, 40, 32, 6, 3, sampling=(2, 2), rps=16))
    raw = bytearray(jpeg_tiff(blocks, None, 40, 32, 6, 3, sampling=(2, 2), rps=16))
    at = raw.index(struct.pack("<HHL", 279, 4, 2))
    counts_at = struct.unpack("<L", raw[at + 8:at + 12])[0]
    raw[counts_at + 4:counts_at + 8] = struct.pack("<L", 10 ** 6)
    assert_same(bytes(raw))


def test_twelve_bit_jpeg_strips_are_refused_by_name():
    """Pillow reads a 12-bit JPEG strip under BitsPerSample 12 as I;12
    (libjpeg's 12-bit decoder, which the port has not); under
    BitsPerSample 8 both refuse it."""
    stream = bytearray(pillow_jpeg(noise(np.random.default_rng(2), 16, 20, 1)[..., 0], "L"))
    at = stream.index(b"\xff\xc0")
    stream[at + 4] = 12
    with pytest.raises(UnsupportedImageFormat, match="12-bit JPEG-compressed TIFF"):
        decode_image(tiff([bytes(stream)], 20, 16, (12,), 1, 7))
    assert_same(tiff([bytes(stream)], 20, 16, (8,), 1, 7))


# -- YCbCr data units (LZW, Deflate, PackBits, LZMA) --------------------------------------------------


def ycbcr_units(rng, width: int, rows: int, hs: int, vs: int) -> bytes:
    """Packed data units for `rows` rows: a smooth luma, chroma a unit."""
    across, down = -(-width // hs), -(-rows // vs)
    y = noise(rng, down * vs, across * hs, 1)[..., 0]
    luma = y.reshape(down, vs, across, hs).transpose(0, 2, 1, 3).reshape(down, across, hs * vs)
    chroma = rng.integers(0, 256, (down, across, 2), dtype=np.uint8)
    return np.concatenate([luma, chroma], axis=2).tobytes()


def ycbcr_tiff(rng, width, height, factors, compression, *, rps=None, tile=None, tags=None, endian="<"):
    hs, vs = factors
    blocks = []
    if tile:
        tw, th = tile
        for _ in range(-(-height // th) * -(-width // tw)):
            blocks.append(ENCODE[compression](ycbcr_units(rng, tw, th, hs, vs)))
    else:
        rps = rps or height
        for y in range(0, height, rps):
            blocks.append(ENCODE[compression](ycbcr_units(rng, width, min(rps, height - y), hs, vs)))
    extra = {530: (3, [hs, vs])}
    extra.update(tags or {})
    return tiff(blocks, width, height, (8, 8, 8), 6, compression, rps=rps, tile=tile, tags=extra, endian=endian)


@pytest.mark.parametrize("layout", ["one_strip", "strips_8", "strips_5", "tiles"])
@pytest.mark.parametrize("compression", [5, 8, 32773, 34925])
@pytest.mark.parametrize("factors", SUBSAMPLINGS, ids=lambda f: f"{f[0]}{f[1]}")
def test_subsampled_ycbcr_data_units(factors, compression, layout):
    """putcontig8bitYCbCr{hs}{vs}tile over 37 × 23 pixels (partial units at
    the right and bottom), strips whose height is or is not a multiple of
    the units', and 16 × 16 tiles."""
    rng = np.random.default_rng(zlib.crc32(repr((factors, compression, layout)).encode()))
    kw = {"one_strip": {}, "strips_8": {"rps": 8}, "strips_5": {"rps": 5}, "tiles": {"tile": (16, 16)}}[layout]
    assert_same(ycbcr_tiff(rng, 37, 23, factors, compression, **kw))


@pytest.mark.parametrize("width", [1, 4, 5, 9, 13])
def test_four_by_four_units_of_odd_rows(width):
    """4×4 strips whose unit count a row is odd: libtiff asks for 2 bytes
    less a unit row than the strip holds, which read as zeros."""
    rng = np.random.default_rng(width)
    assert_same(ycbcr_tiff(rng, width, 11, (4, 4), 5, rps=4))
    assert_same(ycbcr_tiff(rng, width, 11, (4, 4), 8))


@pytest.mark.parametrize("coefficients, reference", [
    (((2990, 10000), (5870, 10000), (1140, 10000)), ((0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1))),
    (((2126, 10000), (7152, 10000), (722, 10000)), ((16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1))),
    (((1, 3), (1, 3), (1, 3)), ((15, 1), (200, 1), (100, 1), (170, 1), (140, 1), (300, 1))),
    (None, ((0, 1), (0, 1), (128, 1), (128, 1), (0, 1), (0, 1))),
])
def test_ycbcr_coefficients_and_reference_range(coefficients, reference):
    """TIFFYCbCrToRGBInit's float tables: BT.601, BT.709 with studio
    range, odd ones, and a degenerate range (RW == RB)."""
    rng = np.random.default_rng(len(repr(reference)))
    tags = {532: (5, list(reference))}
    if coefficients:
        tags[529] = (5, list(coefficients))
    assert_same(ycbcr_tiff(rng, 21, 17, (2, 2), 5, rps=8, tags=tags))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", ["lzw_strips", "lzw_tiles", "jpeg"])
def test_orientation(kind, orientation):
    """TIFFRGBAImage flips each block it reads as the Orientation tag asks
    (Pillow requests top-left), then Pillow's exif_transpose turns the
    image; JPEG strips converted by libjpeg are only turned."""
    rng = np.random.default_rng(orientation)
    tags = {274: (3, [orientation])}
    if kind == "jpeg":
        blocks, shared = ycbcr_jpeg_strips(rng, 27, 37, (2, 1), 16)
        raw = jpeg_tiff(blocks, shared, 27, 37, 6, 3, sampling=(2, 1), rps=16, tags=tags)
    else:
        kw = {"rps": 7} if kind == "lzw_strips" else {"tile": (16, 16)}
        raw = ycbcr_tiff(rng, 27, 37, (2, 2), 5, tags=tags, **kw)
    assert_same(raw)


@pytest.mark.parametrize("case", ["cut_last", "cut_first", "past_end_last", "past_end_first", "corrupt",
                                  "tile_past_end", "tile_cut"])
def test_damaged_ycbcr_strips_read_on_as_libtiff_does(case):
    """TIFFRGBAImage runs with stoponerr 0 over a buffer Pillow's call
    makes for each strip or row of tiles: a block that fails to decode
    keeps what did decode, then zeros; a strip that cannot be read fails,
    and so does a row's first tile, while a later tile that cannot be
    read reads as zeros."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case.startswith("tile"):
        blocks = [lzw_encode(ycbcr_units(rng, 16, 16, 2, 2)) for _ in range(6)]  # 3 × 2 tiles over 40 × 20
        if case == "tile_cut":
            blocks[4] = blocks[4][:len(blocks[4]) // 3]
        raw = bytearray(tiff(blocks, 40, 20, (8, 8, 8), 6, 5, tile=(16, 16), tags={530: (3, [2, 2])}))
        if case == "tile_past_end":
            at = raw.index(struct.pack("<HHL", 325, 4, 6))
            counts_at = struct.unpack("<L", raw[at + 8:at + 12])[0]
            raw[counts_at + 16:counts_at + 20] = struct.pack("<L", 10 ** 6)  # the second row's second tile
        assert_same(bytes(raw))
        return
    width, height, rps = 18, 16, 4
    blocks = [lzw_encode(ycbcr_units(rng, width, rps, 2, 2)) for _ in range(4)]
    index = 0 if case.endswith("first") else 3
    if case.startswith("cut"):
        blocks[index] = blocks[index][:len(blocks[index]) // 2]
    if case == "corrupt":
        blocks[1] = bytes([0x80]) + bytes(rng.integers(0, 256, 30, dtype=np.uint8))
    raw = bytearray(tiff(blocks, width, height, (8, 8, 8), 6, 5, rps=rps, tags={530: (3, [2, 2])}))
    if case.startswith("past_end"):
        at = raw.index(struct.pack("<HHL", 279, 4, 4))
        counts_at = struct.unpack("<L", raw[at + 8:at + 12])[0]
        raw[counts_at + 4 * index:counts_at + 4 * index + 4] = struct.pack("<L", 10 ** 6)
    assert_same(bytes(raw))


@pytest.mark.parametrize("case", ["planar_11", "planar_22", "planar_default", "one_sample", "subsampling_31",
                                  "big_endian", "coefficients_zero"])
def test_other_ycbcr_layouts(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    width, height = 19, 13
    if case.startswith("planar"):
        planes = [lzw_encode(bytes(rng.integers(0, 256, width * height, dtype=np.uint8))) for _ in range(3)]
        tags = {"planar_11": {530: (3, [1, 1])}, "planar_22": {530: (3, [2, 2])}, "planar_default": {}}[case]
        raw = tiff(planes, width, height, (8, 8, 8), 6, 5, planar=2, tags=tags)
    elif case == "one_sample":
        raw = tiff([lzw_encode(bytes(width * height))], width, height, (8,), 6, 5)
    elif case == "subsampling_31":
        raw = ycbcr_tiff(rng, width, height, (1, 1), 5, tags={530: (3, [3, 1])})
    elif case == "big_endian":
        raw = ycbcr_tiff(rng, width, height, (2, 1), 8, rps=4, endian=">")
    else:
        raw = ycbcr_tiff(rng, width, height, (2, 2), 5, tags={529: (5, [(299, 1000), (0, 1), (114, 1000)])})
    assert_same(raw)


@pytest.mark.parametrize("seed", range(24))
def test_fuzzed_ycbcr_files(seed):
    """Random subsampling, size, strips or tiles, codec and Orientation."""
    rng = np.random.default_rng(1000 + seed)
    factors = SUBSAMPLINGS[rng.integers(len(SUBSAMPLINGS))]
    width, height = int(rng.integers(1, 60)), int(rng.integers(1, 60))
    kw = {"tile": (16 * int(rng.integers(1, 3)), 16)} if rng.random() < 0.3 else {"rps": int(rng.integers(1, 70))}
    compression = [5, 8, 32773, 34925][rng.integers(4)]
    tags = {274: (3, [int(rng.integers(1, 9))])}
    assert_same(ycbcr_tiff(rng, width, height, factors, compression, tags=tags, **kw))


# -- what stays refused -------------------------------------------------------------------------------


@pytest.mark.parametrize("compression, name", [
    (6, "old-style JPEG"), (50000, "Zstandard"), (32771, "CCITT RLEW"), (32809, "ThunderScan"), (34676, "SGILog"),
    (34677, "SGILog24"), (50001, "WebP")])
def test_compressions_still_refused_by_name(compression, name):
    raw = tiff([bytes(48)], 4, 4, (8, 8, 8), 2, compression)
    with pytest.raises(UnsupportedImageFormat) as err:
        decode_image(raw)
    assert err.value.format == f"{name}-compressed TIFF (compression {compression})"


@pytest.mark.parametrize("factors", [None, (2, 2)])
def test_uncompressed_ycbcr_is_refused_by_name(factors):
    """Pillow's own reader unpacks it as RGBX (4 bytes from 3 samples)."""
    raw = tiff([bytes(range(200)) * 3], 10, 10, (8, 8, 8), 6, 1, tags={530: (3, list(factors))} if factors else None)
    with pytest.raises(UnsupportedImageFormat, match="uncompressed YCbCr TIFF"):
        decode_image(raw)
