"""Zstandard TIFF (compression 50000), image/tiff.py over native/zstd.cpp,
bit-equal to Pillow 12.1 over libtiff 4.7 (tif_zstd.c over libzstd), or
raising ``ImageDecodeError`` where Pillow raises:

- files Pillow writes (its libtiff's default level), with and without
  Predictor 2, Predictor 3 on floats, 8-, 16- and 32-bit samples;
- strips and tiles written here with the ``zstandard`` package (a test-only
  import; the port reads none of it) at levels -5 to 22, with predictors;
- frames Pillow's writer does not make, each checked to hold what it is
  meant to (``frame_features`` parses them): content checksums, raw and RLE
  blocks, RLE literals, 1- and 4-stream and treeless Huffman literals, RLE,
  coded and repeated FSE tables, long windows; and how libtiff's one call
  of ZSTD_decompressStream a strip treats a skippable frame, two frames, a
  frame longer or shorter than its strip, truncation, a bad checksum, a
  dictionary ID and a window over libzstd's limit, also where the RGBA
  reader keeps a damaged YCbCr strip's first blocks; damaged frames that
  libzstd's lenient fast Huffman path reads;
- random bytes round-tripped through ``zstandard`` (hypothesis).
"""

import functools
import io
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from dsocr_tpu_torch.image.decode import ImageDecodeError, decode_image
from dsocr_tpu_torch.image.tiff import _unzstd
from tests.test_torch_tiff_jpeg import tiff

try:
    import zstandard as zstd
except ImportError:  # only the cases that write frames with it skip; Pillow's own files still run
    zstd = None

needs_zstandard = pytest.mark.skipif(zstd is None, reason="the zstandard package writes this case's frames")


def pillow_rgb(raw: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    except Exception as err:  # noqa: BLE001 - Pillow's refusals are OSError, ValueError, ...
        return err


def assert_same(raw: bytes):
    want = pillow_rgb(raw)
    if isinstance(want, BaseException):
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return want
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def unzstd(frame: bytes, size: int) -> bytes:
    """The port's strip decode of `frame` into `size` bytes (it must succeed)."""
    out = np.zeros(size, np.uint8)
    status, written = _unzstd(frame, out)
    assert status == 0 and written == size
    return out.tobytes()


def frame_features(frames: bytes) -> set:
    """What a run of frames holds: block types, literal and sequence
    table modes, checksums, window logs, skippable frames."""
    feats, pos = set(), 0
    while pos < len(frames):
        magic = struct.unpack_from("<I", frames, pos)[0]
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            feats.add("skippable")
            pos += 8 + struct.unpack_from("<I", frames, pos + 4)[0]
            continue
        fhd = frames[pos + 4]
        single = (fhd >> 5) & 1
        if fhd & 4:
            feats.add("checksum")
        if not single:
            feats.add(f"window_log_{10 + (frames[pos + 5] >> 3)}")
        q = pos + 5 + (1 - single) + [0, 1, 2, 4][fhd & 3] + [single, 2, 4, 8][fhd >> 6]
        while True:
            bh = int.from_bytes(frames[q:q + 3], "little")
            last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
            q += 3
            feats.add(["raw_block", "rle_block", "compressed_block"][kind])
            if kind == 2:
                b = frames[q:q + size]
                lt, fmt = b[0] & 3, (b[0] >> 2) & 3
                if lt < 2:
                    feats.add(["raw_literals", "rle_literals"][lt])
                    head = {0: 1, 2: 1, 1: 2, 3: 3}[fmt]
                    regen = int.from_bytes(b[:head], "little") >> (3 if head == 1 else 4)
                    p = head + (regen if lt == 0 else 1)
                else:
                    head, bits = [3, 3, 4, 5][fmt], [10, 10, 14, 18][fmt]
                    comp = (int.from_bytes(b[:head], "little") >> (4 + bits)) & ((1 << bits) - 1)
                    feats.add(("huffman" if lt == 2 else "treeless") + ("_1stream" if fmt == 0 else "_4streams"))
                    p = head + comp
                n = b[p]
                if n:
                    p += 1 + (2 if n == 255 else 1 if n >= 128 else 0)
                    for mode in (b[p] >> 6, (b[p] >> 4) & 3, (b[p] >> 2) & 3):
                        feats.add(f"fse_{['predefined', 'rle', 'compressed', 'repeat'][mode]}")
            q += 1 if kind == 1 else size
            if last:
                break
        pos = q + (4 if fhd & 4 else 0)
    return feats


def differenced(samples: np.ndarray, depth: int) -> np.ndarray:
    """Predictor 2 on [rows, cols, spp] integer samples."""
    diff = np.diff(samples.astype(np.int64), axis=1, prepend=0)
    diff[:, 0] = samples[:, 0]
    return (diff % (1 << depth)).astype(samples.dtype)


def float_differenced(samples: np.ndarray) -> np.ndarray:
    """Predictor 3 (libtiff's fpDiff) on [rows, cols, 1] float32 samples,
    little-endian file: byte planes (most significant first), then byte
    differences along each row."""
    rows, cols = samples.shape[:2]
    planes = samples.astype("<f4").view(np.uint8).reshape(rows, cols, 4)[..., ::-1]
    flat = planes.transpose(0, 2, 1).reshape(rows, cols * 4).astype(np.int16)
    return (np.diff(flat, axis=1, prepend=0) % 256).astype(np.uint8)


def zstd_tiff(samples: np.ndarray, bits, photometric: int, *, level: int = 3, rps=None, tile=None, predictor=1,
              sample_format=None, frame=None) -> bytes:
    """[H, W, spp] samples → a little-endian Zstandard TIFF whose strips or
    tiles are compressed with `zstandard` at `level` (or by `frame`)."""
    h, w, spp = samples.shape
    depth = bits[0]
    encode = frame or zstd.ZstdCompressor(level=level).compress

    def pack(part):
        if predictor == 3:
            return float_differenced(part).tobytes()
        if predictor == 2:
            part = differenced(part, depth)
        return part.astype({8: np.uint8, 16: "<u2", 32: "<u4"}[depth]).tobytes()

    blocks = []
    if tile:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                part = np.zeros((th, tw, spp), samples.dtype)
                src = samples[y:y + th, x:x + tw]
                part[:src.shape[0], :src.shape[1]] = src
                blocks.append(encode(pack(part)))
    else:
        step = rps or h
        blocks = [encode(pack(samples[y:y + step])) for y in range(0, h, step)]
    tags = {317: (3, [predictor])} if predictor != 1 else {}
    if sample_format:
        tags[339] = (3, [sample_format] * spp)
    return tiff(blocks, w, h, bits, photometric, 50000, tile=tile, rps=rps, tags=tags)


def page(rng, h, w, spp=3):
    """Smooth rows with noise: compressible, as scanned pages are."""
    base = np.cumsum(rng.integers(-3, 4, (h, w, spp)), axis=1) + rng.integers(0, 256, (h, 1, spp))
    return (base % 256).astype(np.uint8)


# -- Pillow's own files --------------------------------------------------------------------------------


@pytest.mark.parametrize("mode, predictor", [("RGB", 1), ("RGB", 2), ("L", 1), ("L", 2), ("RGBA", 2), ("CMYK", 2),
                                             ("I;16", 2), ("I", 2), ("F", 2), ("F", 3), ("1", 1), ("P", 1)])
@pytest.mark.parametrize("size", [(45, 29), (300, 211)])
def test_pillow_written_zstd_tiff(mode, predictor, size):
    rng = np.random.default_rng(len(mode) * 7 + predictor)
    w, h = size
    if mode in ("I;16", "I", "F"):
        values = {"I;16": lambda: rng.integers(0, 400, (h, w)).astype(np.uint16),
                  "I": lambda: rng.integers(-50, 300, (h, w)).astype(np.int32),
                  "F": lambda: rng.normal(120, 90, (h, w)).astype(np.float32)}[mode]()
        img = Image.fromarray(values) if mode != "I;16" else Image.frombytes("I;16", (w, h), values.tobytes())
    elif mode == "1":
        img = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    elif mode == "P":
        img = Image.fromarray(page(rng, h, w)).convert("P")
    else:
        img = Image.fromarray(page(rng, h, w, {"RGB": 3, "L": 1, "RGBA": 4, "CMYK": 4}[mode]).squeeze(), mode)
    buf = io.BytesIO()
    img.save(buf, format="TIFF", compression="zstd", tiffinfo={317: predictor} if predictor != 1 else {})
    raw = buf.getvalue()
    reopened = Image.open(io.BytesIO(raw))
    assert reopened.tag_v2[259] == 50000 and reopened.tag_v2.get(317, 1) == predictor
    assert_same(raw)


# -- strips and tiles written here ---------------------------------------------------------------------


@needs_zstandard
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
@pytest.mark.parametrize("layout", [{"rps": 7}, {"rps": None}, {"tile": (32, 16)}])
def test_levels_strips_and_tiles(level, layout):
    rng = np.random.default_rng(level + 40)
    samples = page(rng, 37, 70)
    assert_same(zstd_tiff(samples, (8, 8, 8), 2, level=level, **layout))


@needs_zstandard
@pytest.mark.parametrize("depth, photometric, spp, fmt, predictor", [
    (8, 2, 3, None, 2), (8, 1, 1, None, 2), (16, 1, 1, None, 1), (16, 1, 1, None, 2), (16, 2, 3, None, 2),
    (32, 1, 1, 1, 1), (32, 1, 1, 2, 2), (32, 1, 1, 3, 1), (32, 1, 1, 3, 3)])
@pytest.mark.parametrize("layout", [{"rps": 5}, {"tile": (16, 16)}])
def test_sample_depths_and_predictors(depth, photometric, spp, fmt, predictor, layout):
    rng = np.random.default_rng(depth * 11 + spp + predictor)
    h, w = 23, 41
    if fmt == 3:
        samples = rng.normal(100, 90, (h, w, spp)).astype(np.float32)
    elif depth == 32:
        samples = rng.integers(-100, 400, (h, w, spp)).astype(np.int32 if fmt == 2 else np.uint32)
    else:
        samples = rng.integers(0, 1 << depth, (h, w, spp)).astype(np.uint16 if depth == 16 else np.uint8)
    raw = zstd_tiff(samples, (depth,) * spp, photometric, predictor=predictor, sample_format=fmt, **layout)
    assert_same(raw)


# -- frames Pillow's writer does not make -----------------------------------------------------------------


def _text(rng, n):
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), dtype=np.uint8)) for _ in range(300)]
    return b" ".join(words[i] for i in rng.zipf(1.3, n) % 300)


def rle_literals_frame(data_len: int, byte: int) -> bytes:
    """A hand-made frame of one compressed block: RLE literals, no sequences."""
    lit = bytes([1 | (1 << 2) | ((data_len & 15) << 4), data_len >> 4, byte, 0])
    block = struct.pack("<I", 1 | (2 << 1) | (len(lit) << 3))[:3] + lit
    return struct.pack("<I", 0xFD2FB528) + bytes([0x20, data_len]) + block


CORPUS = {
    "text": lambda rng: _text(np.random.default_rng(0), 150000),
    "runs": lambda rng: b"".join(bytes([int(v)]) * int(n) for v, n in zip(rng.integers(0, 4, 3000),
                                                                          rng.integers(1, 30, 3000))),
    "zeros": lambda rng: bytes(300000),
    "noise": lambda rng: rng.integers(0, 256, 200000, dtype=np.uint8).tobytes(),
    "aaab": lambda rng: (b"a" * 20 + b"b" * 5) * 40 + b"c" * 10,
    "period": lambda rng: bytes(rng.integers(0, 256, 64, dtype=np.uint8)) * 50,
    "small": lambda rng: b"the quick brown fox jumps over the lazy dog. " * 3,
}


@needs_zstandard
@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_frames_decode_as_libzstd_does(name, level, checksum):
    data = CORPUS[name](np.random.default_rng(len(name)))
    frame = zstd.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert unzstd(frame, len(data)) == data


@needs_zstandard
def test_frames_cover_every_part_of_the_format():
    feats = set()
    for name, make in CORPUS.items():
        data = make(np.random.default_rng(len(name)))
        for level in (-5, 1, 3, 9, 19):
            feats |= frame_features(zstd.ZstdCompressor(level=level, write_checksum=True).compress(data))
    feats |= frame_features(rle_literals_frame(100, 7))
    assert {"raw_block", "rle_block", "compressed_block", "raw_literals", "rle_literals", "huffman_1stream",
            "huffman_4streams", "treeless_1stream", "treeless_4streams", "fse_predefined", "fse_rle",
            "fse_compressed", "fse_repeat", "checksum"} <= feats
    assert unzstd(rle_literals_frame(100, 7), 100) == bytes([7]) * 100


def test_rle_literals_strip_through_the_tiff_reader():
    frame = rle_literals_frame(90, 200)
    assert_same(tiff([frame], 30, 1, (8, 8, 8), 2, 50000))


@needs_zstandard
@pytest.mark.parametrize("window_log", [20, 22, 24])
def test_long_windows(window_log):
    """A match as far back as the window allows (long-distance matching)."""
    rng = np.random.default_rng(window_log)
    part = rng.integers(0, 256, (1 << (window_log - 1)) // 2 + 1000, dtype=np.uint8).tobytes()
    data = part + part
    params = zstd.ZstdCompressionParameters.from_level(3, window_log=window_log, enable_ldm=True,
                                                       write_content_size=False)
    frame = zstd.ZstdCompressor(compression_params=params).compress(data)
    assert f"window_log_{window_log}" in frame_features(frame) and len(frame) < len(data) * 0.6
    assert unzstd(frame, len(data)) == data


# -- libtiff's one ZSTD_decompressStream loop a strip ----------------------------------------------------


def _with_dictionary_id(frame: bytes, dict_id: int) -> bytes:
    fhd = frame[4]
    head = 6 if not (fhd >> 5) & 1 else 5  # the window descriptor stays in front of the ID
    return frame[:4] + bytes([fhd | 3]) + frame[5:head] + struct.pack("<I", dict_id) + frame[head:]


STRIP_CASE_NAMES = ("whole", "skippable first", "two frames", "frame longer than the strip", "frame longer, no size",
                    "frame shorter than the strip", "truncated", "truncated raw block", "truncated in the checksum",
                    "truncated, no size", "bad checksum", "dictionary id", "dictionary id 0",
                    "window over the limit", "trailing bytes", "not a frame", "empty", "reserved bit")


@functools.lru_cache(maxsize=None)
def strip_cases():
    """Each of STRIP_CASE_NAMES → a strip's bytes (made with zstandard once)."""
    rng = np.random.default_rng(3)
    px = page(rng, 20, 30)
    data = px.tobytes()
    noise = rng.integers(0, 256, len(data), dtype=np.uint8).tobytes()
    c = zstd.ZstdCompressor(level=3, write_checksum=True).compress(data)
    raw_block = zstd.ZstdCompressor(level=3, write_checksum=True).compress(noise)
    no_size = zstd.ZstdCompressor(level=3, write_content_size=False, write_checksum=True).compress(data)
    big_window = zstd.ZstdCompressor(compression_params=zstd.ZstdCompressionParameters.from_level(
        3, window_log=28, write_content_size=False)).compress(data)
    return {
        "whole": c,
        "skippable first": b"\x50\x2a\x4d\x18" + struct.pack("<I", 3) + b"abc" + c,
        "two frames": zstd.ZstdCompressor().compress(data[:900]) + zstd.ZstdCompressor().compress(data[900:]),
        "frame longer than the strip": zstd.ZstdCompressor().compress(data + b"x" * 5000),
        "frame longer, no size": zstd.ZstdCompressor(write_content_size=False).compress(data + b"x" * 5000),
        "frame shorter than the strip": zstd.ZstdCompressor().compress(data[:-10]),
        "truncated": c[:-20],
        "truncated raw block": raw_block[:-20],
        "truncated in the checksum": c[:-2],
        "truncated, no size": no_size[:-9],
        "bad checksum": c[:-1] + bytes([c[-1] ^ 1]),
        "dictionary id": _with_dictionary_id(c, 1234),
        "dictionary id 0": _with_dictionary_id(c, 0),
        "window over the limit": big_window,
        "trailing bytes": c + b"junkjunk",
        "not a frame": b"hello world",
        "empty": b"",
        "reserved bit": c[:4] + bytes([c[4] | 8]) + c[5:],
    }


@needs_zstandard
@pytest.mark.parametrize("case", sorted(STRIP_CASE_NAMES))
def test_strip_edge_cases_against_pillow(case):
    assert sorted(strip_cases()) == sorted(STRIP_CASE_NAMES)
    assert_same(tiff([strip_cases()[case] or b"\0"], 30, 20, (8, 8, 8), 2, 50000))


@needs_zstandard
@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("damage", ["flip", "cut"])
def test_damaged_ycbcr_strip_keeps_what_libzstd_flushed(content_size, damage):
    """YCbCr goes through libtiff's RGBA reader, which reads on past a strip
    that fails: the blocks libzstd flushed stay, the rest is zeros (the
    single-pass shortcut of a frame with a content size flushes none)."""
    rng = np.random.default_rng(5)
    w, h, rps = 256, 420, 210  # 161,280-byte strips: two blocks a frame
    units = page(rng, h, w)
    comp = zstd.ZstdCompressor(level=3, write_content_size=content_size)
    strips = [comp.compress(units[y:y + rps].tobytes()) for y in range(0, h, rps)]
    bad = bytearray(strips[0])
    if damage == "flip":
        bad[len(bad) - 40] ^= 0x5A
    else:
        del bad[len(bad) * 3 // 4:]
    raw = tiff([bytes(bad), strips[1]], w, h, (8, 8, 8), 6, 50000, rps=rps, tags={530: (3, [1, 1])})
    assert_same(raw)


def damaged_frame(seed: int):
    """A frame of one of four kinds of data, at a random level, checksum and
    content size, then bytes flipped or cut → (frame, the data's size)."""
    rng = np.random.default_rng(seed)
    size = int(rng.integers(0, 300000)) if rng.random() < 0.5 else int(rng.integers(0, 3000))
    kind = int(rng.integers(0, 4))
    if kind == 0:
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    elif kind == 1:
        data = (np.cumsum(rng.integers(-3, 4, size)) % 256).astype(np.uint8).tobytes()
    elif kind == 2:
        data = rng.integers(0, 4, size, dtype=np.uint8).tobytes()
    else:
        data = (bytes(rng.integers(0, 256, 97, dtype=np.uint8)) * (size // 97 + 1))[:size]
    frame = bytearray(zstd.ZstdCompressor(level=int(rng.integers(-5, 20)), write_checksum=bool(rng.random() < 0.5),
                                          write_content_size=bool(rng.random() < 0.7)).compress(data))
    if rng.random() < 0.5 and len(frame) > 6:
        for _ in range(int(rng.integers(1, 4))):
            frame[int(rng.integers(4, len(frame)))] ^= int(rng.integers(1, 256))
    else:
        del frame[int(len(frame) * rng.uniform(0.2, 1)):]
    return bytes(frame), size


# damaged frames whose reading depends on what libzstd 1.5 does with them:
# its lenient fast 4-stream Huffman path (236, 267), checksum failures
# (20, 78), corruption after some blocks (244, 254), truncation (14, 16)
@needs_zstandard
@pytest.mark.parametrize("seed", [14, 16, 20, 78, 236, 244, 254, 267, 417, 435, 687])
@pytest.mark.parametrize("photometric", [1, 6])
def test_damaged_frames_read_as_libtiff_reads_them(seed, photometric):
    """Through Pillow's own reader (grey: the strip fails or not) and its
    RGBA reader (YCbCr: a failed strip keeps what ZSTD_decompressStream
    reported, zeros after an error)."""
    frame, size = damaged_frame(seed)
    if photometric == 1:
        assert_same(tiff([frame], max(size, 1), 1, (8,), 1, 50000))
    else:
        assert_same(tiff([frame], max(size // 3, 1), 1, (8, 8, 8), 6, 50000, tags={530: (3, [1, 1])}))


@needs_zstandard
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.binary(min_size=0, max_size=5000), level=st.integers(-7, 19), checksum=st.booleans(),
       repeat=st.integers(1, 40))
def test_random_bytes_round_trip(data, level, checksum, repeat):
    data = data * repeat
    frame = zstd.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    out = np.zeros(len(data) + 1, np.uint8)  # one byte more than the frame holds: it must end short
    status, written = _unzstd(frame, out)
    assert status == 0 and written == len(data) and out[:written].tobytes() == data
