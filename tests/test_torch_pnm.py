"""The port's PNM decoder (dsocr_tpu_torch/image/pnm.py over
native/pnm.cpp) bit-equal to Pillow's ``Image.open(...).convert("RGB")``:
every magic of Pillow's MODES, raw and plain, maxvals that scale (with
half-way rounding), comments and the 10-byte token limits in the header
and in plain data (also across the 1 MiB blocks Pillow reads plain data
in), Pf at both byte orders with NaN and infinities, truncated files,
bytes after the image, magics Pillow does not know and the bomb limit.
Where Pillow raises, the port raises ``ImageDecodeError``."""

import io
import time

import numpy as np
import pytest

from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image, image_format

Image = pytest.importorskip("PIL.Image")

BLOCK = 1 << 20  # ImageFile.SAFEBLOCK: what Pillow's plain decoder reads at a time


def pillow(raw: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    except Exception as err:  # noqa: BLE001 - any error Pillow raises
        return err


def assert_same(raw: bytes):
    """The port decodes `raw` as Pillow does, or raises where Pillow raises."""
    ref = pillow(raw)
    if isinstance(ref, BaseException):
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return ref
    out = decode_image(raw)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    return out


def plain_body(values, sep=" ") -> bytes:
    return sep.join(str(int(v)) for v in np.ravel(values)).encode()


# -- every magic, raw and plain ----------------------------------------------------------------------


@pytest.mark.parametrize("magic, bands", [(b"P5", 1), (b"P6", 3), (b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyP", 1),
                                          (b"PyRGBA", 4)])
@pytest.mark.parametrize("maxval", [255, 1, 2, 3, 256, 1000, 65534, 65535])
def test_raw_magics_at_every_maxval(magic, bands, maxval):
    rng = np.random.default_rng(maxval + bands)
    w, h = 7, 5
    wide = maxval > 255
    hi = maxval + 1 if magic != b"PyP" else 256
    values = rng.integers(0, 256 if not wide else 65536 if maxval == 65535 else maxval + 1, (h, w, bands))
    if not wide:
        values = np.minimum(values, 255 if maxval == 255 else max(hi, 255))
    data = values.astype(">u2" if wide else np.uint8).tobytes()
    assert_same(magic + b"\n%d %d\n%d\n" % (w, h, maxval) + data)


@pytest.mark.parametrize("magic, bands", [(b"P2", 1), (b"P3", 3)])
@pytest.mark.parametrize("maxval", [1, 2, 3, 255, 256, 1000, 65534, 65535])
def test_plain_magics_at_every_maxval(magic, bands, maxval):
    rng = np.random.default_rng(maxval * 3 + bands)
    w, h = 9, 4
    values = rng.integers(0, maxval + 1, (h, w, bands))
    assert_same(magic + b" %d %d %d\n" % (w, h, maxval) + plain_body(values, "\n"))


@pytest.mark.parametrize("width", [1, 7, 8, 9, 17])
def test_p4_rows_padded_to_a_byte_and_p1_without_separators(width):
    rng = np.random.default_rng(width)
    bits = rng.integers(0, 2, (6, width))
    packed = np.packbits(bits, axis=1).tobytes()
    assert_same(b"P4\n%d 6\n" % width + packed)
    assert_same(b"P1\n%d 6\n" % width + b"".join(b"".join(b"%d" % v for v in row) for row in bits))
    assert_same(b"P1\n%d 6\n" % width + plain_body(bits, " \t"))


@pytest.mark.parametrize("maxval", [2, 3, 5, 6, 10, 170, 254, 256, 510, 1000, 1022, 32768, 65534])
def test_half_way_rounding(maxval):
    """Every value at the maxval: round(v / maxval * out_max) rounds half to
    even in Python's float64 order; raw and plain, L and I."""
    values = np.arange(maxval + 1) if maxval <= 1100 else np.unique(
        np.concatenate([np.arange(0, maxval + 1, 7), np.arange(maxval - 300, maxval + 1)]))
    w = len(values)
    raw = values.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    assert_same(b"P5 %d 1 %d\n" % (w, maxval) + raw)
    assert_same(b"P2 %d 1 %d\n" % (w, maxval) + plain_body(values))
    rgb = np.stack([values, values[::-1], values], axis=1)
    assert_same(b"P6 %d 1 %d\n" % (w, maxval) + rgb.astype(">u2" if maxval > 255 else np.uint8).tobytes())


def test_sixteen_bit_grey_clips_in_convert():
    assert_same(b"P5 4 1 65535\n" + np.array([0, 200, 300, 65535], ">u2").tobytes())
    out = assert_same(b"P5 4 1 1000\n" + np.array([0, 2, 500, 1000], ">u2").tobytes())
    assert out[0, :, 0].tolist() == [0, 131, 255, 255]


def test_raw_samples_past_maxval_are_capped():
    assert_same(b"P5 4 1 1\n" + bytes([0, 1, 2, 200]))
    assert_same(b"P6 2 1 300\n" + np.array([0, 301, 65535, 12, 299, 300], ">u2").tobytes())


# -- Pf --------------------------------------------------------------------------------------------


FLOATS = [-1.0, 0.5, 100.7, 255.5, np.nan, np.inf, -np.inf, 1e30, -1e30, 254.99999, 0.99, 1.0, 3e9, -0.0, 2.0 ** 31]


@pytest.mark.parametrize("scale, order", [(b"-1.0", "<f4"), (b"1.0", ">f4"), (b"-0.25", "<f4"), (b"2e3", ">f4"),
                                          (b"-1_0", "<f4")])
def test_pf_both_byte_orders_bottom_to_top(scale, order):
    rng = np.random.default_rng(len(scale))
    values = np.concatenate([FLOATS, rng.uniform(-20, 280, 15)]).astype(np.float32).reshape(3, 10)
    out = assert_same(b"Pf\n10 3\n" + scale + b"\n" + values.astype(order).tobytes())
    assert out[2, 2, 0] == 100  # the first row stored is the bottom one


@pytest.mark.parametrize("scale", [b"0", b"-0.0", b"nan", b"inf", b"-inf", b"x"])
def test_pf_bad_scale_raises(scale):
    assert_same(b"Pf 1 1 " + scale + b"\n" + bytes(4))


# -- header: comments, tokens, sizes ------------------------------------------------------------------


@pytest.mark.parametrize("header", [
    b"P5\n# a comment\n3 2\n255\n", b"P5 #c\r3 2 255\n", b"P5 3#c\n 2 255\n", b"P5 3 2 2#c\n55\n",
    b"P5\t3\x0b2\x0c255\r", b"P5   3   2   255 ", b"P5 +3 02 0255\n", b"P5 3 2 2_5_5\n", b"P5 0000000003 2 255\n",
    b"P5 00000000003 2 255\n", b"P5 3 2 255#comment at the end", b"P5 3 2", b"P5 3", b"P5", b"P5 3 2 x\n",
    b"P5 3 2 0\n", b"P5 3 2 65536\n", b"P5 3 2 -1\n", b"P5 1_ 2 255\n", b"P5 3 2 255\x1c", b"P5 3 2 255#\n\x05",
    b"P6#\n3 2 255\n", b"P5\n#\n#\n3 #\n2 #\r\n255\n", b"P0CMYKX 3 2 255\n",
    b"P0CMYK3 2 255\n", b"P5 # a\n\t# b\r 3 2 255\n", b"P5 3#a\r#b\n#c2 255\n", b"P5 3 2 25#a\r\n5\n",
    b"P5 3 2 255 #no line end", b"P5 3 2 #\r\r#\n\n255\n", b"P5 #a#b\n3 2 255\n"])
def test_header_tokens_and_comments(header):
    assert_same(header + bytes(range(40)))


@pytest.mark.parametrize("kind", ["ends in the header", "comments between tokens", "comments inside a token"])
def test_a_million_header_comments_read_in_linear_time(kind):
    """Each comment runs to its CR or LF; finding that end must not search
    the rest of the data (a million comments were hours of CPU when it did)."""
    many = 1_000_000
    raw = {"ends in the header": b"P1\n" + b"#\n" * many,
           "comments between tokens": b"P1\n" + b"# c\n \t" * many + b"3 2\n1 0 1 0 1 0",
           "comments inside a token": b"P1\n3" + b"#\n" * many + b" 2\n1 0 1 0 1 0"}[kind]
    start = time.perf_counter()
    try:
        decode_image(raw)
    except ImageDecodeError:
        pass
    assert time.perf_counter() - start < 5.0
    assert_same(raw)


@pytest.mark.parametrize("magic", [b"P7 1 1 255\n", b"P0 1 1 255\n", b"P6#x 1 1 255\n", b"Pz 1 1 255\n",
                                   b"P612 1 1 255\n", b"PyRGB 1 1 255\n", b"PyCMY 1 1 255\n", b"P"])
def test_unknown_magic_is_unsupported(magic):
    raw = magic + bytes(8)
    assert isinstance(pillow(raw), Exception)
    with pytest.raises(UnsupportedImageFormat):
        decode_image(raw)


@pytest.mark.parametrize("size", [b"0 3", b"3 0", b"-3 2", b"2 -1"])
def test_empty_size_is_not_identified(size):
    raw = b"P5 " + size + b" 255\n" + bytes(10)
    assert isinstance(pillow(raw), Exception)
    with pytest.raises(UnsupportedImageFormat):
        decode_image(raw)


@pytest.mark.parametrize("magic", [b"P4", b"P5", b"P3", b"Pf"])
def test_decompression_bomb_raises_before_reading(magic):
    raw = magic + b" 13400 13400 " + (b"-1.0" if magic == b"Pf" else b"255") + b"\n" + bytes(64)
    assert isinstance(pillow(raw), Image.DecompressionBombError)
    with pytest.raises(ImageDecodeError, match="decompression-bomb"):
        decode_image(raw)


@pytest.mark.parametrize("magic", [b"P1", b"P3"])
def test_plain_data_too_short_for_its_size_raises_before_allocating(magic):
    """Under the bomb limit but with a few bytes of data: Pillow runs out
    of data; the port says so before it allocates the image's values."""
    import tracemalloc

    raw = magic + b" 13000 13000" + (b" 255" if magic == b"P3" else b"") + b"\n1 0 1"
    assert isinstance(pillow(raw), Exception)
    tracemalloc.start()
    try:
        with pytest.raises(ImageDecodeError, match="ends early"):
            decode_image(raw)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 2 ** 20


def test_image_format_names_pnm():
    for magic in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"Py", b"P0", b"P7"):
        assert image_format(magic + b" 1 1") == ("PNM" if magic != b"P7" else "unknown")


# -- data: truncation, trailing bytes, plain tokens ------------------------------------------------------


@pytest.mark.parametrize("raw", [
    b"P5 2 2 255\n\x01\x02\x03", b"P5 2 1 255", b"P6 1 1 1000\n\x00\x01\x00\x02\x00", b"P4 9 2\n\x00\x00\x00",
    b"Pf 2 1 -1\n" + bytes(7), b"P5 2 1 65535\n\x00\x01\x00", b"P2 2 1 255 1", b"P3 1 1 255 1 2", b"P1 3 2 0 1 0 1 1",
    b"P5 2 1 255\n\x01\x02 trailing bytes", b"P2 2 1 255 1 2 x y z", b"P1 2 1 01 1", b"P1 3 1 0 1 x",
    b"P1 2 1 01 # comment\n x", b"P2 2 1 255 1#x\n2 3", b"P2 2 1 255 -0 +3", b"P2 2 1 255 1_0 3", b"P2 2 1 255 1 256",
    b"P2 2 1 255 -1 3", b"P2 2 1 255 12345678901 3", b"P2 2 1 255 0000000001 3", b"P2 2 1 255 1__0 3",
    b"P2 2 1 255 _1 3", b"P2 2 1 255 1_ 3", b"P2 1 1 255 \x1c5", b"P2 1 1 255 \x0c5", b"P2 1 1 255 5#never ends",
    b"P2 2 1 255 1\r#c\n2", b"P2 2 1 255 1 #c\r\n2", b"P2 2 1 255 ++1 2", b"P2 2 1 255 1.0 2"])
def test_data_cases(raw):
    assert_same(raw)


def _big_plain(rng, magic, w, h, maxval, comment_every=None):
    bands = 3 if magic == b"P3" else 1
    values = rng.integers(0, maxval + 1, h * w * bands)
    words = [str(int(v)) for v in values]
    if comment_every:
        for i in range(0, len(words), comment_every):
            words[i] += "#" + "c" * int(rng.integers(0, 30)) + ("\n" if rng.random() < 0.5 else "\r")
    seps = rng.choice([" ", "\n", "  ", "\t"], len(words))
    return magic + b" %d %d %d\n" % (w, h, maxval) + "".join(a + b for a, b in zip(words, seps)).encode()


@pytest.mark.parametrize("seed", range(6))
def test_plain_data_across_blocks(seed):
    """Files of two or three 1 MiB blocks, comments placed at random (some
    cut by a block's end), tokens across block ends."""
    rng = np.random.default_rng(seed)
    raw = _big_plain(rng, [b"P2", b"P3"][seed % 2], 1201, [520, 180][seed % 2] + seed, [255, 1000, 7][seed % 3],
                     comment_every=[None, 2001, 307][seed % 3])
    assert len(raw) > BLOCK
    assert_same(raw)


@pytest.mark.parametrize("where", [-12, -11, -10, -6, -1, 0, 1, 5])
def test_long_token_at_a_block_end(where):
    """A token over 10 bytes cut by the first block's end raises, even
    past the last value needed; a short one carries over."""
    head = b"P2 1 1 255\n"
    pad = BLOCK + where - 3
    raw = head + b"7" + b" " * pad + b"123456789012345"
    assert_same(raw)
    assert_same(head + b"7" + b" " * (BLOCK - 8) + b"12345 6")


@pytest.mark.parametrize("where", [-3, -2, -1, 0, 1])
def test_comment_cut_by_a_block_end(where):
    head = b"P2 3 1 255\n"
    body = b"1 " + b" " * (BLOCK + where - 6) + b"#comment\r\n2 3"
    assert_same(head + body)
    assert_same(head + b"1 " + b" " * (BLOCK - 4) + b"\n#x\r" + b"2\n3")
    assert_same(head + b"1 2" + b" " * (BLOCK - 3) + b"\r#c\n3")


def test_p1_bad_byte_past_the_last_needed_one_raises():
    raw = b"P1 2 1\n01 x"
    assert isinstance(pillow(raw), ValueError)
    with pytest.raises(ImageDecodeError):
        decode_image(raw)
    assert_same(b"P1 2 1\n01" + b" " * BLOCK + b"x")  # in the next block: never read


@pytest.mark.parametrize("magic", [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"])
def test_full_width_page_rows(magic):
    rng = np.random.default_rng(len(magic))
    w, h = 333, 21
    if magic in (b"P1", b"P4"):
        bits = rng.integers(0, 2, (h, w))
        body = np.packbits(bits, axis=1).tobytes() if magic == b"P4" else plain_body(bits, "")
        assert_same(magic + b"\n%d %d\n" % (w, h) + body)
        return
    bands = 3 if magic in (b"P3", b"P6") else 1
    px = rng.integers(0, 256, (h, w, bands))
    body = px.astype(np.uint8).tobytes() if magic in (b"P5", b"P6") else plain_body(px, "\n")
    out = assert_same(magic + b"\n%d %d\n255\n" % (w, h) + body)
    np.testing.assert_array_equal(out, np.broadcast_to(px, (h, w, 3)) if bands == 1 else px)
