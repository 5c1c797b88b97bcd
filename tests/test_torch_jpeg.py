"""The port's JPEG decoder (dsocr_tpu_torch/image/decode.py over
native/jpeg.cpp) against the reference's decoding, Pillow's
``Image.open(...).convert("RGB")``, bit for bit: Pillow-written files
across modes, subsampling, baseline and progressive, optimized tables,
quality 1 to 100 and 16-bit quantization tables up to 32,767, restart
markers and small and odd sizes; header patches (YCCK, RGB by component
ids, no Huffman tables); files from a small NumPy baseline encoder below
for the sampling factors and scan layouts Pillow does not write, and for
coefficients past an 8-bit encoder's range (the IDCT's 16-bit lanes);
the variants refused by name; truncated and damaged files and what may
follow the scans; the page fixtures against their digests."""

import hashlib
import io
import json
import pathlib
import threading

import numpy as np
import pytest

from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image

Image = pytest.importorskip("PIL.Image")

DATA = pathlib.Path(__file__).resolve().parent / "data"


def sample_image(width, height, seed=0, channels=3):
    """Gradients, saturated patches and noise: every IDCT and upsampling
    edge, and colors that clamp."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    img = np.stack([(xx * 255 // max(width - 1, 1)), (yy * 255 // max(height - 1, 1)),
                    ((xx + yy) * 7) % 256, (xx * yy) % 256][:channels], axis=-1).astype(np.int32)
    img += rng.integers(-40, 41, img.shape)
    for _ in range(3):
        y0, x0 = rng.integers(0, height), rng.integers(0, width)
        img[y0:y0 + height // 3 + 1, x0:x0 + width // 3 + 1] = rng.choice([0, 255], channels)
    return np.clip(img, 0, 255).astype(np.uint8)



def pillow_jpeg(img, mode="RGB", **options) -> bytes:
    buf = io.BytesIO()
    if mode == "CMYK":
        pil = Image.frombytes("CMYK", (img.shape[1], img.shape[0]), img.tobytes())
    else:
        pil = Image.fromarray(img[:, :, 0] if mode == "L" else img)
    pil.save(buf, format="JPEG", **options)
    return buf.getvalue()


def pillow_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def assert_same(raw: bytes):
    want = pillow_rgb(raw)
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    if not np.array_equal(got, want):
        diff = np.argwhere(got != want)
        raise AssertionError(f"{len(diff)} samples differ, first at {diff[0].tolist()}: "
                             f"{got[tuple(diff[0])]} vs Pillow's {want[tuple(diff[0])]}")


def segments(raw: bytes):
    """(code, offset of FF, offset after the segment) of each marker up to
    the first SOS."""
    pos, out = 2, []
    while True:
        code = raw[pos + 1]
        end = pos + 2 + int.from_bytes(raw[pos + 2:pos + 4], "big")
        out.append((code, pos, end))
        if code == 0xDA:
            return out
        pos = end


# -- Pillow-written files --------------------------------------------------------------------

SIZES = [(1, 1), (2, 2), (4, 5), (7, 9), (17, 33), (64, 48), (301, 199)]


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_sizes_and_subsampling(size, subsampling, progressive):
    assert_same(pillow_jpeg(sample_image(*size), quality=90, subsampling=subsampling, progressive=progressive))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_quality(quality, subsampling, progressive):
    assert_same(pillow_jpeg(sample_image(64, 48, seed=quality), quality=quality, subsampling=subsampling,
                            progressive=progressive))


QTABLES = {"coarse": [[300 + 40 * i for i in range(64)], [500 + 50 * i for i in range(64)]],
           "max": [[800] + [32767] * 63, [32767] * 64],
           "mixed": [[1 + (i * 997) % 4000 for i in range(64)], [2 + (i * 331) % 9000 for i in range(64)]]}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("tables", sorted(QTABLES))
def test_16_bit_quantization_tables(tables, progressive):
    raw = pillow_jpeg(sample_image(64, 48, seed=5), qtables=QTABLES[tables], progressive=progressive)
    dqt = [s for s in segments(raw) if s[0] == 0xDB]
    assert all(raw[at + 4] >> 4 == 1 for _, at, _ in dqt)  # 16-bit precision
    assert_same(raw)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode, options", [("L", {}), ("CMYK", {}), ("RGB", {"keep_rgb": True})],
                         ids=["L", "CMYK", "keep_rgb"])
@pytest.mark.parametrize("size", [(17, 33), (301, 199)], ids=["17x33", "301x199"])
def test_modes(size, mode, options, progressive):
    img = sample_image(*size, channels=4 if mode == "CMYK" else 3)
    assert_same(pillow_jpeg(img, mode, quality=95, progressive=progressive, **options))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_optimized_tables(subsampling, progressive):
    assert_same(pillow_jpeg(sample_image(301, 199, seed=3), quality=80, subsampling=subsampling,
                            progressive=progressive, optimize=True))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1}, {"restart_marker_rows": 3}],
                         ids=["blocks1", "blocks5", "rows1", "rows3"])
def test_restart_markers(restart, subsampling, progressive):
    # quality 95: Pillow sizes its progressive buffer by quality and cannot write this noise below it
    raw = pillow_jpeg(sample_image(301, 199, seed=4), quality=95, subsampling=subsampling, progressive=progressive,
                      **restart)
    assert any(code == 0xDD for code, _, _ in segments(raw))
    assert_same(raw)


def test_the_page_fixtures_match_their_digests():
    meta = json.loads((DATA / "jpeg_pages.json").read_text())
    assert set(meta["files"]) == {"page_baseline.jpg", "page_progressive.jpg"}
    for name, entry in meta["files"].items():
        raw = (DATA / name).read_bytes()
        assert len(raw) == entry["bytes"]
        got = decode_image(raw)
        assert list(got.shape) == entry["shape"] == [1756, 2852, 3]
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], name
    assert sum(meta["files"][n]["bytes"] for n in meta["files"]) < 1.5e6


def test_threads_decode_alike():
    raws = [pillow_jpeg(sample_image(301, 199, seed=s), quality=90, progressive=s % 2 == 1) for s in range(4)]
    want = [decode_image(r) for r in raws]
    got = [None] * 8

    def run(i):
        got[i] = decode_image(raws[i % 4])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert all(np.array_equal(got[i], want[i % 4]) for i in range(8))


# -- header patches -----------------------------------------------------------------------------


def patch_adobe_transform(raw: bytes, transform: int) -> bytes:
    (_, at, _), = [s for s in segments(raw) if s[0] == 0xEE]
    assert raw[at + 4:at + 9] == b"Adobe"
    return raw[:at + 15] + bytes([transform]) + raw[at + 16:]


@pytest.mark.parametrize("transform", [1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_ycck(transform, progressive):
    raw = pillow_jpeg(sample_image(61, 43, channels=4), "CMYK", quality=90, progressive=progressive)
    assert_same(patch_adobe_transform(raw, transform))


@pytest.mark.parametrize("ids, drop_app0", [(b"RGB", True), (b"RGB", False), (b"\x01\x02\x03", True),
                                            (b"abc", True)], ids=["RGB", "RGB_with_JFIF", "123", "abc"])
def test_color_space_from_component_ids(ids, drop_app0):
    raw = bytearray(pillow_jpeg(sample_image(61, 43), quality=90, subsampling=0))
    for code, at, end in segments(bytes(raw)):
        if code == 0xC0:
            for i in range(3):
                raw[at + 10 + 3 * i] = ids[i]
        if code == 0xDA:
            for i in range(3):
                raw[at + 5 + 2 * i] = ids[i]
    if drop_app0:
        (_, at, end), = [s for s in segments(bytes(raw)) if s[0] == 0xE0]
        raw = raw[:at] + raw[end:]
    assert_same(bytes(raw))


def test_keep_rgb_with_adobe_transform_1_reads_as_ycbcr():
    raw = pillow_jpeg(sample_image(61, 43), quality=90, keep_rgb=True)
    assert_same(patch_adobe_transform(raw, 1))


@pytest.mark.parametrize("progressive", [False, True])
def test_missing_huffman_tables_take_the_standard_ones_in_sequential_files(progressive):
    raw = pillow_jpeg(sample_image(61, 43), quality=90, progressive=progressive)
    if progressive:  # libjpeg's progressive decoder has no standard tables: the first scan's are missing
        (_, at, end), = [s for s in segments(raw) if s[0] == 0xC4][:1]
        with pytest.raises(OSError):
            pillow_rgb(raw[:at] + raw[end:])
        with pytest.raises(ImageDecodeError, match="DC Huffman table 0 is not defined"):
            decode_image(raw[:at] + raw[end:])
        return
    dht = [s for s in segments(raw) if s[0] == 0xC4]
    assert dht
    for _, at, end in reversed(dht):
        raw = raw[:at] + raw[end:]
    assert_same(raw)


# -- a small baseline encoder for what Pillow does not write --------------------------------------

_C = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
               for u in range(8)])
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,
            7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
            39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# flat canonical codes: 12 DC symbols in 4 bits, the 162 AC symbols in 8
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, bits):
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v):
    return int(abs(v)).bit_length()


def _bits(v, s):
    return v if v >= 0 else v + (1 << s) - 1


def encode_baseline(planes, factors, width, height, *, ids=None, scans=None, restart=0, quality_scale=1,
                    coefficients=None):
    """Sample planes (each already at its component's downsampled size)
    with (h, v) factors → a baseline JPEG. `scans`: lists of component
    indices (default: one interleaved scan); `restart`: MCUs an interval;
    `coefficients`: quantized blocks (rows, columns, 64 in natural order)
    per component, written in place of the planes' own."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    scans = scans or [list(range(n))]
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    quant = np.clip(np.round((8 + np.arange(64) * 0.8) * quality_scale), 1, 255).astype(int)  # natural order
    coefs = []
    for plane, (h, v) in zip(planes, factors):
        gh, gw = mcus_y * v * 8, mcus_x * h * 8
        padded = np.pad(plane.astype(np.float64), ((0, gh - plane.shape[0]), (0, gw - plane.shape[1])), mode="edge")
        blocks = padded.reshape(gh // 8, 8, gw // 8, 8).transpose(0, 2, 1, 3) - 128
        f = np.einsum("ux,abxy,vy->abuv", _C, blocks, _C).reshape(gh // 8, gw // 8, 64)
        coefs.append(np.round(f / quant).astype(int))
    if coefficients is not None:
        coefs = coefficients
    dc_code = {s: i for i, s in enumerate(_DC_SYMBOLS)}
    ac_code = {s: i for i, s in enumerate(_AC_SYMBOLS)}

    def block(w, b, pred):
        diff = int(b[0]) - pred
        s = _category(diff)
        w.put(dc_code[s], 4)
        w.put(_bits(diff, s), s)
        run = 0
        for k in range(1, 64):
            c = int(b[_NATURAL[k]])
            if c == 0:
                run += 1
                continue
            while run > 15:
                w.put(ac_code[0xF0], 8)
                run -= 16
            s = _category(c)
            w.put(ac_code[(run << 4) | s], 8)
            w.put(_bits(c, s), s)
            run = 0
        if run:
            w.put(ac_code[0x00], 8)
        return int(b[0])

    def segment(code, body):
        return bytes([0xFF, code]) + (len(body) + 2).to_bytes(2, "big") + body

    out = b"\xff\xd8" + segment(0xDB, bytes([0]) + bytes(int(quant[p]) for p in _NATURAL))
    out += segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([n])
                   + b"".join(bytes([ids[i], (factors[i][0] << 4) | factors[i][1], 0]) for i in range(n)))
    dc_counts = [0] * 16
    dc_counts[3] = len(_DC_SYMBOLS)
    ac_counts = [0] * 16
    ac_counts[7] = len(_AC_SYMBOLS)
    out += segment(0xC4, bytes([0x00] + dc_counts + _DC_SYMBOLS) + bytes([0x10] + ac_counts + _AC_SYMBOLS))
    if restart:
        out += segment(0xDD, restart.to_bytes(2, "big"))
    for comps in scans:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], 0]) for c in comps) + bytes([0, 63, 0]))
        if len(comps) == 1:
            c = comps[0]
            h, v = factors[c]
            nby, nbx = -(-(-(-height * v // vmax)) // 8), -(-(-(-width * h // hmax)) // 8)
            units = [[(c, by, bx)] for by in range(nby) for bx in range(nbx)]
        else:
            units = [[(c, my * factors[c][1] + y, mx * factors[c][0] + x) for c in comps
                      for y in range(factors[c][1]) for x in range(factors[c][0])]
                     for my in range(mcus_y) for mx in range(mcus_x)]
        w, preds = BitWriter(), {c: 0 for c in comps}
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                w.flush()
                w.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                preds = {c: 0 for c in comps}
            for c, by, bx in unit:
                preds[c] = block(w, coefs[c][by, bx], preds[c])
        w.flush()
        out += bytes(w.out)
    return out + b"\xff\xd9"


def planes_for(img, factors):
    """Each channel sampled down to its component's size."""
    height, width = img.shape[:2]
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    planes = []
    for c, (h, v) in enumerate(factors):
        dw, dh = -(-width * h // hmax), -(-height * v // vmax)
        rows = np.minimum(np.arange(dh) * vmax // v, height - 1)
        cols = np.minimum(np.arange(dw) * hmax // h, width - 1)
        planes.append(np.ascontiguousarray(img[rows][:, cols, c]))
    return planes


FACTORS = {
    "h1v2": [(1, 2), (1, 1), (1, 1)],
    "h4v1": [(4, 1), (1, 1), (1, 1)],
    "h3v1": [(3, 1), (1, 1), (1, 1)],
    "h3v2": [(3, 2), (1, 1), (1, 1)],
    "mixed_h2v1_h1v2": [(2, 2), (1, 2), (2, 1)],
    "mixed_h2v1_box": [(4, 1), (2, 1), (1, 1)],
    "chroma_larger": [(1, 1), (2, 2), (2, 2)],
    "h2v2_narrow": [(2, 2), (1, 1), (1, 1)],
    "grey_2x2": [(2, 2)],
}


@pytest.mark.parametrize("layout", ["interleaved", "non_interleaved", "restart_1"])
@pytest.mark.parametrize("size", [(37, 29), (5, 3)], ids=["37x29", "5x3"])
@pytest.mark.parametrize("name", sorted(FACTORS))
def test_encoder_sampling_sets(name, size, layout):
    factors = FACTORS[name]
    width, height = size
    img = sample_image(width, height, seed=len(name))
    planes = planes_for(img, factors)
    scans = [[c] for c in range(len(factors))] if layout == "non_interleaved" else None
    raw = encode_baseline(planes, factors, width, height, scans=scans, restart=1 if layout == "restart_1" else 0)
    assert_same(raw)


@pytest.mark.parametrize("adobe", [False, True])
def test_encoder_rgb_with_subsampling(adobe):
    """RGB components (ids R, G, B, or an Adobe marker with transform 0)
    are upsampled like any other; Pillow cannot write such a file."""
    img = sample_image(37, 29, seed=11)
    factors = [(2, 2), (1, 1), (1, 2)]
    raw = encode_baseline(planes_for(img, factors), factors, 37, 29, ids=None if adobe else [82, 71, 66])
    if adobe:
        app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
        raw = raw[:2] + b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big") + app14 + raw[2:]
    assert_same(raw)


def test_encoder_non_interleaved_with_restarts_and_saturation():
    img = sample_image(45, 38, seed=9)
    factors = FACTORS["mixed_h2v1_h1v2"]
    planes = planes_for(img, factors)
    raw = encode_baseline(planes, factors, 45, 38, scans=[[0], [2, 1]], restart=3, quality_scale=0.2)
    assert_same(raw)


@pytest.mark.parametrize("seed", range(4))
def test_idct_lanes_past_an_encoders_range(seed):
    """Coefficients no 8-bit encoder writes, at quantizer 255: the IDCT's
    16-bit lanes wrap and saturate as libjpeg-turbo's SIMD code does,
    including the blocks whose AC terms below the first row are zero."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-1023, 1024, (4, 4, 64)) * (rng.random((4, 4, 64)) < [0.9, 0.3, 0.05, 0.6][seed])
    blocks[0, :, 8:] = 0  # the whole-block DC path, with large first-row terms
    blocks[1, 0, 1:] = 0
    planes = [np.zeros((32, 32), np.uint8)]
    raw = encode_baseline(planes, [(1, 1)], 32, 32, quality_scale=40, coefficients=[blocks])
    assert_same(raw)


def test_fractional_sampling_raises_as_pillow_does():
    img = sample_image(24, 16)
    factors = [(3, 1), (2, 1), (1, 1)]
    raw = encode_baseline(planes_for(img, factors), factors, 24, 16)
    with pytest.raises(OSError):
        pillow_rgb(raw)
    with pytest.raises(ImageDecodeError, match="integer ratio"):
        decode_image(raw)


# -- refused by name ----------------------------------------------------------------------------


def patch_sof(raw: bytes, code: int = None, precision: int = None) -> bytes:
    (_, at, _), = [s for s in segments(raw) if s[0] in (0xC0, 0xC2)]
    raw = bytearray(raw)
    if code is not None:
        raw[at + 1] = code
    if precision is not None:
        raw[at + 4] = precision
    return bytes(raw)


@pytest.mark.parametrize("code, name", [(0xC9, "arithmetic-coded JPEG (SOF9)"),
                                        (0xCA, "arithmetic-coded progressive JPEG (SOF10)"),
                                        (0xC3, "lossless JPEG (SOF3)"), (0xC5, "hierarchical JPEG (SOF5)"),
                                        (0xC7, "hierarchical JPEG (SOF7)"),
                                        (0xCF, "arithmetic-coded hierarchical JPEG (SOF15)")])
def test_refused_frame_types_name_themselves(code, name):
    raw = patch_sof(pillow_jpeg(sample_image(16, 16), quality=90), code=code)
    with pytest.raises(UnsupportedImageFormat) as err:
        decode_image(raw)
    assert err.value.format == name and name in str(err.value)


@pytest.mark.parametrize("precision", [12, 16])
def test_refused_precision(precision):
    raw = patch_sof(pillow_jpeg(sample_image(16, 16), quality=90), precision=precision)
    with pytest.raises(OSError):
        pillow_rgb(raw)  # Pillow: "cannot handle 12-bit layers"
    with pytest.raises(UnsupportedImageFormat, match=f"{precision}-bit JPEG"):
        decode_image(raw)


def test_refused_component_count():
    img = sample_image(16, 16)
    raw = encode_baseline(planes_for(img, [(1, 1), (1, 1)]), [(1, 1), (1, 1)], 16, 16)
    with pytest.raises(OSError):
        pillow_rgb(raw)
    with pytest.raises(UnsupportedImageFormat, match="2-component JPEG"):
        decode_image(raw)


def test_progressive_with_unsent_ac_bits_is_refused_as_smoothing():
    raw = pillow_jpeg(sample_image(64, 48), quality=90, progressive=True)
    last_sos = raw.rindex(b"\xff\xda")
    cut = raw[:last_sos] + b"\xff\xd9"  # the last scan, an AC refinement, is gone
    assert pillow_rgb(cut).shape == (48, 64, 3)  # Pillow decodes it, smoothing the blocks
    with pytest.raises(UnsupportedImageFormat, match="block smoothing"):
        decode_image(cut)


# -- truncated and damaged data -------------------------------------------------------------------


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("cut", [3, 40, 200, 0.5, -30, -3])
def test_truncated_raises_where_pillow_does(cut, progressive):
    raw = pillow_jpeg(sample_image(64, 48), quality=90, progressive=progressive)
    end = int(len(raw) * cut) if isinstance(cut, float) else cut
    short = raw[:end]
    with pytest.raises(OSError):
        pillow_rgb(short)
    with pytest.raises(ImageDecodeError, match="JPEG"):
        decode_image(short)


@pytest.mark.parametrize("progressive", [False, True])
def test_unknown_marker_in_entropy_data_raises_where_pillow_does(progressive):
    raw = pillow_jpeg(sample_image(64, 48), quality=90, progressive=progressive)
    sos = raw.index(b"\xff\xda")
    at = sos + 40
    damaged = raw[:at] + b"\xff\x02" + raw[at:]
    with pytest.raises(OSError):
        pillow_rgb(damaged)
    with pytest.raises(ImageDecodeError, match="unknown marker FF02"):
        decode_image(damaged)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [0, 2])
def test_entropy_data_cut_before_eoi_decodes_as_pillow_does(progressive, restart):
    """Data that ends early at a marker: libjpeg warns, fills zeros and
    leaves the rest of each interval as it is; so does the port. (The cut
    is in the last scan: a progressive file missing earlier scans is one
    libjpeg would smooth.)"""
    raw = pillow_jpeg(sample_image(64, 48, seed=7), quality=90, progressive=progressive,
                      **({"restart_marker_blocks": restart} if restart else {}))
    sos = raw.rindex(b"\xff\xda")
    body_start = sos + 2 + int.from_bytes(raw[sos + 2:sos + 4], "big")
    damaged = raw[:body_start + 60] + b"\xff\xd9"
    assert_same(damaged)


@pytest.mark.parametrize("seed", range(4))
def test_garbled_entropy_bytes_decode_as_pillow_does(seed):
    raw = bytearray(pillow_jpeg(sample_image(64, 48, seed=seed), quality=90, restart_marker_blocks=3))
    sos = raw.index(b"\xff\xda")
    rng = np.random.default_rng(seed)
    for at in rng.integers(sos + 20, len(raw) - 10, 6):
        if raw[at] != 0xFF and raw[at - 1] != 0xFF:
            raw[at] = int(rng.integers(0, 255))
    assert_same(bytes(raw))


def test_out_of_sequence_restart_marker_resyncs_as_pillow_does():
    raw = pillow_jpeg(sample_image(64, 48, seed=2), quality=90, restart_marker_blocks=2)
    rst = [i for i in range(len(raw) - 1) if raw[i] == 0xFF and 0xD0 <= raw[i + 1] <= 0xD7]
    for which, new in ((1, 0xD5), (2, 0xD0), (3, raw[rst[3] + 1] + 1 if raw[rst[3] + 1] < 0xD7 else 0xD0)):
        damaged = bytearray(raw)
        damaged[rst[which] + 1] = new
        assert_same(bytes(damaged))


def _tail(raw: bytes, case: str) -> bytes:
    body = raw[:-2]  # without EOI
    sos = raw.index(b"\xff\xda")
    return {"no_eoi": body, "no_eoi_1_byte": body + b"\x55", "no_eoi_8_bytes": body + b"\x55" * 8,
            "no_eoi_12_bytes": body + b"\x55" * 12, "app1_past_the_end": body + b"\xff\xe1\x7f\xff",
            "com_then_end": body + b"\xff\xfe\x00\x05ab", "rst_then_end": body + b"\xff\xd3",
            "second_sof": body + b"\xff\xc0\x00\x11" + b"\x00" * 15 + b"\xff\xd9",
            "second_sos": body + raw[sos:sos + 14] + b"\xff\xd9",
            "unknown_marker": body + b"\xff\x05\xff\xd9",
            "bad_dht": body + b"\xff\xc4\x00\x13\x00" + b"\xff" * 16}[case]


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("case", ["no_eoi", "no_eoi_1_byte", "no_eoi_8_bytes", "no_eoi_12_bytes", "app1_past_the_end",
                                  "com_then_end", "rst_then_end", "second_sof", "second_sos", "unknown_marker",
                                  "bad_dht"])
def test_what_follows_the_scans_decodes_or_raises_as_pillow_does(case, progressive):
    """A one-pass frame (one baseline scan) is output as it decodes, and
    libjpeg then reads to EOI, so Pillow keeps the image where the data
    ends on the way but raises on a marker libjpeg rejects; a progressive
    frame is read whole before output, so its data must reach EOI (an
    empty scan on the way changes nothing)."""
    raw = _tail(pillow_jpeg(sample_image(64, 48, seed=1), quality=90, progressive=progressive), case)
    try:
        want = pillow_rgb(raw)
    except OSError:
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return
    assert_same(raw)


def test_trailing_bytes_after_eoi_are_ignored():
    raw = pillow_jpeg(sample_image(17, 33), quality=90)
    assert_same(raw + b"\x00garbage\xff\xd8")
