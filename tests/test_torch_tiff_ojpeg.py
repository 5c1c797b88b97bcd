"""Old-style JPEG TIFF (compression 6), image/tiff.py's model of libtiff's
tif_ojpeg.c over native/jpeg.cpp's raw data units and
native/tiff_color.cpp's YCbCr conversion, bit-equal to Pillow 12.1 over
libtiff 4.7 and libjpeg-turbo 3.1 (which forces YCbCr and reads through
libtiff's RGBA reader), or raising ``ImageDecodeError`` where Pillow
raises. Files are built here around JPEG streams Pillow writes (4:2:0,
4:2:2, 4:4:4) and ones the NumPy baseline encoder of
tests/test_torch_jpeg.py writes (4:4, 4:1, 1:2):

- the JPEGInterchangeFormat layout: one JFIF stream at tag 513 (with and
  without its length, 514), one strip or several pointing into its
  entropy-coded data (a DRI and RST markers at the strip bounds), or
  strips of their own after a stream of tables and SOF/SOS only;
- the table-tag layout: JPEGQTables, JPEGDCTables, JPEGACTables (shared
  tables by a repeated offset), JPEGRestartInterval, YCbCrSubsampling or
  its 2 × 2 default (which misreads other data as libtiff does), strips
  of bare entropy-coded data between which libtiff puts RST markers;
- Photometric 6, 2 or missing, SamplesPerPixel missing, odd sizes,
  Orientation, restart intervals, truncated and damaged data, and what
  libtiff refuses (strips of the wrong height, unknown markers, missing
  tables, other photometrics);
- strips that read on to the end of the file (no byte counts, counts
  past the end), thousands of them at one address, read in place in
  bounded memory, and the bounds past which the port raises.
"""

import io
import struct
import time
import tracemalloc

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu_torch.image.decode import ImageDecodeError, UnsupportedImageFormat, decode_image
from tests.test_torch_jpeg import encode_baseline, planes_for
from tests.test_torch_tiff_jpeg import tiff


def pillow_rgb(raw: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    except Exception as err:  # noqa: BLE001 - Pillow's refusals are OSError, ...
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


# -- building files ----------------------------------------------------------------------------------


def page(rng, h, w):
    base = np.cumsum(rng.integers(-9, 10, (h, w, 3)), axis=1) + rng.integers(60, 190, (h, 1, 3))
    return base.clip(0, 255).astype(np.uint8)


def pillow_stream(px, subsampling, rows_per_restart=None, quality=85) -> bytes:
    buf = io.BytesIO()
    extra = {"restart_marker_rows": rows_per_restart} if rows_per_restart else {}
    Image.fromarray(px).save(buf, "JPEG", subsampling=subsampling, quality=quality, **extra)
    return buf.getvalue()


def baseline_stream(px, factors, restart=0) -> bytes:
    h, w = px.shape[:2]
    return encode_baseline(planes_for(px, factors), factors, w, h, restart=restart)


def split(stream: bytes):
    """A JPEG stream → ([(marker, body)] up to and with SOS, the offset of
    the entropy-coded data, its intervals between RST markers)."""
    pos, segs = 2, []
    while True:
        code, n = stream[pos + 1], int.from_bytes(stream[pos + 2:pos + 4], "big")
        segs.append((code, stream[pos + 4:pos + 2 + n]))
        pos += 2 + n
        if code == 0xDA:
            break
    data = stream[pos:stream.rindex(b"\xff\xd9")]
    parts, start, i = [], 0, 0
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            parts.append(data[start:i])
            start = i = i + 2
            continue
        i += 1
    parts.append(data[start:])
    return segs, pos, parts


def set_tags(raw: bytes, tags) -> bytes:
    """Rewrite (or with a value of None drop) IFD entries; values past 4
    bytes are appended to the file."""
    raw = bytearray(raw)
    ifd = struct.unpack("<L", raw[4:8])[0]
    n = struct.unpack("<H", raw[ifd:ifd + 2])[0]
    at = [ifd + 2 + 12 * i for i in range(n)]
    entries = {struct.unpack("<H", raw[a:a + 2])[0]: bytes(raw[a:a + 12]) for a in at}
    for tag, value in tags.items():
        if value is None:
            entries.pop(tag, None)
            continue
        kind, vals = value
        data = struct.pack("<" + {3: "H", 4: "L"}[kind] * len(vals), *vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            if len(raw) % 2:
                raw += b"\0"
            field = struct.pack("<L", len(raw))
            raw += data
        entries[tag] = struct.pack("<HHL", tag, kind, len(vals)) + field
    if len(raw) % 2:
        raw += b"\0"
    new_ifd = len(raw)
    raw += struct.pack("<H", len(entries)) + b"".join(entries[t] for t in sorted(entries)) + b"\0\0\0\0"
    raw[4:8] = struct.pack("<L", new_ifd)
    return bytes(raw)


def jif_tiff(stream, w, h, rps=None, *, length=True, photometric=6, tags=None) -> bytes:
    """The JPEGInterchangeFormat layout: the stream at 513, its strips
    pointing into its entropy-coded data."""
    _, data_at, parts = split(stream)
    base = tiff([stream], w, h, (8, 8, 8), photometric, 6, rps=rps)
    offsets, pos = [], 8 + data_at
    for p in parts:
        offsets.append(pos)
        pos += len(p) + 2
    extra = {513: (4, [8]), 514: (4, [len(stream)]) if length else None, 273: (4, offsets),
             279: (4, [len(p) for p in parts])}
    return set_tags(base, {**extra, **(tags or {})})


def header_only_tiff(stream, w, h, rps=None, *, tags=None) -> bytes:
    """513 holds the stream's markers up to SOS only; the strips hold the
    entropy-coded intervals."""
    _, data_at, parts = split(stream)
    base = tiff([stream[:data_at]] + parts, w, h, (8, 8, 8), 6, 6, rps=rps)
    offsets = list(_offsets(base))
    extra = {513: (4, [offsets[0]]), 514: (4, [data_at]), 273: (4, offsets[1:]), 279: (4, [len(p) for p in parts])}
    return set_tags(base, {**extra, **(tags or {})})


def _offsets(raw):
    from dsocr_tpu_torch.image.tiff import _Directory
    return _Directory(raw).get(273)


def tables_tiff(stream, w, h, rps=None, *, subsampling=None, shared=True, tags=None) -> bytes:
    """The table-tag layout: the stream's tables at 519, 520 and 521, its
    entropy-coded intervals as the strips (one strip: all its data, RST
    markers and all)."""
    segs, data_at, parts = split(stream)
    if rps is None:
        parts = [stream[data_at:stream.rindex(b"\xff\xd9")]]
    q, dc, ac, comps, sel = {}, {}, {}, None, None
    for code, body in segs:
        if code == 0xDB:
            for at in range(0, len(body), 65):
                q[body[at] & 15] = body[at + 1:at + 65]
        elif code == 0xC4:
            at = 0
            while at < len(body):
                n = sum(body[at + 1:at + 17])
                (ac if body[at] >> 4 else dc)[body[at] & 15] = body[at + 1:at + 17 + n]
                at += 17 + n
        elif code == 0xC0:
            comps = [body[6 + 3 * i:9 + 3 * i] for i in range(body[5])]
        elif code == 0xDA:
            sel = [body[2 + 2 * i] for i in range(body[0])]
    tq, td, ta = [c[2] for c in comps], [s >> 4 for s in sel], [s & 15 for s in sel]
    if not shared:  # a table of its own for each component, at its own offset
        tq, td, ta = [0, 1, 2], [0, 1, 2], [0, 1, 2]
        q, dc, ac = {i: q[min(i, max(q))] for i in range(3)}, {i: dc[min(i, max(dc))] for i in range(3)}, \
            {i: ac[min(i, max(ac))] for i in range(3)}
    blobs = [q[t] for t in sorted(set(tq))] + [dc[t] for t in sorted(set(td))] + [ac[t] for t in sorted(set(ta))]
    base = tiff(parts + blobs, w, h, (8, 8, 8), 6, 6, rps=rps)
    at = list(_offsets(base))
    where = dict(zip(range(len(blobs)), at[len(parts):]))
    keys = [("q", t) for t in sorted(set(tq))] + [("dc", t) for t in sorted(set(td))] + \
        [("ac", t) for t in sorted(set(ta))]
    place = {k: where[i] for i, k in enumerate(keys)}
    extra = {512: (3, [1]), 519: (4, [place[("q", t)] for t in tq]), 520: (4, [place[("dc", t)] for t in td]),
             521: (4, [place[("ac", t)] for t in ta]), 273: (4, at[:len(parts)]), 279: (4, [len(p) for p in parts])}
    if subsampling:
        extra[530] = (3, list(subsampling))
    return set_tags(base, {**extra, **(tags or {})})


PILLOW_SAMPLING = {2: (2, 2), 1: (2, 1), 0: (1, 1)}
BASELINE_SAMPLING = {"4:4": [(4, 4), (1, 1), (1, 1)], "4:1": [(4, 1), (1, 1), (1, 1)], "1:2": [(1, 2), (1, 1), (1, 1)],
                     "2:2": [(2, 2), (1, 1), (1, 1)], "1:1": [(1, 1), (1, 1), (1, 1)]}


# -- the JPEGInterchangeFormat layout ----------------------------------------------------------------


@pytest.mark.parametrize("subsampling", [2, 1, 0], ids=["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("size", [(40, 32), (37, 29), (64, 48), (9, 7)])
@pytest.mark.parametrize("length", [True, False])
def test_jif_one_strip(subsampling, size, length):
    w, h = size
    px = page(np.random.default_rng(w + subsampling), h, w)
    out = assert_same(jif_tiff(pillow_stream(px, subsampling), w, h, length=length))
    assert np.abs(out.astype(int) - px).mean() < 40  # the page, not noise


@pytest.mark.parametrize("subsampling", [2, 1, 0], ids=["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("size", [(40, 32), (37, 29), (70, 50)])
def test_jif_several_strips(subsampling, size):
    """Strips of one MCU row each, pointing between the stream's RST markers."""
    w, h = size
    px = page(np.random.default_rng(h + subsampling), h, w)
    rps = 8 * PILLOW_SAMPLING[subsampling][1]
    assert_same(jif_tiff(pillow_stream(px, subsampling, rows_per_restart=1), w, h, rps=rps))


@pytest.mark.parametrize("subsampling", [2, 0], ids=["4:2:0", "4:4:4"])
def test_jif_restart_markers_in_one_strip(subsampling):
    w, h = 48, 40
    px = page(np.random.default_rng(9), h, w)
    stream = pillow_stream(px, subsampling, rows_per_restart=1)
    base = tiff([stream], w, h, (8, 8, 8), 6, 6)
    assert_same(set_tags(base, {513: (4, [8]), 514: (4, [len(stream)])}))


@pytest.mark.parametrize("subsampling", [2, 1], ids=["4:2:0", "4:2:2"])
def test_jif_header_then_strips_of_their_own(subsampling):
    w, h = 48, 64
    px = page(np.random.default_rng(11), h, w)
    rps = 8 * PILLOW_SAMPLING[subsampling][1]
    stream = pillow_stream(px, subsampling, rows_per_restart=1)
    assert_same(header_only_tiff(stream, w, h, rps=rps))
    assert_same(header_only_tiff(pillow_stream(px, subsampling), w, h))


@pytest.mark.parametrize("name", sorted(BASELINE_SAMPLING))
@pytest.mark.parametrize("size", [(40, 32), (35, 27), (66, 64)])
def test_jif_samplings_pillow_does_not_write(name, size):
    """4:4, 4:1 and 1:2 (and 2:2, 1:1) from the baseline encoder; 4:4
    rows of an odd number of units are a fractional scanline to
    OJPEGDecodeRaw, which leaves them zero."""
    w, h = size
    factors = BASELINE_SAMPLING[name]
    px = page(np.random.default_rng(w * h), h, w)
    assert_same(jif_tiff(baseline_stream(px, factors), w, h))
    vs = factors[0][1]
    across = -(-w // (8 * factors[0][0]))
    stream = baseline_stream(px, factors, restart=across)
    assert_same(jif_tiff(stream, w, h, rps=8 * vs))


# -- the table-tag layout ------------------------------------------------------------------------------


@pytest.mark.parametrize("subsampling", [2, 1, 0], ids=["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("size", [(40, 32), (37, 29), (64, 48)])
@pytest.mark.parametrize("strips", [1, 2])
@pytest.mark.parametrize("tagged", [True, False])
def test_table_tags(subsampling, size, strips, tagged):
    """With YCbCrSubsampling, or without it, where libtiff's 2 × 2 default
    misreads 4:2:2 and 4:4:4 data (several strips of 8 rows are then
    refused: not a multiple of 16)."""
    w, h = size
    px = page(np.random.default_rng(w + h + subsampling), h, w)
    vs = PILLOW_SAMPLING[subsampling][1]
    stream = pillow_stream(px, subsampling, rows_per_restart=1 if strips == 2 else None)
    rps = 8 * vs if strips == 2 else None
    assert_same(tables_tiff(stream, w, h, rps=rps, subsampling=PILLOW_SAMPLING[subsampling] if tagged else None))


@pytest.mark.parametrize("name", ["4:4", "4:1", "1:2", "2:2"])
def test_table_tags_baseline_samplings(name):
    w, h = 48, 40
    factors = BASELINE_SAMPLING[name]
    px = page(np.random.default_rng(len(name)), h, w)
    across = -(-w // (8 * factors[0][0]))
    stream = baseline_stream(px, factors, restart=across)
    assert_same(tables_tiff(stream, w, h, rps=8 * factors[0][1], subsampling=factors[0]))


def test_table_tags_one_table_each():
    w, h = 40, 32
    px = page(np.random.default_rng(3), h, w)
    assert_same(tables_tiff(pillow_stream(px, 2), w, h, subsampling=(2, 2), shared=False))


@pytest.mark.parametrize("restart", [0, 1, 3])
def test_table_tags_restart_interval_tag(restart):
    """JPEGRestartInterval stands for one strip; several strips get
    libtiff's interval of one strip's MCUs whatever the tag says."""
    w, h = 48, 32
    px = page(np.random.default_rng(restart), h, w)
    assert_same(tables_tiff(pillow_stream(px, 2, rows_per_restart=1), w, h, subsampling=(2, 2),
                            tags={515: (3, [restart])}))
    assert_same(tables_tiff(pillow_stream(px, 2, rows_per_restart=1), w, h, rps=16, subsampling=(2, 2),
                            tags={515: (3, [restart])}))


# -- tags, damage and refusals -----------------------------------------------------------------------------


@pytest.mark.parametrize("photometric, spp", [(6, 3), (6, None), (2, 3), (2, None), (None, 3), (None, None),
                                              (1, 3), (5, 3), (6, 1)])
def test_photometric_and_samples_per_pixel(photometric, spp):
    w, h = 40, 32
    px = page(np.random.default_rng(1), h, w)
    raw = jif_tiff(pillow_stream(px, 2), w, h)
    assert_same(set_tags(raw, {262: (3, [photometric]) if photometric else None, 277: (3, [spp]) if spp else None}))


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_orientation(orientation):
    w, h = 40, 24
    px = page(np.random.default_rng(orientation), h, w)
    assert_same(jif_tiff(pillow_stream(px, 2), w, h, tags={274: (3, [orientation])}))


@pytest.mark.parametrize("rps", [8, 16])
def test_one_strip_offset_under_shorter_rows_per_strip(rps):
    w, h = 40, 32
    px = page(np.random.default_rng(2), h, w)
    assert_same(jif_tiff(pillow_stream(px, 2), w, h, tags={278: (4, [rps])}))


@pytest.mark.parametrize("cut", [0.3, 0.7, 0.95])
@pytest.mark.parametrize("layout", ["jif", "tables"])
def test_truncated_data_reads_as_libjpeg_pads_it(cut, layout):
    w, h = 48, 32
    px = page(np.random.default_rng(int(cut * 10)), h, w)
    stream = pillow_stream(px, 2)
    _, data_at, parts = split(stream)
    if layout == "jif":
        short = stream[:data_at + int(len(parts[0]) * cut)]
        base = tiff([short], w, h, (8, 8, 8), 6, 6)
        raw = set_tags(base, {513: (4, [8]), 514: (4, [len(short)])})
    else:
        raw = tables_tiff(stream, w, h, subsampling=(2, 2))
        raw = set_tags(raw, {279: (4, [int(len(parts[0]) * cut)])})
    assert_same(raw)


def test_damaged_entropy_data():
    w, h = 48, 32
    px = page(np.random.default_rng(4), h, w)
    stream = bytearray(pillow_stream(px, 2))
    _, data_at, parts = split(bytes(stream))
    for at in (data_at + 5, data_at + len(parts[0]) // 2):
        stream[at] ^= 0x5A
    assert_same(jif_tiff(bytes(stream), w, h))


@pytest.mark.parametrize("which", [0, 2, 4])
@pytest.mark.parametrize("layout", ["jif", "tables"])
def test_restart_marker_out_of_place_fails_the_rows_after_it(which, layout):
    """libtiff's resync_to_restart is an error: the strip that reads the
    iMCU row where a restart marker is not the one due reads as zeros, and
    a strip after it fails (Pillow raises)."""
    w, h = 40, 96
    px = page(np.random.default_rng(which), h, w)
    stream = bytearray(pillow_stream(px, 2, rows_per_restart=1))
    rst = [i for i in range(len(stream) - 1) if stream[i] == 0xFF and 0xD0 <= stream[i + 1] <= 0xD7]
    stream[rst[which] + 1] = 0xD0 + (stream[rst[which] + 1] - 0xD0 + 4) % 8
    if layout == "jif":
        for rps in (16, 48, None):
            assert_same(jif_tiff(bytes(stream), w, h, rps=rps))
    else:
        assert_same(tables_tiff(bytes(stream), w, h, subsampling=(2, 2), tags={515: (3, [3])}))


@pytest.mark.parametrize("case", ["rows_not_a_multiple", "unknown_marker", "no_tables", "sof2", "sof3", "wrong_width",
                                  "short_height", "sos_before_sof", "sof_without_sos", "two_components", "16_bit_dqt",
                                  "tiled", "planar", "strip_past_the_end"])
def test_what_libtiff_refuses(case):
    w, h = 48, 32
    px = page(np.random.default_rng(5), h, w)
    stream = pillow_stream(px, 2, rows_per_restart=1)
    if case == "rows_not_a_multiple":
        raw = jif_tiff(stream, w, h, rps=8)
    elif case == "unknown_marker":
        raw = jif_tiff(stream[:2] + b"\xff\xc8\x00\x02" + stream[2:], w, h)
    elif case == "no_tables":
        raw = set_tags(tables_tiff(stream, w, h, subsampling=(2, 2)), {519: None})
    elif case in ("sof2", "sof3"):
        at = stream.index(b"\xff\xc0")
        raw = jif_tiff(stream[:at + 1] + (b"\xc2" if case == "sof2" else b"\xc3") + stream[at + 2:], w, h)
    elif case in ("wrong_width", "short_height"):
        raw = jif_tiff(stream, w - 8 if case == "wrong_width" else w, h + 8 if case == "short_height" else h)
    elif case == "sos_before_sof":
        at = stream.index(b"\xff\xc0")
        raw = jif_tiff(stream[:at] + stream[at + 4 + int.from_bytes(stream[at + 2:at + 4], "big") - 2:], w, h)
    elif case == "sof_without_sos":  # the JIF stream stops before its SOS; the strips hold the data
        _, data_at, parts = split(stream)
        sos = stream.index(b"\xff\xda")
        base = tiff([stream[:sos]] + parts, w, h, (8, 8, 8), 6, 6)
        at = list(_offsets(base))
        raw = set_tags(base, {513: (4, [at[0]]), 514: (4, [sos]), 273: (4, at[1:2]), 279: (4, [len(parts[0])])})
    elif case == "two_components":
        grey = io.BytesIO()
        Image.fromarray(px).convert("L").save(grey, "JPEG")
        raw = jif_tiff(grey.getvalue(), w, h)
    elif case == "16_bit_dqt":
        quant = io.BytesIO()
        Image.fromarray(px).save(quant, "JPEG", qtables=[[300] * 64, [2] * 64])
        raw = jif_tiff(quant.getvalue(), w, h)
    elif case == "tiled":
        raw = set_tags(jif_tiff(stream, w, h), {322: (3, [48]), 323: (3, [32]), 324: (4, [8]), 325: (4, [100]),
                                                273: None, 279: None})
    elif case == "planar":
        raw = jif_tiff(stream, w, h, tags={284: (3, [2])})
    else:
        raw = jif_tiff(stream, w, h, tags={273: (4, [1 << 30])})
    if case in ("tiled", "planar") and not isinstance(pillow_rgb(raw), BaseException):
        with pytest.raises(UnsupportedImageFormat, match="old-style JPEG"):  # refused by name
            decode_image(raw)
    else:
        assert_same(raw)


# -- strips that repeat the file's bytes ------------------------------------------------------------------


def repeated_strips(n: int, counts) -> bytes:
    """`n` strips of 16 rows, every one at the first strip's offset; with
    one byte count (libtiff pads the rest with zeros) or counts past the
    end, each reads on to the end of the file."""
    w, h = 64, 16 * n
    px = page(np.random.default_rng(0), h, w)
    raw = header_only_tiff(pillow_stream(px, 2, rows_per_restart=16), w, h, rps=16)
    first = list(_offsets(raw))[1]
    return set_tags(raw, {273: (4, [first] * n), 279: (4, [1] if counts == "one" else [len(raw) * 4] * n)})


@pytest.mark.parametrize("seed", [0, 1])
def test_strips_inside_the_jif_stream_without_byte_counts(seed):
    """No StripByteCounts: each strip reads on to the end of the file."""
    px = page(np.random.default_rng(seed), 96, 40)
    assert_same(set_tags(jif_tiff(pillow_stream(px, 2, rows_per_restart=1), 40, 96, rps=16), {279: None}))


@pytest.mark.parametrize("counts", ["one", "past the end"])
def test_strips_repeating_the_file_are_read_in_place(counts):
    """2,000 strips at one address, each read to the end of the file: the
    stream libjpeg reads is 1.3 GB, Pillow's result comes from it, and the
    port reads it in place in bounded memory and time."""
    raw = repeated_strips(2000, counts)
    want = pillow_rgb(raw)
    assert isinstance(want, np.ndarray)
    tracemalloc.start()
    start = time.perf_counter()
    try:
        got = decode_image(raw)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert time.perf_counter() - start < 10.0 and peak < 64 << 20
    np.testing.assert_array_equal(got, want)


def test_strips_reading_past_the_bound_raise():
    """4,000 such strips read 5.3 GB, past the port's 4 GiB bound: it
    raises at once (Pillow refuses this file too)."""
    raw = repeated_strips(4000, "one")
    assert isinstance(pillow_rgb(raw), BaseException)
    start = time.perf_counter()
    with pytest.raises(ImageDecodeError, match="bound"):
        decode_image(raw)
    assert time.perf_counter() - start < 2.0


@pytest.mark.parametrize("height", [65536, 70000])
def test_table_layout_frame_past_65535_lines_raises(height):
    """A JPEG frame holds at most 65535 lines. libtiff writes the low 16
    bits of a taller image's height into the SOF it makes and Pillow reads
    on past the frame's end; the port raises instead (recorded in
    ROADMAP)."""
    w = 16
    px = page(np.random.default_rng(1), 64, w)
    raw = set_tags(tables_tiff(pillow_stream(px, 2), w, 64, subsampling=(2, 2)),
                   {257: (4, [height]), 278: (4, [height])})
    with pytest.raises(ImageDecodeError, match="65535"):
        decode_image(raw)
