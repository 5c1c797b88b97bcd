"""image/gif.py and native/gif.cpp against Pillow 12.1's GifImagePlugin:
the first frame decodes bit-equal to ``Image.open(...).convert("RGB")``,
or both refuse it.

- Pillow-written files: modes "1", "L", "P", "RGB", "RGBA", "LA" at page
  and edge sizes, interlaced or not, with a transparency index, and
  animations (the first frame only);
- files written here: interlace at every height to 17, local colour
  tables over a global one, frame rectangles inside and past the logical
  screen with and without a transparency index (what fills the rest),
  identity-ramp tables (global, local, both), indices past a short table,
  no table at all, comment, application and unknown extensions and a
  stray byte before the frame, code sizes 2 to 8, codes past 4096 with a
  deferred clear and with Clear codes, GIF87a;
- data both refuse: a truncated file, an End of Information or a block
  terminator before the frame is full, a code past the table, no frame.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu_torch.image.decode import ImageDecodeError, decode_image


def pillow_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def assert_same_as_pillow(raw: bytes) -> bool:
    """Equal to Pillow's pixels (True), or refused where Pillow refuses (False)."""
    try:
        want = pillow_rgb(raw)
    except Exception:  # noqa: BLE001 - Pillow's refusals are OSError, EOFError, ...
        with pytest.raises(ImageDecodeError):
            decode_image(raw)
        return False
    got = decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return True


def page(rng, w: int, h: int, top: int = 255) -> np.ndarray:
    img = np.full((h, w), top, np.int64)
    for _ in range(max(1, w * h // 30)):
        x, y = rng.integers(0, w), rng.integers(0, h)
        img[y:y + rng.integers(1, 3), x:x + rng.integers(1, 7)] = rng.integers(0, top // 3 + 1)
    noise = rng.random((h, w)) < 0.08
    img[noise] = rng.integers(0, top + 1, int(noise.sum()))
    return img


# -- Pillow-written ----------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA"])
@pytest.mark.parametrize("size", [(1, 1), (5, 3), (45, 29), (300, 40)])
@pytest.mark.parametrize("kw", [{}, {"interlace": True}, {"transparency": 0}], ids=["plain", "interlace", "trns"])
def test_pillow_written_gif_decodes_equal(mode, size, kw):
    w, h = size
    rng = np.random.default_rng(w * h)
    grey = page(rng, w, h).astype(np.uint8)
    rgba = np.stack([grey, np.roll(grey, 1, axis=1), rng.integers(0, 256, (h, w)), grey], axis=2)
    im = Image.fromarray(rgba.astype(np.uint8), "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "GIF", **kw)
    assert assert_same_as_pillow(buf.getvalue())


def test_animation_first_frame():
    rng = np.random.default_rng(2)
    frames = [Image.fromarray(page(rng, 40, 30).astype(np.uint8)).convert("P") for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=50, loop=0)
    assert assert_same_as_pillow(buf.getvalue())


# -- a GIF writer ----------------------------------------------------------------------------------------


def lzw_encode(indices, min_size: int, clear_every: int = 0, cut_at: int = None) -> bytes:
    """GIF LZW, LSB first: Clear, codes growing from min_size + 1 bits to
    12, no additions past 4095 (a deferred clear) unless `clear_every`
    codes ask for a Clear; EOI at the end (after `cut_at` indices when
    given, before the frame is full)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    size, nxt = min_size + 1, eoi + 1
    table = {bytes([i]): i for i in range(clear)}
    acc = nacc = 0
    out = bytearray()

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    put(clear)
    w, emitted = b"", 0
    seq = list(indices)[:cut_at] if cut_at is not None else list(indices)
    for v in seq:
        wc = w + bytes([v])
        if wc in table:
            w = wc
            continue
        put(table[w])
        emitted += 1
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        w = bytes([v])
        if clear_every and emitted % clear_every == 0:  # start over; w carries on as a literal
            put(clear)
            table = {bytes([i]): i for i in range(clear)}
            size, nxt = min_size + 1, eoi + 1
    if w:
        put(table[w])
        if nxt == (1 << size) and size < 12:
            size += 1
    put(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size] for i in range(0, len(data), size)) + b"\0"


def write_gif(screen, frame, indices, *, global_table=None, local_table=None, min_size=8, transparency=None,
              interlace=False, extensions=b"", data=None, version=b"GIF89a", trailer=True) -> bytes:
    w, h = screen
    x0, y0 = frame
    fh, fw = indices.shape
    out = bytearray(version + struct.pack("<HH", w, h))
    if global_table is not None:
        bits = int(np.log2(len(global_table))) - 1
        out += bytes([0x80 | bits, 0, 0]) + np.asarray(global_table, np.uint8).tobytes()
    else:
        out += bytes([0, 0, 0])
    out += extensions
    if transparency is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
    flags = 0x40 if interlace else 0
    if local_table is not None:
        flags |= 0x80 | (int(np.log2(len(local_table))) - 1)
    out += b"," + struct.pack("<HHHHB", x0, y0, fw, fh, flags)
    if local_table is not None:
        out += np.asarray(local_table, np.uint8).tobytes()
    rows = indices
    if interlace:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8), np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = indices[order]
    out += bytes([min_size]) + sub_blocks(data if data is not None else lzw_encode(rows.reshape(-1), min_size))
    return bytes(out + (b";" if trailer else b""))


def table(rng, n):
    return rng.integers(0, 256, (n, 3))


IDENTITY = np.repeat(np.arange(16)[:, None], 3, axis=1)


@pytest.mark.parametrize("height", range(1, 18))
def test_interlace_every_height(height):
    rng = np.random.default_rng(height)
    idx = page(rng, 7, height, 15).astype(np.uint8)
    assert assert_same_as_pillow(write_gif((7, height), (0, 0), idx, global_table=table(rng, 16), min_size=4,
                                           interlace=True))


CASES = {
    "local_over_global": dict(global_table="g16", local_table="l16"),
    "local_only": dict(local_table="l16"),
    "no_table": dict(),
    "identity_global": dict(global_table="identity"),
    "identity_local_over_global": dict(global_table="g16", local_table="identity"),
    "identity_local_only": dict(local_table="identity"),
    "frame_inside": dict(global_table="g16", screen=(20, 15), frame=(3, 4)),
    "frame_inside_trns": dict(global_table="g16", screen=(20, 15), frame=(3, 4), transparency=5),
    "frame_past_screen": dict(global_table="g16", screen=(8, 6), frame=(4, 3)),
    "frame_past_screen_trns": dict(local_table="l16", screen=(8, 6), frame=(4, 3), transparency=2),
    "index_past_table": dict(global_table="g4", min_size=4),
    "extensions": dict(global_table="g16", extensions=(
        b"\x21\xfe" + sub_blocks(b"a comment") + b"\x21\xff" + sub_blocks(b"NETSCAPE2.0") + b"\x03\x01\x00\x00\x00"
        + b"\x21\x01" + sub_blocks(b"plain text ext") + b"\x07")),  # 0x07: a stray byte, skipped
    "gif87a": dict(global_table="g16", version=b"GIF87a"),
    "code_size_2": dict(global_table="g4", min_size=2, values=4),
    "code_size_3": dict(global_table="g16", min_size=3, values=8),
    "interlaced_local": dict(local_table="l16", interlace=True, screen=(30, 30), frame=(2, 1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_hand_built_gif_decodes_equal(name):
    case = dict(CASES[name])
    rng = np.random.default_rng(len(name))
    tables = {"g16": table(rng, 16), "l16": table(rng, 16), "g4": table(rng, 4), "identity": IDENTITY}
    for key in ("global_table", "local_table"):
        if key in case:
            case[key] = tables[case[key]]
    screen = case.pop("screen", (23, 17))
    frame = case.pop("frame", (0, 0))
    top = case.pop("values", 16) - 1
    idx = page(rng, min(23, screen[0] + 3), min(17, screen[1] + 2), top).astype(np.uint8)
    assert assert_same_as_pillow(write_gif(screen, frame, idx, min_size=case.pop("min_size", 4), **case))


@pytest.mark.parametrize("clear_every", [0, 700])
def test_lzw_past_4096_codes(clear_every):
    """A noisy 8-bit frame fills the 12-bit table: no more entries until a
    Clear (never, or every 700 codes)."""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 256, (90, 160)).astype(np.uint8)
    g = table(rng, 256)
    raw = write_gif((160, 90), (0, 0), idx, global_table=g,
                    data=lzw_encode(idx.reshape(-1), 8, clear_every=clear_every))
    assert assert_same_as_pillow(raw)
    np.testing.assert_array_equal(decode_image(raw), g[idx])


@pytest.mark.parametrize("case", ["truncated_file", "early_eoi", "early_terminator", "bad_code", "no_frame"])
def test_gif_both_refuse(case):
    rng = np.random.default_rng(3)
    idx = page(rng, 12, 9, 15).astype(np.uint8)
    g = table(rng, 16)
    full = lzw_encode(idx.reshape(-1), 4)
    if case == "truncated_file":
        raw = write_gif((12, 9), (0, 0), idx, global_table=g, min_size=4)[:-len(full) // 2]
    elif case == "early_eoi":
        raw = write_gif((12, 9), (0, 0), idx, global_table=g, min_size=4,
                        data=lzw_encode(idx.reshape(-1), 4, cut_at=50))
    elif case == "early_terminator":
        raw = write_gif((12, 9), (0, 0), idx, global_table=g, min_size=4, data=full[:len(full) // 2])
    elif case == "bad_code":  # Clear, then a code far past the table
        raw = write_gif((12, 9), (0, 0), idx, global_table=g, min_size=4, data=bytes([0x10, 0xFF, 0xFF, 0xFF]))
    else:
        raw = b"GIF89a" + struct.pack("<HH", 4, 4) + bytes([0, 0, 0]) + b";"
    assert not assert_same_as_pillow(raw)
