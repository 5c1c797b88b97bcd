"""Writes the TIFF, BMP and GIF page fixtures beside this file: the JPEG
fixtures' seeded document page (make_jpeg_pages.document_page, 1756 ×
2852) with its photo region painted paper-white, so that what is left is
lines of dark glyph boxes on white, saved by Pillow as

- ``page_g4.tif``: bilevel (threshold 128), CCITT T.6 (Group 4), as
  office scanners and fax servers hand pages over;
- ``page_lzw.tif``: RGB, LZW with horizontal differencing (Predictor 2);
- ``page.bmp``: bilevel, 1 bit per pixel;
- ``page.gif``: a 16-colour adaptive palette;
- ``page_jpeg_ycc420.tif``: YCbCr 4:2:0 JPEG-in-TIFF (compression 7,
  photometric 6), as scanners and archive pipelines write colour pages:
  strips of 64 rows, each a Pillow-encoded baseline JPEG (quality 80),
  their shared quantization and Huffman tables moved into JPEGTables
  (Pillow's libtiff writer cannot write subsampled YCbCr JPEG, so the
  file is put together here);

and ``format_pages.json``: each file's shape and bytes and the sha256 of
Pillow's ``convert("RGB")`` of it, with the Pillow and libtiff versions
that wrote and read them. Run it with Pillow installed:

    python tests/data/make_format_pages.py
"""

import hashlib
import io
import json
import pathlib
import struct

import numpy as np
from PIL import Image, features

from make_jpeg_pages import document_page

HERE = pathlib.Path(__file__).resolve().parent


def text_page() -> np.ndarray:
    page = document_page()
    page[1000:1700, 180:1300] = 246  # the photo region of document_page
    return page


def images(page: np.ndarray):
    """{file name: (image, save options)}; only (mode, compression) pairs
    Pillow's writer takes without crashing (group4 on "1" only)."""
    bilevel = Image.fromarray(page).convert("L").point(lambda v: 255 if v > 128 else 0).convert("1")
    return {
        "page_g4.tif": (bilevel, {"format": "TIFF", "compression": "group4"}),
        "page_lzw.tif": (Image.fromarray(page), {"format": "TIFF", "compression": "tiff_lzw", "tiffinfo": {317: 2}}),
        "page.bmp": (bilevel, {"format": "BMP"}),
        "page.gif": (Image.fromarray(page).convert("P", palette=Image.Palette.ADAPTIVE, colors=16), {"format": "GIF"}),
    }


JPEG_ROWS, JPEG_QUALITY = 64, 80


def _segments(stream: bytes):
    """A JPEG stream's marker segments before its scan → [(code, bytes)],
    and the rest from SOS on."""
    pos, out = 2, []
    while stream[pos + 1] != 0xDA:
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        out.append((stream[pos + 1], stream[pos:pos + 2 + length]))
        pos += 2 + length
    return out, stream[pos:]


def jpeg_ycc420_tiff(page: np.ndarray) -> bytes:
    """RGB page → YCbCr 4:2:0 JPEG-in-TIFF: one Pillow JPEG a strip, the
    tables (the same in every strip) in tag 347, the strips abbreviated."""
    height, width = page.shape[:2]
    tables, strips = None, []
    for y in range(0, height, JPEG_ROWS):
        buf = io.BytesIO()
        Image.fromarray(page[y:y + JPEG_ROWS]).save(buf, "JPEG", quality=JPEG_QUALITY, subsampling=2)
        segments, scan = _segments(buf.getvalue())
        shared = b"".join(seg for code, seg in segments if code in (0xDB, 0xC4))
        assert tables in (None, shared), "Pillow changed the tables between strips"
        tables = shared
        strips.append(b"\xff\xd8" + b"".join(seg for code, seg in segments if code == 0xC0) + scan)
    body = bytearray(8)
    offsets = []
    for strip in strips:
        offsets.append(len(body))
        body += strip + b"\0" * (len(strip) % 2)
    jpeg_tables = b"\xff\xd8" + tables + b"\xff\xd9"
    entries = [(256, 4, [width]), (257, 4, [height]), (258, 3, [8, 8, 8]), (259, 3, [7]), (262, 3, [6]),
               (273, 4, offsets), (277, 3, [3]), (278, 4, [JPEG_ROWS]), (279, 4, [len(s) for s in strips]),
               (284, 3, [1]), (347, 7, jpeg_tables), (530, 3, [2, 2])]
    ifd = len(body)
    extra = bytearray()
    table = struct.pack("<H", len(entries))
    for tag, kind, values in entries:
        data = bytes(values) if kind == 7 else struct.pack("<" + {3: "H", 4: "L"}[kind] * len(values), *values)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack("<L", ifd + 2 + 12 * len(entries) + 4 + len(extra))
            extra += data + b"\0" * (len(data) % 2)
        table += struct.pack("<HHL", tag, kind, len(values)) + field
    body[:8] = b"II*\x00" + struct.pack("<L", ifd)
    return bytes(body + table + b"\0\0\0\0" + extra)


def main() -> None:
    meta = {"pillow": Image.__version__, "libtiff": features.version("libtiff"), "files": {}}
    page = text_page()
    written = {}
    for name, (image, options) in images(page).items():
        buf = io.BytesIO()
        image.save(buf, **options)
        written[name] = (buf.getvalue(), options)
    written["page_jpeg_ycc420.tif"] = (jpeg_ycc420_tiff(page), {
        "format": "TIFF", "compression": "jpeg", "photometric": "YCbCr", "subsampling": "4:2:0",
        "rows_per_strip": JPEG_ROWS, "quality": JPEG_QUALITY, "tables": "JPEGTables"})
    for name, (raw, options) in written.items():
        (HERE / name).write_bytes(raw)
        rgb = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        recorded = {k: v for k, v in options.items() if k != "tiffinfo"}
        if "tiffinfo" in options:
            recorded["predictor"] = options["tiffinfo"][317]
        meta["files"][name] = {"options": recorded, "bytes": len(raw), "shape": list(rgb.shape),
                               "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "format_pages.json").write_text(json.dumps(meta, indent=1) + "\n")


if __name__ == "__main__":
    main()
