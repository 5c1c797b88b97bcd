"""Writes the PNM and Zstandard TIFF page fixtures beside this file, and
``pnm_pages.json`` with the sha256 of Pillow's ``convert("RGB")`` of each:

- ``page.pbm``: raw PBM (P4) of ``page.bmp``'s bilevel pixels, as
  ``pdftoppm -mono`` and SANE's ``scanimage`` hand pages over;
- ``page_zstd.tif``: the text page of make_format_pages.py as RGB,
  Zstandard (compression 50000) with horizontal differencing
  (Predictor 2), written by Pillow's libtiff.

The pages ``built`` are not committed: the numpy writers below make them
at run time from committed fixtures (chip_smoke.py's ``host_prep_pnm``
and tests/test_torch_pnm_pages.py call them, without Pillow), and the
JSON records Pillow's digest of each:

- ``page.ppm``: raw PPM (P6) of ``page_lzw.tif``'s RGB;
- ``page16.pgm``: raw 16-bit PGM (P5, maxval 65535) of its green
  channel × 257 plus its red one, as 16-bit scanners write grey;
- ``page_plain.pgm``: plain PGM (P2) of its green channel, three digits
  a sample, a row a line;
- ``page_ojpeg.tif``: ``page_baseline.jpg`` (4:2:0) as one old-style
  JPEG-in-TIFF strip (compression 6, JPEGInterchangeFormat), as the
  document archives of the 1990s wrote colour pages.

Run it with Pillow installed (it needs page.bmp, page_lzw.tif and
page_baseline.jpg, and rewrites only its own files):

    python tests/data/make_pnm_pages.py
"""

import hashlib
import io
import json
import pathlib
import struct

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def pbm(bits: np.ndarray) -> bytes:
    """(H, W) booleans, True black → raw PBM (P4), rows padded to a byte."""
    h, w = bits.shape
    return b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()


def ppm(rgb: np.ndarray) -> bytes:
    h, w = rgb.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def pgm16(rgb: np.ndarray) -> bytes:
    """A 16-bit grey page: green × 257 + red (maxval 65535, big-endian)."""
    h, w = rgb.shape[:2]
    grey = rgb[..., 1].astype(np.uint32) * 257 + rgb[..., 0]
    return b"P5\n%d %d\n65535\n" % (w, h) + np.minimum(grey, 65535).astype(">u2").tobytes()


def plain_pgm(rgb: np.ndarray) -> bytes:
    """Plain PGM (P2) of the green channel: "ddd" a sample, a space
    between, a newline after each row."""
    h, w = rgb.shape[:2]
    v = rgb[..., 1].astype(np.uint8)
    chars = np.empty((h, w, 4), np.uint8)
    chars[..., 0], chars[..., 1], chars[..., 2] = 48 + v // 100, 48 + v // 10 % 10, 48 + v % 10
    chars[..., 3] = 32
    chars[:, -1, 3] = 10
    return b"P2\n# plain grey page\n%d %d\n255\n" % (w, h) + chars.tobytes()


def old_style_jpeg_tiff(stream: bytes, width: int, height: int) -> bytes:
    """One JFIF stream → an old-style JPEG TIFF: the stream at
    JPEGInterchangeFormat (513, 514), one strip pointing at its
    entropy-coded data, Photometric YCbCr, 3 samples."""
    pos = 2
    while stream[pos + 1] != 0xDA:
        pos += 2 + struct.unpack(">H", stream[pos + 2:pos + 4])[0]
    data_at = 8 + pos + 2 + struct.unpack(">H", stream[pos + 2:pos + 4])[0]
    body = b"II*\x00" + b"\0" * 4 + stream + b"\0" * (len(stream) % 2)
    bits_at = len(body)
    body += struct.pack("<HHH", 8, 8, 8) + b"\0\0"
    entries = [(256, 4, width), (257, 4, height), (258, 3, None), (259, 3, 6), (262, 3, 6), (273, 4, data_at),
               (277, 3, 3), (278, 4, height), (279, 4, 8 + len(stream) - data_at), (284, 3, 1), (513, 4, 8),
               (514, 4, len(stream))]
    ifd = len(body)
    table = struct.pack("<H", len(entries))
    for tag, kind, value in entries:
        if tag == 258:
            table += struct.pack("<HHLL", tag, kind, 3, bits_at)
        else:
            field = struct.pack("<" + {3: "H", 4: "L"}[kind], value).ljust(4, b"\0")
            table += struct.pack("<HHL", tag, kind, 1) + field
    return body[:4] + struct.pack("<L", ifd) + body[8:] + table + b"\0\0\0\0"


def built_pages(lzw_rgb: np.ndarray, baseline_jpg: bytes):
    """{name: (bytes, the committed fixture it comes from)}."""
    h, w = lzw_rgb.shape[:2]
    return {"page.ppm": (ppm(lzw_rgb), "page_lzw.tif"), "page16.pgm": (pgm16(lzw_rgb), "page_lzw.tif"),
            "page_plain.pgm": (plain_pgm(lzw_rgb), "page_lzw.tif"),
            "page_ojpeg.tif": (old_style_jpeg_tiff(baseline_jpg, w, h), "page_baseline.jpg")}


def main() -> None:
    from PIL import Image, features

    from make_format_pages import text_page

    def entry(raw: bytes, **extra):
        rgb = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        return {**extra, "bytes": len(raw), "shape": list(rgb.shape),
                "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}

    meta = {"pillow": Image.__version__, "libtiff": features.version("libtiff"),
            "libjpeg_turbo": features.version("libjpeg_turbo"), "files": {}, "built": {}}
    bilevel = np.asarray(Image.open(HERE / "page.bmp").convert("L")) == 0
    buf = io.BytesIO()
    Image.fromarray(text_page()).save(buf, format="TIFF", compression="zstd", tiffinfo={317: 2})
    for name, raw, options in (("page.pbm", pbm(bilevel), {"format": "PNM", "magic": "P4", "from": "page.bmp"}),
                               ("page_zstd.tif", buf.getvalue(), {"format": "TIFF", "compression": "zstd",
                                                                  "predictor": 2})):
        (HERE / name).write_bytes(raw)
        meta["files"][name] = entry(raw, options=options)
    lzw_rgb = np.asarray(Image.open(HERE / "page_lzw.tif").convert("RGB"))
    for name, (raw, source) in built_pages(lzw_rgb, (HERE / "page_baseline.jpg").read_bytes()).items():
        meta["built"][name] = entry(raw, source=source)
    (HERE / "pnm_pages.json").write_text(json.dumps(meta, indent=1) + "\n")


if __name__ == "__main__":
    main()
