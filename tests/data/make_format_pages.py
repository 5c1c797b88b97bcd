"""Writes the TIFF, BMP and GIF page fixtures beside this file: the JPEG
fixtures' seeded document page (make_jpeg_pages.document_page, 1756 ×
2852) with its photo region painted paper-white, so that what is left is
lines of dark glyph boxes on white, saved by Pillow as

- ``page_g4.tif``: bilevel (threshold 128), CCITT T.6 (Group 4), as
  office scanners and fax servers hand pages over;
- ``page_lzw.tif``: RGB, LZW with horizontal differencing (Predictor 2);
- ``page.bmp``: bilevel, 1 bit per pixel;
- ``page.gif``: a 16-colour adaptive palette;

and ``format_pages.json``: each file's shape and bytes and the sha256 of
Pillow's ``convert("RGB")`` of it, with the Pillow and libtiff versions
that wrote and read them. Run it with Pillow installed:

    python tests/data/make_format_pages.py
"""

import hashlib
import io
import json
import pathlib

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


def main() -> None:
    meta = {"pillow": Image.__version__, "libtiff": features.version("libtiff"), "files": {}}
    for name, (image, options) in images(text_page()).items():
        buf = io.BytesIO()
        image.save(buf, **options)
        raw = buf.getvalue()
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
