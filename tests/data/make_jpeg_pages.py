"""Writes the JPEG page fixtures beside this file: a seeded document-like
page (dark glyph-sized boxes in lines of text, a photo region) at the
benchmark page's 1756 × 2852, saved by Pillow twice,

- ``page_baseline.jpg``: baseline, 4:2:0, quality 90;
- ``page_progressive.jpg``: progressive, 4:4:4, quality 85, a restart
  marker every MCU row;

and ``jpeg_pages.json``: each file's shape and bytes and the sha256 of
Pillow's ``convert("RGB")`` of it, with the Pillow and libjpeg-turbo
versions that wrote and read them. Run it with Pillow installed:

    python tests/data/make_jpeg_pages.py
"""

import hashlib
import io
import json
import pathlib

import numpy as np
from PIL import Image, features

HERE = pathlib.Path(__file__).resolve().parent
HEIGHT, WIDTH = 1756, 2852
FILES = {
    "page_baseline.jpg": {"quality": 90, "subsampling": 2},
    "page_progressive.jpg": {"quality": 85, "subsampling": 0, "progressive": True, "restart_marker_rows": 1},
}


def document_page(seed: int = 0) -> np.ndarray:
    """A paper-white page with lines of dark glyph boxes and a photo."""
    rng = np.random.default_rng(seed)
    page = np.full((HEIGHT, WIDTH, 3), 246, np.uint8)
    photo = (1000, 1700, 180, 1300)  # rows, then columns
    for top in range(120, HEIGHT - 120, 44):
        x = 160
        right = WIDTH - 160
        while x < right - 30:
            if photo[0] - 40 <= top <= photo[1] and x < photo[3] + 40:
                x = photo[3] + 80
                continue
            for _ in range(int(rng.integers(2, 11))):  # a word
                w = int(rng.integers(9, 19))
                h = int(rng.integers(14, 24))
                ink = rng.integers(10, 60, 3).astype(np.uint8)
                page[top + 24 - h:top + 24, x:x + w] = ink
                x += w + int(rng.integers(2, 5))
                if x >= right - 30:
                    break
            x += int(rng.integers(14, 26))
    y0, y1, x0, x1 = photo
    yy, xx = np.mgrid[0:y1 - y0, 0:x1 - x0].astype(np.float32)
    sky = np.stack([90 + 0.1 * yy, 140 + 0.05 * xx, 220 - 0.08 * yy], axis=-1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, y1 - y0), rng.uniform(0, x1 - x0), rng.uniform(40, 200)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        sky = sky * (1 - blob) + rng.uniform(0, 255, 3) * blob
    sky += rng.normal(0, 3, sky.shape)
    page[y0:y1, x0:x1] = np.clip(sky, 0, 255).astype(np.uint8)
    return page


def main() -> None:
    page = document_page()
    meta = {"pillow": Image.__version__, "libjpeg_turbo": features.version_feature("libjpeg_turbo"), "files": {}}
    for name, options in FILES.items():
        buf = io.BytesIO()
        Image.fromarray(page).save(buf, format="JPEG", **options)
        raw = buf.getvalue()
        (HERE / name).write_bytes(raw)
        rgb = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        meta["files"][name] = {"options": options, "bytes": len(raw), "shape": list(rgb.shape),
                               "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "jpeg_pages.json").write_text(json.dumps(meta, indent=1) + "\n")


if __name__ == "__main__":
    main()
