"""The TIFF, BMP and GIF page fixtures (tests/data/make_format_pages.py):
each decodes to the pixels whose sha256 Pillow recorded in
format_pages.json, and to Pillow's ``convert("RGB")`` of it here."""

import hashlib
import io
import json
import pathlib

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu_torch.image.decode import decode_image

DATA = pathlib.Path(__file__).resolve().parent / "data"
META = json.loads((DATA / "format_pages.json").read_text())


@pytest.mark.parametrize("name", sorted(META["files"]))
def test_page_fixture_decodes_to_pillows_pixels(name):
    raw = (DATA / name).read_bytes()
    entry = META["files"][name]
    assert len(raw) == entry["bytes"]
    got = decode_image(raw)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")))


def test_fixtures_stay_small():
    """The fixtures ride in every checkout: under 2 MB together."""
    assert sum((DATA / name).stat().st_size for name in META["files"]) < 2 * 2 ** 20
