"""The PNM, Zstandard TIFF and old-style JPEG TIFF page fixtures
(tests/data/make_pnm_pages.py): the committed ones (a P4 page, a
Zstandard TIFF page with Predictor 2) and the ones its numpy writers
build from committed fixtures (P6, 16-bit P5, plain P2, old-style JPEG
TIFF) decode to the pixels whose sha256 Pillow recorded in
pnm_pages.json."""

import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image

from dsocr_tpu_torch.image.decode import decode_image

DATA = pathlib.Path(__file__).resolve().parent / "data"
META = json.loads((DATA / "pnm_pages.json").read_text())
sys.path.insert(0, str(DATA))
from make_pnm_pages import built_pages  # noqa: E402  (tests/data is no package)


@pytest.mark.parametrize("name", sorted(META["files"]))
def test_committed_page_decodes_to_pillows_pixels(name):
    raw = (DATA / name).read_bytes()
    entry = META["files"][name]
    assert len(raw) == entry["bytes"]
    got = decode_image(raw)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")))


@pytest.fixture(scope="module")
def built():
    lzw = decode_image((DATA / "page_lzw.tif").read_bytes())
    return built_pages(lzw, (DATA / "page_baseline.jpg").read_bytes())


@pytest.mark.parametrize("name", sorted(META["built"]))
def test_built_page_decodes_to_pillows_pixels(built, name):
    raw, source = built[name]
    entry = META["built"][name]
    assert source == entry["source"] and len(raw) == entry["bytes"]
    got = decode_image(raw)
    assert got.flags.writeable and list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_fixtures_stay_small():
    """The committed pages ride in every checkout: under 1 MB together."""
    assert sum((DATA / name).stat().st_size for name in META["files"]) < 2 ** 20
