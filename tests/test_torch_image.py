"""The port's Pillow-free preprocessing is bit-exact with dsocr_tpu.image:
letterboxed global views and crop tiles on several aspect ratios."""

import numpy as np
import pytest

from dsocr_tpu import image as J
from dsocr_tpu_torch import image as T


@pytest.mark.parametrize("h,w", [(60, 60), (300, 200), (150, 700), (700, 300), (641, 1283)])
def test_global_view_and_tiles_bit_exact(h, w):
    img = np.random.default_rng(h * 7 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    for base in (64, 1024):
        view_t, box_t = T.build_global_view_with_box(img, base)
        view_j, box_j = J.build_global_view_with_box(img, base)
        assert box_t == box_j
        np.testing.assert_array_equal(view_t, view_j)
    got = T.dynamic_preprocess(img, T.PreprocessParams.ocr1(1024, 640))
    want = J.dynamic_preprocess(img, J.PreprocessParams.ocr1(1024, 640))
    assert got.ratio == want.ratio
    assert len(got.tiles) == len(want.tiles)
    for a, b in zip(got.tiles, want.tiles):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src,dst", [((37, 53), (64, 64)), ((120, 90), (17, 33))])
def test_resize_matches_numpy_spec(src, dst):
    """Up- and down-scaling against the reference's NumPy fixed-point spec."""
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        T.resize_bicubic_numpy(img, dst[1], dst[0]), J.resize_bicubic_numpy(img, dst[1], dst[0])
    )
