"""The port's smart-resize and patchify (dsocr_tpu_torch/image/smart_resize.py)
bit-equal to the reference's (dsocr_tpu/image/smart_resize.py): target
sizes, raw and normalized patches, grid_thw, position/height/width ids
and the normalization table, over the seeded 1756 × 2852 page, sizes
under min_pixels and over max_pixels, extreme aspect ratios (and the
200:1 limit raising), ``with_max_image_size`` and seeded random sizes."""

import dataclasses
import importlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
# the packages' __init__ re-export the function under the module's name
ref = importlib.import_module("dsocr_tpu.image.smart_resize")
port = importlib.import_module("dsocr_tpu_torch.image.smart_resize")

SIZES = [(1756, 2852), (20, 30), (300, 200), (2000, 3000), (28, 5000), (4000, 30), (57, 57), (1, 1), (14, 14)]


def _image(h, w, seed=0):
    return np.random.default_rng(seed + h * 7 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same(a, b):
    assert a.grid_thw == b.grid_thw and (a.height, a.width) == (b.height, b.width)
    assert a.patches.dtype == b.patches.dtype and np.array_equal(a.patches, b.patches)
    for name in ("position_ids", "height_ids", "width_ids"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("image_size", [0, 640, 1024, 2048])
@pytest.mark.parametrize("size", SIZES)
def test_smart_resize_equals_reference(size, image_size):
    cfg, ref_cfg = port.SmartResizeConfig(), ref.SmartResizeConfig()
    cfg, ref_cfg = cfg.with_max_image_size(image_size), ref_cfg.with_max_image_size(image_size)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    args = (*size, cfg.factor, cfg.min_pixels, cfg.max_pixels)
    assert port.smart_resize(*args) == ref.smart_resize(*args)


@pytest.mark.parametrize("image_size", [0, 640])
@pytest.mark.parametrize("size", [(1756, 2852), (20, 30), (300, 200), (28, 600), (90, 40)])
def test_patches_equal_reference(size, image_size):
    image = chip_smoke.seeded_page()[0] if size == (1756, 2852) else _image(*size)
    cfg = port.SmartResizeConfig().with_max_image_size(image_size)
    ref_cfg = ref.SmartResizeConfig().with_max_image_size(image_size)
    _same(port.preprocess_patches_raw(image, cfg), ref.preprocess_patches_raw(image, ref_cfg))
    _same(port.preprocess_patches(image, cfg), ref.preprocess_patches(image, ref_cfg))
    assert np.array_equal(port.norm_table(cfg), ref.norm_table(ref_cfg))


def test_temporal_patch_size_stays_clamped():
    assert port.SmartResizeConfig().temporal_patch_size == 1
    image = _image(60, 70)
    cfg = dataclasses.replace(port.SmartResizeConfig(min_pixels=1), temporal_patch_size=2)
    ref_cfg = dataclasses.replace(ref.SmartResizeConfig(min_pixels=1), temporal_patch_size=2)
    _same(port.preprocess_patches_raw(image, cfg), ref.preprocess_patches_raw(image, ref_cfg))


def test_aspect_limit_and_tiny_factor_raise_alike():
    for args in ((28, 6000, 28), (10, 3000, 28)):
        with pytest.raises(ValueError, match="aspect"):
            ref.smart_resize(*args)
        with pytest.raises(ValueError, match="aspect"):
            port.smart_resize(*args)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 3000), w=st.integers(1, 3000), image_size=st.sampled_from([0, 384, 1024]))
def test_smart_resize_sizes_hypothesis(h, w, image_size):
    cfg = port.SmartResizeConfig().with_max_image_size(image_size)
    args = (h, w, cfg.factor, cfg.min_pixels, cfg.max_pixels)
    try:
        want = ref.smart_resize(*args)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)[:10]):
            port.smart_resize(*args)
        return
    assert port.smart_resize(*args) == want


@settings(max_examples=8, deadline=None)
@given(h=st.integers(20, 400), w=st.integers(20, 400), seed=st.integers(0, 1000))
def test_patches_hypothesis(h, w, seed):
    image = _image(h, w, seed)
    cfg = port.SmartResizeConfig(min_pixels=28 * 28, max_pixels=200 * 200)
    ref_cfg = ref.SmartResizeConfig(min_pixels=28 * 28, max_pixels=200 * 200)
    _same(port.preprocess_patches_raw(image, cfg), ref.preprocess_patches_raw(image, ref_cfg))
