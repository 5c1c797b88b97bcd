"""The port's native resampler (dsocr_tpu_torch/native): bit-exact with its
NumPy twin and with the reference's resize_bicubic (its native library,
or Pillow) at down- and up-scaling, 1-pixel, identity and odd sizes and
at the seeded page's letterbox and tile sizes; the fused normalize
against the composed one; the main path's prep resizing only through it;
a cold build shared by processes that start at once; a failed build
raising."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsocr_tpu import image as J
from dsocr_tpu_torch import image as T
from dsocr_tpu_torch.image import resample as T_resample
from dsocr_tpu_torch.native import resample as N

REPO = pathlib.Path(__file__).resolve().parents[1]

# (source H, W) → (output H, W)
SIZES = [
    ((64, 48), (32, 32)),  # down
    ((16, 16), (64, 40)),  # up
    ((37, 53), (128, 96)),  # up, odd source
    ((50, 70), (1, 1)),  # 1-pixel output
    ((50, 70), (1, 33)),
    ((50, 70), (29, 1)),
    ((1, 1), (5, 7)),  # 1-pixel source
    ((33, 47), (33, 47)),  # identity
    ((101, 77), (51, 39)),  # odd widths, down
    ((99, 13), (201, 27)),  # odd widths, up
    ((640, 300), (17, 1001)),  # down one axis, up the other
]


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", SIZES)
def test_native_resize_bit_exact(src, dst):
    img = _img(*src, seed=src[0] * 131 + dst[1])
    got = T.resize_bicubic(img, dst[1], dst[0])
    assert got.shape == (*dst, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, T.resize_bicubic_numpy(img, dst[1], dst[0]))
    np.testing.assert_array_equal(got, J.resize_bicubic(img, dst[1], dst[0]))


def _page():
    """chip_smoke.py's seeded page (the size of the reference's sample)."""
    return _img(1756, 2852, seed=0)


@pytest.mark.parametrize("view", ["letterbox_1024", "tiles_640"])
def test_native_resize_bit_exact_at_the_page_sizes(view):
    page = _page()
    h, w = page.shape[:2]
    if view == "letterbox_1024":
        scale = min(1024 / w, 1024 / h)
        size = (int(T.round_ties_to_even(w * scale)), int(T.round_ties_to_even(h * scale)))
    else:
        wt, ht = T.select_target_ratio(w, h, T.PreprocessParams.ocr1(1024, 640))
        size = (640 * wt, 640 * ht)
    got = T.resize_bicubic(page, *size)
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, T.resize_bicubic_numpy(page, *size))
    np.testing.assert_array_equal(got, J.resize_bicubic(page, *size))


@pytest.mark.parametrize("w,h", [(0, 5), (5, 0), (-3, 4), (0, 0)])
def test_empty_sizes_match_the_reference(w, h):
    img = _img(8, 8, seed=1)
    got = T.resize_bicubic(img, w, h)
    want = J.resize_bicubic(img, w, h)
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("src,dst", [((50, 70), (48, 64)), ((8, 8), (8, 8)), ((91, 33), (20, 45))])
def test_fused_normalize_matches_composed(src, dst):
    img = _img(*src, seed=src[0] + dst[0])
    mean, std = (0.48, 0.46, 0.41), (0.27, 0.26, 0.28)
    fused = N.resize_normalize_chw_native(img, dst[1], dst[0], mean, std)
    resized = T.resize_bicubic_numpy(img, dst[1], dst[0])
    composed = (np.transpose(resized, (2, 0, 1)).astype(np.float32) / 255.0
                - np.asarray(mean, np.float32)[:, None, None]) / np.asarray(std, np.float32)[:, None, None]
    assert fused.shape == (3, *dst) and fused.dtype == np.float32
    np.testing.assert_allclose(fused, composed, rtol=1e-5, atol=1e-6)


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        N.resize_bicubic_native(np.zeros((0, 4, 3), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        N.resize_bicubic_native(np.zeros((4, 4), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        N.resize_bicubic_native(np.zeros((4, 4, 3), np.uint8), 0, 2)


def test_main_path_prep_resizes_only_natively(monkeypatch):
    """prepare_vision_input (global view and crop tiles) resizes through
    the native library, never through the NumPy twin."""
    from dsocr_tpu_torch.core import VisionSettings
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config

    calls = []
    native = T_resample.resize_bicubic_native

    def counting(image, width, height):
        calls.append((width, height))
        return native(image, width, height)

    def twin(*args, **kw):
        raise AssertionError("the main path called the NumPy twin")

    monkeypatch.setattr(T_resample, "resize_bicubic_native", counting)
    monkeypatch.setattr(T_resample, "resize_bicubic_numpy", twin)
    engine = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu",
                               max_seq_len=256, seed=0)
    img = _img(150, 700, seed=5)
    vin = engine.prepare_vision_input(img, VisionSettings(64, 32, True))
    assert vin.patches is not None and len(calls) == 2  # the global view, then the tiles
    want = J.build_global_view_with_box(img, 64)[0]
    np.testing.assert_array_equal(vin.global_pixels[0], np.transpose(want, (2, 0, 1)))


_BUILD_AND_RESIZE = """
import sys, numpy as np
sys.path.insert(0, {repo!r})
from dsocr_tpu_torch.native import resample as N
img = np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)
out = N.resize_bicubic_native(img, 33, 41)
print(N.library_path().name, int(out.astype(np.int64).sum()))
"""


def test_cold_build_shared_by_concurrent_processes(tmp_path):
    """Four processes that start together on an empty build directory wait
    for one g++ build and each loads a whole library."""
    build = tmp_path / "build"
    code = _BUILD_AND_RESIZE.format(repo=str(REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DSOCR_NATIVE_CACHE"] = str(build)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(4)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(out.strip().splitlines()[-1])
    want = T.resize_bicubic_numpy(np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8),
                                  33, 41)
    assert set(outs) == {f"{N.library_path().name} {int(want.astype(np.int64).sum())}"}
    libs = sorted(p.name for p in build.iterdir() if p.suffix == ".so")
    assert libs == [N.library_path().name]  # one library, no half-written temporaries


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "resample.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(N, "SOURCE", bad)
    monkeypatch.setenv("DSOCR_NATIVE_CACHE", str(tmp_path / "build"))
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.resize_bicubic_native(_img(4, 4, seed=0), 2, 2)
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix == ".so"]
