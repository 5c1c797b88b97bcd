"""Pillow-exact bicubic resampling without Pillow.

``resize_bicubic`` is the main path's resize: the native C++ resampler
(dsocr_tpu_torch/native), as the reference resizes through its own
(dsocr_tpu/image/resample.py:28-41). ``resize_bicubic_numpy`` is its
NumPy twin, which the tests hold it against; nothing on the main path
calls it.

The twin runs the same 22-bit fixed-point algorithm as Pillow and the
reference's ``resize_bicubic_numpy`` (dsocr_tpu/image/resample.py:109-127):
support-2 bicubic with a = -0.5, bounds rounded half towards zero, per-row
weight normalization, ``(acc + 2^21) >> 22`` clipped to 8 bits.
Accumulation is integer, so the tap loop below (one [out, ...] slice per
tap instead of one [out, taps, ...] gather) gives bit-identical results
with a fraction of the memory.
"""

from __future__ import annotations

import numpy as np

from ..native import resize_bicubic_native

_PRECISION_BITS = 22
_PRECISION_SCALE = float(1 << _PRECISION_BITS)
_ROUNDING_BIAS = 1 << (_PRECISION_BITS - 1)


def resize_bicubic(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Resize RGB uint8 [H, W, 3] with Pillow's bicubic filter through the
    native resampler (built at first use; raises if it cannot be)."""
    if width <= 0 or height <= 0:
        return np.zeros((max(height, 0), max(width, 0), 3), dtype=np.uint8)
    return resize_bicubic_native(image, width, height)


def _bicubic_kernel(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    outer = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _compute_coeffs(input_size: int, output_size: int):
    """Per-output-pixel start index and int32 fixed-point tap weights."""
    scale = input_size / output_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1

    center = (np.arange(output_size, dtype=np.float64) + 0.5) * scale
    # Pillow computes bounds as the C cast (int)(value + 0.5): truncation
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), input_size)
    xmin = np.where(xmin >= input_size, max(input_size - 1, 0), xmin)
    xmax = np.where(xmax <= xmin, xmin + 1, xmax)
    length = xmax - xmin

    taps = np.arange(ksize, dtype=np.float64)
    ss = 1.0 / filterscale
    weights = _bicubic_kernel((xmin[:, None] + taps[None, :] - center[:, None] + 0.5) * ss)
    valid = taps[None, :] < length[:, None]
    weights = np.where(valid, weights, 0.0)
    sums = weights.sum(axis=1, keepdims=True)
    weights = np.where(sums != 0.0, weights / np.where(sums == 0.0, 1.0, sums), weights)
    scaled = weights * _PRECISION_SCALE
    coeffs = np.where(scaled < 0.0, scaled - 0.5, scaled + 0.5).astype(np.int32)
    return xmin, np.where(valid, coeffs, 0), ksize


def _resample_axis(data: np.ndarray, xmin, coeffs, ksize: int) -> np.ndarray:
    """Convolve the leading axis of [S, ...] uint8 data to len(xmin)."""
    acc = np.full((xmin.shape[0],) + data.shape[1:], _ROUNDING_BIAS, dtype=np.int64)
    extra = (1,) * (data.ndim - 1)
    for t in range(ksize):
        # taps past a pixel's length weigh 0, so clamping the index is safe
        idx = np.minimum(xmin + t, data.shape[0] - 1)
        acc += data[idx].astype(np.int64) * coeffs[:, t].astype(np.int64).reshape(-1, *extra)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_numpy(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Resize RGB uint8 [H, W, 3] with Pillow's bicubic filter."""
    if width <= 0 or height <= 0:
        return np.zeros((max(height, 0), max(width, 0), 3), dtype=np.uint8)
    src_h, src_w = image.shape[:2]
    xmin, coeffs_x, ksize_x = _compute_coeffs(src_w, width)
    ymin, coeffs_y, ksize_y = _compute_coeffs(src_h, height)
    horizontal = _resample_axis(np.transpose(image, (1, 0, 2)), xmin, coeffs_x, ksize_x)
    return np.ascontiguousarray(
        _resample_axis(np.transpose(horizontal, (1, 0, 2)), ymin, coeffs_y, ksize_y)
    )

