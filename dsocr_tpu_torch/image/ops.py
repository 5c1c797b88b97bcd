"""Global-view letterboxing (dsocr_tpu/image/ops.py): mean-gray canvas,
ties-to-even scaled dimensions and centering offsets."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .resample import resize_bicubic


def round_ties_to_even(value: float) -> float:
    """Round half to even (banker's rounding)."""
    rounded = np.floor(value + 0.5) if value >= 0 else np.ceil(value - 0.5)
    if abs(value - rounded) != 0.5:
        return float(rounded)
    truncated = float(np.trunc(value))
    if int(truncated) % 2 == 0:
        return truncated
    return truncated + float(np.sign(value) if value != 0 else 1.0)


def build_global_view_with_box(
    image: np.ndarray, base_size: int
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Letterbox RGB uint8 [H, W, 3] onto a mean-gray base_size² canvas;
    also returns the constant-127 margins (top, bottom, left, right)."""
    mean = int(0.5 * 255.0)  # 127
    canvas = np.full((base_size, base_size, 3), mean, dtype=np.uint8)
    if image.size == 0 or image.shape[0] == 0 or image.shape[1] == 0:
        return canvas, (0, 0, 0, 0)
    orig_h, orig_w = image.shape[:2]
    scale = min(base_size / orig_w, base_size / orig_h)
    new_w = int(min(max(round_ties_to_even(orig_w * scale), 1.0), float(base_size)))
    new_h = int(min(max(round_ties_to_even(orig_h * scale), 1.0), float(base_size)))
    resized = resize_bicubic(image, new_w, new_h)
    x_off = int(round_ties_to_even((base_size - new_w) * 0.5))
    y_off = int(round_ties_to_even((base_size - new_h) * 0.5))
    canvas[y_off : y_off + new_h, x_off : x_off + new_w] = resized
    return canvas, (y_off, base_size - new_h - y_off, x_off, base_size - new_w - x_off)
