"""Dynamic crop tiling (dsocr_tpu/image/tiling.py): the (w, h) tile grid
whose aspect ratio best matches the image, exact ties broken towards the
larger grid when the image area exceeds half its pixel budget; OCR1
allows 2..=9 tiles; images no larger than a tile are not cropped."""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Tuple

import numpy as np

from .resample import resize_bicubic


@dataclasses.dataclass(frozen=True)
class PreprocessParams:
    tile_size: int
    base_size: int
    min_num: int
    max_num: int
    small_image_no_crop_threshold: Optional[int] = None

    @classmethod
    def ocr1(cls, base_size: int, tile_size: int) -> "PreprocessParams":
        return cls(tile_size, base_size, 2, 9, tile_size)


@dataclasses.dataclass
class DynamicPreprocessResult:
    tiles: List[np.ndarray]
    ratio: Tuple[int, int]  # (width_tiles, height_tiles)


def select_target_ratio(orig_width: int, orig_height: int, params: PreprocessParams) -> Tuple[int, int]:
    aspect_ratio = orig_width / orig_height
    ratios = sorted(
        {
            (i, j)
            for n in range(params.min_num, params.max_num + 1)
            for i in range(1, n + 1)
            for j in range(1, n + 1)
            if params.min_num <= i * j <= params.max_num
        }
    )
    best, best_diff = (1, 1), float("inf")
    area = float(orig_width * orig_height)
    for w_ratio, h_ratio in ratios:
        diff = abs(aspect_ratio - w_ratio / h_ratio)
        if diff < best_diff:
            best_diff, best = diff, (w_ratio, h_ratio)
        elif (
            abs(diff - best_diff) < sys.float_info.epsilon
            and area > 0.5 * params.tile_size * params.tile_size * w_ratio * h_ratio
        ):
            best = (w_ratio, h_ratio)
    return best


def dynamic_preprocess(image: np.ndarray, params: PreprocessParams) -> DynamicPreprocessResult:
    """Split RGB uint8 [H, W, 3] into aspect-matched tile crops (no
    thumbnail: the DeepSeek path never asks for one)."""
    orig_h, orig_w = image.shape[:2]
    threshold = params.small_image_no_crop_threshold
    if threshold is not None and orig_w <= threshold and orig_h <= threshold:
        return DynamicPreprocessResult(tiles=[], ratio=(1, 1))
    w_tiles, h_tiles = select_target_ratio(orig_w, orig_h, params)
    size = params.tile_size
    resized = resize_bicubic(image, size * w_tiles, size * h_tiles)
    tiles = [
        resized[(i // w_tiles) * size : (i // w_tiles + 1) * size,
                (i % w_tiles) * size : (i % w_tiles + 1) * size]
        for i in range(w_tiles * h_tiles)
    ]
    return DynamicPreprocessResult(tiles=tiles, ratio=(w_tiles, h_tiles))
