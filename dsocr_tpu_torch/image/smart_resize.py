"""Qwen2-VL-style smart resize and patchify for PaddleOCR-VL
(dsocr_tpu/image/smart_resize.py, bit-exact with it): resize to a pixel
budget on multiples of patch_size·merge_size through the native
Pillow-exact resampler (image/resample.py), normalize per channel,
patchify into [T·Hp·Wp, 3, patch, patch] in (gh, gw, c, py, px) order with
position, height and width ids.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .resample import resize_bicubic

DEFAULT_MIN_PIXELS = 147_384
DEFAULT_MAX_PIXELS = 2_822_400
DEFAULT_IMAGE_MEAN = (0.5, 0.5, 0.5)
DEFAULT_IMAGE_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass
class SmartResizeConfig:
    patch_size: int = 14
    merge_size: int = 2
    # The official PaddleOCR-VL processor keeps temporal_patch_size=1 for
    # single images despite the exported config saying 2 (ref
    # preprocess.rs:27-41); parity requires the clamp.
    temporal_patch_size: int = 1
    min_pixels: int = DEFAULT_MIN_PIXELS
    max_pixels: int = DEFAULT_MAX_PIXELS
    image_mean: Tuple[float, float, float] = DEFAULT_IMAGE_MEAN
    image_std: Tuple[float, float, float] = DEFAULT_IMAGE_STD
    rescale_factor: float = 1.0 / 255.0

    @property
    def factor(self) -> int:
        return self.patch_size * self.merge_size

    def with_max_image_size(self, image_size: int) -> "SmartResizeConfig":
        if image_size > 0:
            max_pixels = max(image_size * image_size, self.min_pixels)
            return dataclasses.replace(
                self, max_pixels=min(self.max_pixels, max_pixels)
            )
        return self


@dataclasses.dataclass
class ImagePatches:
    patches: np.ndarray  # [T*Hp*Wp, 3, patch, patch] f32 (uint8 from _raw)
    grid_thw: Tuple[int, int, int]
    height: int
    width: int
    position_ids: np.ndarray  # [N] int64, row-major within each frame
    height_ids: np.ndarray  # [N] int64
    width_ids: np.ndarray  # [N] int64


def smart_resize(
    height: int,
    width: int,
    factor: int,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[int, int]:
    """Target (height, width) on multiples of `factor` within the pixel
    budget, preserving aspect ratio (HF Qwen2-VL semantics)."""
    factor = max(factor, 1)
    h = float(max(height, 1))
    w = float(max(width, 1))
    if h < factor:
        w = np.round((w * factor) / h)
        h = float(factor)
    if w < factor:
        h = np.round((h * factor) / w)
        w = float(factor)
    aspect = max(h, w) / min(h, w)
    if aspect > 200.0:
        raise ValueError(f"aspect ratio exceeds limit ({aspect})")
    h_bar = np.round(h / factor) * factor
    w_bar = np.round(w / factor) * factor
    area = h_bar * w_bar
    max_pixels = float(max(max_pixels, 1))
    min_pixels = float(max(min_pixels, 1))
    if area > max_pixels:
        beta = np.sqrt((h * w) / max_pixels)
        h_bar = np.floor((h / beta) / factor) * factor
        w_bar = np.floor((w / beta) / factor) * factor
    elif area < min_pixels:
        beta = np.sqrt(min_pixels / (h * w))
        h_bar = np.ceil((h * beta) / factor) * factor
        w_bar = np.ceil((w * beta) / factor) * factor
    if h_bar < factor or w_bar < factor:
        raise ValueError("resized dimensions smaller than factor")
    return int(h_bar), int(w_bar)


def norm_table(config: SmartResizeConfig) -> np.ndarray:
    """[3, 256] f32 per-channel normalization lookup: entry [c, v] is
    exactly ``(v f32 * rescale - mean[c]) / std[c]`` — the same per-value
    f32 ops preprocess_patches applies to the whole image, so a LUT
    lookup (host OR device) is bit-exact vs normalizing the image. Lets
    serving ship RAW uint8 patches (4x fewer bytes over a slow
    host↔device link) and normalize on device."""
    mean = np.asarray(config.image_mean, dtype=np.float32)
    std = np.asarray(config.image_std, dtype=np.float32)
    v = np.arange(256, dtype=np.float32) * config.rescale_factor
    return (v[None, :].astype(np.float32) - mean[:, None]) / std[:, None]


def preprocess_patches_raw(
    image: np.ndarray, config: SmartResizeConfig
) -> ImagePatches:
    """Like preprocess_patches but `patches` stays RAW uint8 (pre-
    normalization); combine with norm_table for the exact f32 values."""
    return _preprocess_patches(image, config, raw=True)


def preprocess_patches(image: np.ndarray, config: SmartResizeConfig) -> ImagePatches:
    """RGB uint8 [H, W, 3] → normalized patch stack + grid metadata."""
    return _preprocess_patches(image, config, raw=False)


def _preprocess_patches(
    image: np.ndarray, config: SmartResizeConfig, raw: bool
) -> ImagePatches:
    orig_h, orig_w = image.shape[:2]
    resized_h, resized_w = smart_resize(
        orig_h, orig_w, config.factor, config.min_pixels, config.max_pixels
    )
    if (orig_h, orig_w) != (resized_h, resized_w):
        image = resize_bicubic(image, resized_w, resized_h)

    if raw:
        normalized = image  # uint8; LUT normalization happens later
    else:
        table = norm_table(config)
        normalized = table[
            np.arange(3)[None, None, :], image.astype(np.int64)
        ]  # == (image f32 * rescale - mean) / std, per-value exact

    patch = config.patch_size
    if resized_h % patch or resized_w % patch:
        raise ValueError(
            f"resized dimensions ({resized_h}, {resized_w}) not divisible by "
            f"patch size {patch}"
        )
    grid_h = resized_h // patch
    grid_w = resized_w // patch
    grid_t = max(config.temporal_patch_size, 1)

    # [H, W, 3] → [gh, p, gw, p, 3] → [gh, gw, 3, p, p] → [gh*gw, 3, p, p]
    patches = normalized.reshape(grid_h, patch, grid_w, patch, 3)
    patches = patches.transpose(0, 2, 4, 1, 3).reshape(grid_h * grid_w, 3, patch, patch)
    if grid_t > 1:
        patches = np.tile(patches, (grid_t, 1, 1, 1))

    rows = np.repeat(np.arange(grid_h, dtype=np.int64), grid_w)
    cols = np.tile(np.arange(grid_w, dtype=np.int64), grid_h)
    position_ids = np.tile(rows * grid_w + cols, grid_t)
    height_ids = np.tile(rows, grid_t)
    width_ids = np.tile(cols, grid_t)

    return ImagePatches(
        patches=patches,
        grid_thw=(grid_t, grid_h, grid_w),
        height=resized_h,
        width=resized_w,
        position_ids=position_ids,
        height_ids=height_ids,
        width_ids=width_ids,
    )
