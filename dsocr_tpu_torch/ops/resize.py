"""Antialiased bicubic resize of position-embedding grids, with the math
of ``jax.image.resize(..., "bicubic", antialias=True)``.

The reference resizes SAM's position embedding (64 → 40 for 640 tiles)
and CLIP's grid (16 → 10) this way; ``F.interpolate`` uses other weights.
Here the [src, dst] weight matrix of ``jax.image.scale_and_translate``
(Keys cubic kernel, a = -0.5, widened by the downscale factor, columns
normalized to sum 1) is built once per size pair in NumPy f32 and applied
as two matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_weights(src: int, dst: int) -> np.ndarray:
    """[src, dst] f32 weights: out[o] = sum_i w[i, o] · in[i]."""
    inv_scale = np.float32(1.0 / (dst / src))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps, weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_grid(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[..., H, W, C] → [..., height, width, C] in f32."""
    wh = torch.from_numpy(resize_weights(x.shape[-3], height)).to(x.device)
    ww = torch.from_numpy(resize_weights(x.shape[-2], width)).to(x.device)
    out = torch.einsum("...hwc,hy->...ywc", x.float(), wh)
    return torch.einsum("...ywc,wx->...yxc", out, ww)
