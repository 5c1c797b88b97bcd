"""Normalization ops with f32 reductions (dsocr_tpu/ops/norms.py)."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, f32 accumulation, cast back to x.dtype."""
    x32 = x.float()
    variance = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(variance + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last axis, f32 accumulation, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * (var + eps) ** -0.5 * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
