"""Rotary position embeddings (dsocr_tpu/ops/rope.py): duplicated
half-frequency tables, rotate_half, and the DeepSeek-MLA even/odd
regroup before rotation."""

from __future__ import annotations

from typing import Tuple

import torch


def build_rope_tables(
    max_len: int, rope_dim: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_len, rope_dim] in f32, laid out as
    [cos(p·f_0..f_{d/2-1}), cos(p·f_0..f_{d/2-1})]."""
    assert rope_dim % 2 == 0, f"rope dimension must be even (got {rope_dim})"
    half = rope_dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=device) * 2.0 / rope_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponents)
    positions = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = positions[:, None] * inv_freq[None, :]
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def mla_interleave_regroup(x: torch.Tensor) -> torch.Tensor:
    """Read the last dim as interleaved (even, odd) pairs and regroup it
    to [evens..., odds...]."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def apply_rope(
    x: torch.Tensor,  # [..., seq, rope_dim]
    cos: torch.Tensor,  # broadcastable to x
    sin: torch.Tensor,
    interleaved: bool = False,
) -> torch.Tensor:
    """Rotary embedding in f32, cast back to x.dtype."""
    if interleaved:
        x = mla_interleave_regroup(x)
    x32 = x.float()
    out = x32 * cos.float() + rotate_half(x32) * sin.float()
    return out.to(x.dtype)


def partial_rope(x: torch.Tensor, cos, sin, rope_dim: int, use_mla: bool) -> torch.Tensor:
    """Rotate the first rope_dim dims and pass the tail through."""
    if rope_dim >= x.shape[-1]:
        return apply_rope(x, cos, sin, interleaved=use_mla)
    rot = apply_rope(x[..., :rope_dim], cos, sin, interleaved=use_mla)
    return torch.cat([rot, x[..., rope_dim:]], dim=-1)
