"""PaddleOCR-VL's mlp_AR projector (dsocr_tpu/models/paddleocr/projector.py):
pre-LayerNorm (eps 1e-5) → 2 × 2 spatial merge → linear → gelu-tanh →
linear to the decoder's hidden size. The linears accumulate in f32 with
their bias; the output is in the features' dtype."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ...ops import gelu_tanh, layer_norm
from ..deepseek.sam import Linear, Norm
from .config import PaddleConfig
from .vision import affine


def merge_reshape(features: torch.Tensor, grid: Tuple[int, int, int], merge: int) -> torch.Tensor:
    """[.., t·h·w, H] → [.., t·(h/m)·(w/m), H·m²]: each m × m patch block
    one row, its patches in row-major order."""
    t, h, w = grid
    lead, hidden = features.shape[:-2], features.shape[-1]
    x = features.reshape(*lead, t, h // merge, merge, w // merge, merge, hidden)
    x = x.transpose(-4, -3)
    return x.reshape(*lead, t * (h // merge) * (w // merge), hidden * merge * merge)


class PaddleProjector(nn.Module):
    """State names follow convert.params_from_jax of the reference's
    ``params["projector"]``."""

    def __init__(self, cfg: PaddleConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        v = cfg.vision_config
        merged = v.hidden_size * v.spatial_merge_size ** 2
        self.merge = v.spatial_merge_size
        self.pre_norm = Norm(v.hidden_size, dtype, device)
        self.linear_1 = Linear(merged, merged, dtype, device)
        self.linear_2 = Linear(merged, cfg.hidden_size, dtype, device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        self.pre_norm.reset_()
        self.linear_1.reset_(gen)
        self.linear_2.reset_(gen)

    def forward(self, features: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
        """[.., t·h·w, vision hidden] → [.., t·(h/m)·(w/m), hidden]."""
        normed = layer_norm(features, self.pre_norm.w, self.pre_norm.b, eps=1e-5)
        merged = merge_reshape(normed, grid, self.merge)
        h = gelu_tanh(affine(merged, self.linear_1)).to(features.dtype)
        return affine(h, self.linear_2).to(features.dtype)
