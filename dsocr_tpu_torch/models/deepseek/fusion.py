"""Vision fusion (dsocr_tpu/models/deepseek/fusion.py): drop CLIP's CLS
row, concat CLIP + flattened SAM per token, linear projector; the global
view forms a √S×√S grid with a learned ``image_newline`` after each row,
crop tiles are re-tiled into one big grid with per-row newlines, and a
learned ``view_seperator`` ends the image."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from .config import DeepseekOcrConfig
from .sam import normal_, param


class Projector(nn.Module):
    def __init__(self, cfg: DeepseekOcrConfig, dtype=torch.float32, device=None):
        super().__init__()
        n, i = cfg.projector_n_embed, cfg.projector_input_dim
        self.weight = param(i, n, dtype=dtype, device=device)
        self.bias = param(n, dtype=dtype, device=device)
        self.image_newline = param(n, dtype=dtype, device=device)
        self.view_seperator = param(n, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        normal_(self.weight, self.weight.shape[0] ** -0.5, gen)
        self.bias.zero_()
        normal_(self.image_newline, 0.02, gen)
        normal_(self.view_seperator, 0.02, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """f32 projection of the fused tokens [..., input_dim]."""
        return torch.matmul(tokens.float(), self.weight.float()) + self.bias.float()


def build_clip_sam_tokens(clip_out: torch.Tensor, sam_out: torch.Tensor) -> torch.Tensor:
    """clip [B, 1+S, Hc] (CLS dropped) ++ sam [B, Cs, h, w] → [B, S, Hc+Cs] f32."""
    b = clip_out.shape[0]
    cs, h, w = sam_out.shape[1:]
    sam_tokens = sam_out.reshape(b, cs, h * w).transpose(1, 2)
    return torch.cat([clip_out[:, 1:].float(), sam_tokens.float()], dim=-1)


def append_row_breaks(grid: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """[rows, cols, H] → [rows*(cols+1), H] with a newline after each row."""
    rows, cols, hidden = grid.shape
    nl = newline.to(grid.dtype)[None, None].expand(rows, 1, hidden)
    return torch.cat([grid, nl], dim=1).reshape(rows * (cols + 1), hidden)


def format_global_tokens(projected: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """[1, S, H] (S a perfect square) → grid + per-row newlines."""
    s, hidden = projected.shape[1:]
    side = int(round(s ** 0.5))
    assert side * side == s, f"global token count {s} is not a perfect square"
    return append_row_breaks(projected[0].reshape(side, side, hidden), newline)


def format_local_tokens(
    projected: torch.Tensor,  # [tiles, S, H]
    crop_shape: Tuple[int, int],  # (width_crops, height_crops)
    newline: torch.Tensor,
) -> torch.Tensor:
    s, hidden = projected.shape[1:]
    width_crops, height_crops = crop_shape
    side = int(round(s ** 0.5))
    grid = projected.reshape(height_crops, width_crops, side, side, hidden)
    grid = grid.permute(0, 2, 1, 3, 4).reshape(height_crops * side, width_crops * side, hidden)
    return append_row_breaks(grid, newline)


def assemble_image_tokens(
    projector: Projector, global_tokens: torch.Tensor, local_tokens: Optional[torch.Tensor]
) -> torch.Tensor:
    """[local?, global, view_seperator]."""
    segments = [] if local_tokens is None else [local_tokens]
    segments.append(global_tokens)
    segments.append(projector.view_seperator.to(global_tokens.dtype)[None, :])
    return torch.cat(segments, dim=0)


def build_image_placeholders(
    image_token_id: int,
    crop_shape: Optional[Tuple[int, int]],
    base_size: int,
    image_size: int,
    crop_mode: bool,
) -> List[int]:
    """Host-side OCR1 placeholder layout: PATCH = 16, DOWNSAMPLE = 4; grids
    carry +1 per row (the newline) and the global grid a trailing +1 (the
    view separator)."""
    patch, down = 16, 4
    out: List[int] = []

    def grid_with_breaks(rows, cols):
        out.extend([image_token_id] * (rows * (cols + 1)))

    if crop_mode:
        nq_global = math.ceil((base_size // patch) / down)
        nq_local = math.ceil((image_size // patch) / down)
        width_crops, height_crops = crop_shape or (1, 1)
        if width_crops > 1 or height_crops > 1:
            grid_with_breaks(nq_local * height_crops, nq_local * width_crops)
        grid_with_breaks(nq_global, nq_global)
    else:
        nq = math.ceil((image_size // patch) / down)
        grid_with_breaks(nq, nq)
    out.append(image_token_id)
    return out
