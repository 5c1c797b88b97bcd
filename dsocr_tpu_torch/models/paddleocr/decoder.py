"""PaddleOCR-VL's Ernie-4.5 decoder with 3-axis M-RoPE
(dsocr_tpu/models/paddleocr/decoder.py).

The shared GQA decoder (models/gqa_decoder.py: 16 query heads over 2 KV
heads of 128 at the published width, no q/k/v biases, the lm_head tied to
the embeddings in the published model; its modes ``forward``,
``prefill`` and ``slot_step``) under the multimodal rotary: per-axis
cos/sin tables sliced by the doubled mrope sections (``mrope_cos_sin``),
applied with rotate_half over the whole head. Positions are [3, B, S].

``compute_position_ids`` builds a row's M-RoPE positions on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...ops import rotate_half
from ..gqa_decoder import GqaDecoder
from .config import PaddleConfig


def mrope_cos_sin(position_ids: torch.Tensor, cfg: PaddleConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids [3, B, S] → (cos, sin) [B, S, head_dim] f32: each
    axis's rotary table, sliced by the doubled mrope sections (t, h, w,
    then t again for any rest)."""
    D = cfg.head_dim
    half = D // 2
    dev = position_ids.device
    inv_freq = 1.0 / (torch.tensor(cfg.rope_theta, dtype=torch.float32, device=dev)
                      ** (torch.arange(half, dtype=torch.float32, device=dev) / half))
    angles = position_ids.float()[..., None] * inv_freq
    full = torch.cat([angles, angles], dim=-1)  # [3, B, S, D]
    cos3, sin3 = torch.cos(full), torch.sin(full)
    offs = np.cumsum([0, *cfg.doubled_sections])

    def select(t3):
        return torch.cat([t3[axis % 3, ..., offs[axis] : offs[axis + 1]]
                          for axis in range(len(offs) - 1)], dim=-1)

    return select(cos3), select(sin3)


def _apply_mrope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D] rotated by cos/sin [B, S, D], in f32, cast back."""
    x32 = x.float()
    return (x32 * cos[:, None] + rotate_half(x32) * sin[:, None]).to(x.dtype)


def compute_position_ids(cfg: PaddleConfig, input_ids: Sequence[int],
                         image_grids: Sequence[Tuple[int, int, int]]) -> Tuple[np.ndarray, int]:
    """One row's 3-axis positions: a text span advances the three axes
    together, an image span of grid (t, h, w) takes (t, h, w) offsets of
    its merged grid from the span's base. → ([3, S] int32, delta), delta =
    max position + 1 − S (the next position base is S + delta)."""
    merge = cfg.vision_config.spatial_merge_size
    image_token_id = cfg.image_token_id
    ids = list(input_ids)
    S = len(ids)
    if not image_grids:
        pos = np.arange(S, dtype=np.int32)
        return np.stack([pos, pos, pos]), 0
    axes: List[List[int]] = [[], [], []]
    st, base = 0, 0
    grids = iter(image_grids)
    while st < S:
        try:
            ed = ids.index(image_token_id, st)
        except ValueError:
            ed = None
        text_end = S if ed is None else ed
        for i in range(text_end - st):
            for axis in axes:
                axis.append(base + i)
        if ed is None:
            break
        base += ed - st
        t, h, w = next(grids)
        llm_h, llm_w = h // merge, w // merge
        block = t * llm_h * llm_w
        if any(tok != image_token_id for tok in ids[ed : ed + block]):
            raise ValueError("non-image token inside placeholder span")
        for _ in range(t):
            for row in range(llm_h):
                for col in range(llm_w):
                    axes[0].append(base)
                    axes[1].append(base + row)
                    axes[2].append(base + col)
        base += block
        st = ed + block
    max_val = max(max(axis) for axis in axes)
    return np.asarray(axes, np.int32), int(max_val + 1 - S)


class ErnieDecoder(GqaDecoder):
    """``forward(embeds [B, S, H], position_ids [3, B, S], cache)``,
    ``prefill`` and ``slot_step``, over PaddleConfig."""

    def rope(self, position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mrope_cos_sin(position_ids, self.cfg)

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        return _apply_mrope(x, cos, sin)
