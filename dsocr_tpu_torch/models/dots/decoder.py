"""DotsOCR's Qwen2 decoder (dsocr_tpu/models/dots/decoder.py).

RMSNorm → grouped-query attention with q/k/v biases (12 query heads over
2 KV heads of 128 at the published width) and the plain 1D rotary at θ
1e6 → residual → RMSNorm → SwiGLU MLP → residual; final RMSNorm; f32
logits through the untied lm_head. The layers, the fused layout
(``fuse_qwen2_params``: qkv_proj + qkv_bias, gateup_proj), the packed
linears and the three modes (``forward`` over a contiguous KVCache with
``flash_prefill_attention`` for a prefill from an empty cache,
``prefill``, ``slot_step`` through ``slot_kv_write`` +
``slot_decode_attention``) are the shared GQA decoder's
(models/gqa_decoder.py); this one gives it the rotary: positions are
[B, S] token indices, and the (cos, sin) of a position are computed as
the reference's ``build_qwen2_rope`` table holds them
(``ops.rope.build_rope_tables``), without the table.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...ops.rope import apply_rope
from ..gqa_decoder import GqaDecoder, fuse_gqa_params

fuse_qwen2_params = fuse_gqa_params


def qwen2_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] → (cos, sin) [B, S, head_dim] f32, equal to rows
    of build_rope_tables(·, head_dim, theta) (the same f32 ops per
    position)."""
    half = head_dim // 2
    dev = positions.device
    exponents = torch.arange(half, dtype=torch.float32, device=dev) * 2.0 / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev), exponents)
    angles = positions.float()[..., None] * inv_freq
    return torch.cat([torch.cos(angles)] * 2, dim=-1), torch.cat([torch.sin(angles)] * 2, dim=-1)


class Qwen2Decoder(GqaDecoder):
    """``forward(embeds [B, S, H], positions [B, S], cache)``, ``prefill``
    and ``slot_step(embeds [B, 1, H], positions [B, 1], cache)`` over
    DotsTextConfig."""

    def rope(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return qwen2_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        return apply_rope(x, cos[:, None], sin[:, None])
