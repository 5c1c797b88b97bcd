"""GLM-OCR's text decoder (dsocr_tpu/models/glm/decoder.py).

Sandwich norms: input_layernorm → attention → post_self_attn_layernorm
of its output → residual → post_attention_layernorm → SwiGLU over the
fused gate_up_proj → post_mlp_layernorm of its output → residual; final
RMSNorm; f32 logits through the tied embeddings. Attention is grouped
(16 query heads over 8 KV heads of 128 at the published width, so NH·D
2,048 ≠ hidden 1,024) with q/k/v biases and the partial interleaved
M-RoPE: each of the rope_dim / 2 frequency slots takes its position from
the axis its ``mrope_section`` names (t, h, w), the frequencies are
interleaved pairwise ([f0, f0, f1, f1, …], ``glm_mrope_cos_sin``), and
rotate_half applies them to the first rope_dim = head_dim ·
partial_rotary_factor dims only, the rest passing through. That is not
the PaddleOCR-VL layout (contiguous sections of the duplicated halves
over the whole head).

The decoder is the shared GQA one (models/gqa_decoder.py: the modes
``forward``, ``prefill`` through ``flash_prefill_attention`` and
``slot_step`` through ``slot_kv_write`` + ``slot_decode_attention``) with
these layers and this rotary, q/k/v fused into qkv_proj / qkv_bias
(``fuse_glm_params``; gate_up_proj becomes the shared gateup_proj). The
q/k/v projection adds its bias in f32 before the one rounding to the
model dtype, as the reference's ``_proj`` does: its weight and bias are
held in f32 (the model dtype's values; 0.4 GB at the published width
against 0.2 in bf16), so its product sums the exact bf16 products in f32
with no cast a step. The other projections round once, without a bias.

``compute_glm_position_ids`` builds a row's 3-axis positions on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...ops import project, rms_norm, rotate_half, silu
from ..deepseek.sam import param
from ..gqa_decoder import GqaDecoder, GqaLayer, fuse_gqa_params


def fuse_glm_params(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """q/k/v (+ biases) → qkv_proj / qkv_bias, and gate_up_proj renamed
    gateup_proj; a fused state passes through."""
    renamed = {(k[: -len("gate_up_proj")] + "gateup_proj" if k.endswith(".gate_up_proj") else k): v
               for k, v in state.items()}
    return fuse_gqa_params(renamed)


def glm_mrope_cos_sin(position_ids: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids [3, B, S] → (cos, sin) [B, S, rope_dim] f32: slot i's
    axis by the sections, frequencies interleaved pairwise."""
    rope_dim = cfg.rope_dim
    half = rope_dim // 2
    if sum(cfg.mrope_section) != half:
        raise ValueError(f"mrope sections {cfg.mrope_section} must sum to the rope half dim {half}")
    dev = position_ids.device
    inv_freq = 1.0 / (torch.tensor(cfg.rope_theta, dtype=torch.float32, device=dev)
                      ** ((2 * torch.arange(half, dtype=torch.float32, device=dev)) / rope_dim))
    axis_of_slot = torch.from_numpy(np.concatenate(
        [np.full(width, idx % 3) for idx, width in enumerate(cfg.mrope_section)])).to(dev)
    freqs = position_ids.float()[axis_of_slot].movedim(0, -1) * inv_freq  # [B, S, half]
    interleaved = freqs.repeat_interleave(2, dim=-1)
    return torch.cos(interleaved), torch.sin(interleaved)


def apply_partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]: its first rope_dim dims rotated by cos/sin [B, S,
    rope_dim] in f32, the rest passed through, cast back."""
    rope_dim = cos.shape[-1]
    x32 = x.float()
    rot = x32[..., :rope_dim]
    rot = rot * cos[:, None] + rotate_half(rot) * sin[:, None]
    return torch.cat([rot, x32[..., rope_dim:]], dim=-1).to(x.dtype)


class GlmLayer(GqaLayer):
    """The shared layer's weights in the fused layout, q/k/v and their
    bias in f32, with the two sandwich norms."""

    def __init__(self, cfg, dtype, device, quantize, split):
        if quantize or split:
            raise ValueError("the GLM decoder is float and fused")
        super().__init__(cfg, dtype, device, None, False)
        self.qkv_proj = param(*self.qkv_proj.shape, device=device)
        if cfg.attention_bias:
            self.qkv_bias = param(*self.qkv_bias.shape, device=device)
        self.post_self_attn_layernorm = param(cfg.hidden_size, dtype=dtype, device=device)
        self.post_mlp_layernorm = param(cfg.hidden_size, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        super().reset_(gen)
        self.qkv_proj.copy_(self.qkv_proj.to(self.input_layernorm.dtype))  # the model dtype's values
        self.post_self_attn_layernorm.fill_(1.0)
        self.post_mlp_layernorm.fill_(1.0)


class GlmDecoder(GqaDecoder):
    """``forward(embeds [B, S, H], position_ids [3, B, S], cache)``,
    ``prefill`` and ``slot_step``, over GlmTextConfig, in the fused
    layout."""

    LAYER = GlmLayer

    def _qkv(self, x, layer, cos, sin, share=None):
        cfg = self.cfg
        NH, NKV, D = cfg.num_attention_heads, self.n_kv, cfg.head_dim
        normed = rms_norm(x, layer.input_layernorm, cfg.rms_norm_eps).float()
        # every head's product rounded once, then the share's heads sliced
        qkv = project(normed, layer.qkv_proj, getattr(layer, "qkv_bias", None)).to(x.dtype)
        q, k, v = torch.split(qkv, [NH * D, NKV * D, NKV * D], dim=-1)
        return self._split_heads(q, k, v, share, cos, sin, apply_partial_rope)

    def _layers(self, x, position_ids, attend, share=None):
        cos, sin = glm_mrope_cos_sin(position_ids, self.cfg)
        eps = self.cfg.rms_norm_eps
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(x, layer, cos, sin, share)
            attn = rms_norm(project(self._attend(li, q, k, v, attend, share), layer.o_proj),
                            layer.post_self_attn_layernorm, eps)
            x = (x.float() + attn.float()).to(x.dtype)
            normed = rms_norm(x, layer.post_attention_layernorm, eps)
            gate, up = torch.chunk(project(normed, layer.gateup_proj).float(), 2, dim=-1)
            mlp = rms_norm(project((silu(gate) * up).to(x.dtype), layer.down_proj), layer.post_mlp_layernorm, eps)
            x = (x.float() + mlp.float()).to(x.dtype)
        return x


def compute_glm_position_ids(image_token_id: int, video_start_id: int, video_end_id: int,
                             input_ids: Sequence[int], image_grids: Sequence[Tuple[int, int, int]],
                             merge: int) -> Tuple[np.ndarray, int]:
    """Token-type grouped 3-axis positions → ([3, S] int32, next position
    base). Each run of one type starts at the largest position so far + 1:
    a text run advances the three axes together, an image run of grid (t,
    h, w) takes (t, h, w) offsets of its merged grid. Image tokens inside
    a video span count as video and advance like text."""
    types: List[str] = []
    in_video = False
    for tok in input_ids:
        if tok == video_start_id:
            in_video = True
        elif tok == video_end_id:
            in_video = False
        if tok == image_token_id:
            types.append("video" if in_video else "image")
        else:
            types.append("text")
    axes: List[List[int]] = [[], [], []]
    max_position = -1
    image_index = start = 0
    while start < len(types):
        kind = types[start]
        end = start + 1
        while end < len(types) and types[end] == kind:
            end += 1
        base = max_position + 1
        if kind == "image":
            t, h, w = image_grids[image_index]
            image_index += 1
            for ti in range(t):
                for hi in range(h // merge):
                    for wi in range(w // merge):
                        for axis, offset in zip(axes, (ti, hi, wi)):
                            axis.append(base + offset)
                        max_position = max(max_position, base + ti, base + hi, base + wi)
        else:
            for offset in range(end - start):
                for axis in axes:
                    axis.append(base + offset)
                max_position = max(max_position, base + offset)
        start = end
    return np.asarray(axes, np.int32).reshape(3, -1), max_position + 1
