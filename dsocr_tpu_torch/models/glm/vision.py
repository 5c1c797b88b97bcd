"""GLM-OCR's vision tower (dsocr_tpu/models/glm/vision.py).

A linear patch embed over the flattened [C·T·p·p] patch (1,176 values at
the published width: the frame duplicated over T = 2); blocks of RMSNorm
→ qkv → RMSNorm of q and k per head → 2D rotary → attention within each
frame → proj → residual, then RMSNorm → SwiGLU → residual; the post
RMSNorm; the stride-merge ``downsample`` conv (kernel = stride = merge,
so one merge × merge window to one out_hidden vector: a linear over the
window, in f32, here); the gated merger (proj → LayerNorm → exact GELU →
silu(gate)·up → down). Every image of a call packs into one sequence and
attention is blocked per frame (ops/packed_attention.py); the rotary
walks each frame in merge-window order (``grouped_axis_ids``), which is
also the order the engine lays the patches out in.

Dtypes, as the DotsVision tower's (models/dots/vision.py): f32 weights,
the residual stream in the patches' dtype (the engine's), every linear in
the wider dtype with an f32 bias, rounded back to the input's dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops import gelu, layer_norm, rms_norm, silu
from ...ops.packed_attention import segment_attention
from ..deepseek.sam import Norm, normal_, param
from ..dots.vision import Dense, _frame_positions, linear, rope_apply
from .config import GlmVisionConfig


def grouped_axis_ids(h: int, w: int, merge: int) -> np.ndarray:
    """[h·w, 2] (h, w) ids in merge-window order."""
    return _frame_positions(h, w, merge)


def build_rotary_np(grids: Sequence[Tuple[int, int, int]], cfg: GlmVisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [N, head_dim] f32 over the packed frames: [h·f…, w·f…]
    over a quarter of the head dim each, the half duplicated, every
    temporal frame of a grid alike."""
    head_dim = cfg.head_dim
    rope_dim = head_dim // 2
    axis_dim = rope_dim // 2
    inv_freq = 1.0 / np.power(10000.0, (2 * np.arange(axis_dim, dtype=np.float32)) / rope_dim)
    rows = []
    for t, h, w in grids:
        ids = grouped_axis_ids(h, w, cfg.spatial_merge_size)
        half = np.concatenate([ids[:, 0:1].astype(np.float32) * inv_freq,
                               ids[:, 1:2].astype(np.float32) * inv_freq], axis=1)
        rows.append(np.tile(np.concatenate([half, half], axis=1), (t, 1)))
    packed = np.concatenate(rows) if rows else np.zeros((0, head_dim), np.float32)
    return np.cos(packed), np.sin(packed)


def segment_ids(grids: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """[N] the frame index of every token: each grid's t frames of h·w."""
    sizes = [h * w for t, h, w in grids for _ in range(t)]
    return np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)


class GlmBlock(nn.Module):
    def __init__(self, cfg: GlmVisionConfig, dtype, device):
        super().__init__()
        H, I, D, bias = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.attention_bias  # noqa: E741
        self.norm1 = param(H, dtype=dtype, device=device)
        self.norm2 = param(H, dtype=dtype, device=device)
        self.qkv = Dense(H, 3 * H, dtype, device, bias)
        self.proj = Dense(H, H, dtype, device, bias)
        self.q_norm = param(D, dtype=dtype, device=device)
        self.k_norm = param(D, dtype=dtype, device=device)
        self.gate_proj = Dense(H, I, dtype, device, bias)
        self.up_proj = Dense(H, I, dtype, device, bias)
        self.down_proj = Dense(I, H, dtype, device, bias)


class GlmMerger(nn.Module):
    def __init__(self, cfg: GlmVisionConfig, dtype, device):
        super().__init__()
        OH, inner = cfg.out_hidden_size, cfg.out_hidden_size * cfg.in_channels
        self.proj = Dense(OH, OH, dtype, device, bias=False)
        self.norm = Norm(OH, dtype, device)
        self.gate = Dense(OH, inner, dtype, device, bias=False)
        self.up = Dense(OH, inner, dtype, device, bias=False)
        self.down = Dense(inner, OH, dtype, device, bias=False)


class GlmVisionTower(nn.Module):
    """The reference's ``glm_vision_forward``; state names follow
    convert.params_from_jax of its ``params["vision"]``."""

    def __init__(self, cfg: GlmVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.spatial_merge_size
        self.patch_embed = Dense(cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2, cfg.hidden_size,
                                 dtype, device)
        self.post_layernorm = param(cfg.hidden_size, dtype=dtype, device=device)
        self.downsample = param(cfg.out_hidden_size, cfg.hidden_size, m, m, dtype=dtype, device=device)
        self.merger = GlmMerger(cfg, dtype, device)
        self.blocks = nn.ModuleList(GlmBlock(cfg, dtype, device) for _ in range(cfg.depth))

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """The reference's init: linears N(0, 1/in) with zero biases, the
        downsample conv N(0, 0.02²), norms 1 (LayerNorm bias 0)."""
        self.patch_embed.reset_(gen)
        self.post_layernorm.fill_(1.0)
        normal_(self.downsample, 0.02, gen)
        m = self.merger
        m.norm.reset_()
        for lin in (m.proj, m.gate, m.up, m.down):
            lin.reset_(gen)
        for blk in self.blocks:
            for p in (blk.norm1, blk.norm2, blk.q_norm, blk.k_norm):
                p.fill_(1.0)
            for lin in (blk.qkv, blk.proj, blk.gate_proj, blk.up_proj, blk.down_proj):
                lin.reset_(gen)

    def forward(self, patches: torch.Tensor, grids: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
        """patches [N, C·T·p·p] in the activation dtype, the frames of
        `grids` one after another → [N / merge², out_hidden] in that dtype."""
        cfg = self.cfg
        n = patches.shape[0]
        H, NH, D, eps, m = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.rms_norm_eps, cfg.spatial_merge_size
        x = linear(patches, self.patch_embed)
        cos, sin = (torch.from_numpy(t).to(x.device) for t in build_rotary_np(grids, cfg))
        seg = segment_ids(grids)
        for blk in self.blocks:
            normed = rms_norm(x, blk.norm1, eps)
            qkv = linear(normed, blk.qkv).reshape(n, 3, NH, D)
            q = rope_apply(rms_norm(qkv[:, 0], blk.q_norm, 1e-5), cos, sin)
            k = rope_apply(rms_norm(qkv[:, 1], blk.k_norm, 1e-5), cos, sin)
            ctx = segment_attention(q, k, qkv[:, 2], seg).reshape(n, NH * D)
            x = (x.float() + linear(ctx, blk.proj).float()).to(x.dtype)
            normed = rms_norm(x, blk.norm2, eps)
            gate = silu(linear(normed, blk.gate_proj).float())
            up = linear(normed, blk.up_proj).float()
            x = (x.float() + linear((gate * up).to(x.dtype), blk.down_proj).float()).to(x.dtype)
        x = rms_norm(x, self.post_layernorm, eps)
        # the stride-merge conv over each merge × merge window, (i, j, c) order
        window = self.downsample.float().permute(0, 2, 3, 1).reshape(cfg.out_hidden_size, m * m * H)
        down = torch.matmul(x.reshape(n // (m * m), m * m * H).float(), window.t()).to(x.dtype)
        mg = self.merger
        normed = layer_norm(linear(down, mg.proj), mg.norm.w, mg.norm.b, 1e-5)
        activated = gelu(normed.float()).to(x.dtype)
        gate = silu(linear(activated, mg.gate).float())
        up = linear(activated, mg.up).float()
        return linear((gate * up).to(x.dtype), mg.down)
