"""DotsVision tower (dsocr_tpu/models/dots/vision.py).

The conv patch embed as a linear over [C·p·p] + RMSNorm; blocks of
RMSNorm → qkv → 2D rotary → attention within each frame → proj →
residual, then RMSNorm → SwiGLU (fc1 gate, fc3 up, fc2 down) → residual;
the optional post-trunk RMSNorm; the PatchMerger (LayerNorm ε 1e-6 → the
merge² neighbours of a group side by side → linear → GELU (tanh) →
linear). Every image of a call packs into one token sequence
(``SequenceLayout``), and attention is blocked per frame
(ops/packed_attention.py: ``segment_attention``).

Dtypes, as the reference's: the weights are f32 (its init and its
loader), the residual stream takes the patches' dtype, which is the
engine's (bf16 when serving). Every linear promotes its input to the
wider dtype, accumulates and adds its bias in f32 and rounds back to the
input's dtype (``linear``); norms and the rotary run in f32 and round
back the same way; attention runs in the activation dtype.

The rotary positions walk each frame in merge-window order
(``_frame_positions``), while the patches come from the smart-resize in
row-major order; that pairing is the reference's, kept as it is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops import gelu_tanh, layer_norm, rms_norm, rotate_half, silu
from ...ops.packed_attention import segment_attention
from ..deepseek.sam import Norm, normal_, param
from .config import DotsVisionConfig


@dataclasses.dataclass(frozen=True)
class SequenceLayout:
    """Packed multi-image token layout: each frame's (start, length), the
    merged groups and the (h, w) rotary position of every token."""

    frames: Tuple[Tuple[int, int], ...]
    total_tokens: int
    merge_groups: int
    positions: np.ndarray  # [total, 2] (h, w), merge-window order

    @classmethod
    def from_grid(cls, grid_thw: Sequence[Tuple[int, int, int]], merge: int) -> "SequenceLayout":
        frames: List[Tuple[int, int]] = []
        positions: List[np.ndarray] = []
        total = groups = 0
        for t, h, w in grid_thw:
            if h % merge or w % merge:
                raise ValueError(f"grid {h}x{w} not divisible by merge {merge}")
            frame_positions = _frame_positions(h, w, merge)
            for _ in range(t):
                frames.append((total, h * w))
                total += h * w
                groups += (h * w) // (merge * merge)
                positions.append(frame_positions)
        return cls(frames=tuple(frames), total_tokens=total, merge_groups=groups,
                   positions=np.concatenate(positions) if positions else np.zeros((0, 2), np.int32))

    @property
    def uniform_frame_len(self) -> Optional[int]:
        lens = {length for _, length in self.frames if length > 0}
        return lens.pop() if len(lens) == 1 else None

    @property
    def segment_ids(self) -> np.ndarray:
        """[total] the frame index of every token."""
        return np.repeat(np.arange(len(self.frames), dtype=np.int32), [n for _, n in self.frames])


def _frame_positions(h: int, w: int, merge: int) -> np.ndarray:
    """(h, w) per patch in merge-window order."""
    bh, bw, ih, iw = np.meshgrid(np.arange(h // merge), np.arange(w // merge), np.arange(merge),
                                 np.arange(merge), indexing="ij")
    return np.stack([bh * merge + ih, bw * merge + iw], axis=-1).reshape(-1, 2).astype(np.int32)


def build_2d_rope_np(positions: np.ndarray, head_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [N, head_dim] f32: angles [h·f…, w·f…] over a quarter
    of the head dim each, the half duplicated."""
    rope_dim = head_dim // 2
    axis_dim = rope_dim // 2
    inv_freq = 1.0 / np.power(10000.0, (2 * np.arange(axis_dim, dtype=np.float32)) / rope_dim)
    h_angles = positions[:, 0:1].astype(np.float32) * inv_freq
    w_angles = positions[:, 1:2].astype(np.float32) * inv_freq
    half = np.concatenate([h_angles, w_angles], axis=1)
    full = np.concatenate([half, half], axis=1)
    return np.cos(full), np.sin(full)


class Dense(nn.Module):
    """{"w": [in, out], "b": [out]} — the reference's layout; without a
    bias the module has no ``b``, as the reference's tree holds None."""

    def __init__(self, i: int, o: int, dtype, device, bias: bool = True):
        super().__init__()
        self.w = param(i, o, dtype=dtype, device=device)
        if bias:
            self.b = param(o, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """w ~ N(0, 1/in), b = 0 (the reference's ``lin``)."""
        normal_(self.w, self.w.shape[0] ** -0.5, gen)
        if hasattr(self, "b"):
            self.b.zero_()


def linear(x: torch.Tensor, lin: Dense) -> torch.Tensor:
    """x @ w (+ b): the product in the wider of x's and w's dtypes, the
    bias added in f32, the result in x's dtype."""
    wide = torch.promote_types(x.dtype, lin.w.dtype)
    out = torch.matmul(x.to(wide), lin.w.to(wide)).float()
    if hasattr(lin, "b"):
        out = out + lin.b.float()
    return out.to(x.dtype)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [N, NH, D] by cos/sin [N, D], in f32, cast back."""
    x32 = x.float()
    return (x32 * cos[:, None] + rotate_half(x32) * sin[:, None]).to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DotsVisionConfig, dtype, device):
        super().__init__()
        E = cfg.embed_dim
        self.w = param(E, cfg.num_channels, cfg.patch_size, cfg.patch_size, dtype=dtype, device=device)
        self.b = param(E, dtype=dtype, device=device)
        self.norm = param(E, dtype=dtype, device=device)


class Merger(nn.Module):
    def __init__(self, cfg: DotsVisionConfig, dtype, device):
        super().__init__()
        merged = cfg.embed_dim * cfg.spatial_merge_size ** 2
        self.ln_q = Norm(cfg.embed_dim, dtype, device)
        self.mlp_in = Dense(merged, merged, dtype, device)
        self.mlp_out = Dense(merged, cfg.hidden_size, dtype, device)


class DotsBlock(nn.Module):
    def __init__(self, cfg: DotsVisionConfig, dtype, device):
        super().__init__()
        E, I, bias = cfg.embed_dim, cfg.intermediate_size, cfg.use_bias  # noqa: E741
        self.norm1 = param(E, dtype=dtype, device=device)
        self.norm2 = param(E, dtype=dtype, device=device)
        self.qkv = Dense(E, 3 * E, dtype, device, bias)
        self.proj = Dense(E, E, dtype, device, bias)
        self.fc1 = Dense(E, I, dtype, device, bias)
        self.fc2 = Dense(I, E, dtype, device, bias)
        self.fc3 = Dense(E, I, dtype, device, bias)


class DotsVisionTower(nn.Module):
    """The reference's ``dots_vision_forward``; state names follow
    convert.params_from_jax of its ``params["vision"]``."""

    def __init__(self, cfg: DotsVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, dtype, device)
        if cfg.post_norm:
            self.post_trunk_norm = param(cfg.embed_dim, dtype=dtype, device=device)
        self.merger = Merger(cfg, dtype, device)
        self.blocks = nn.ModuleList(DotsBlock(cfg, dtype, device) for _ in range(cfg.num_hidden_layers))

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """The reference's init: the patch conv N(0, 0.02²) with zero bias,
        linears N(0, 1/in) with zero biases, norms 1 (LayerNorm bias 0)."""
        normal_(self.patch_embed.w, 0.02, gen)
        self.patch_embed.b.zero_()
        self.patch_embed.norm.fill_(1.0)
        if self.cfg.post_norm:
            self.post_trunk_norm.fill_(1.0)
        self.merger.ln_q.reset_()
        self.merger.mlp_in.reset_(gen)
        self.merger.mlp_out.reset_(gen)
        for blk in self.blocks:
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
            for lin in (blk.qkv, blk.proj, blk.fc1, blk.fc2, blk.fc3):
                lin.reset_(gen)

    def forward(self, patches: torch.Tensor, layout: SequenceLayout) -> torch.Tensor:
        """patches [N, C, p, p] (or [N, C·p·p]) in the activation dtype →
        [merge_groups, hidden] in that dtype."""
        cfg = self.cfg
        n = patches.shape[0]
        E, NH, D, eps = cfg.embed_dim, cfg.num_attention_heads, cfg.head_dim, cfg.rms_norm_eps
        pe = self.patch_embed
        w = pe.w.reshape(E, -1).t()
        wide = torch.promote_types(patches.dtype, w.dtype)
        x = torch.matmul(patches.reshape(n, -1).to(wide), w.to(wide)).float()
        x = rms_norm((x + pe.b.float()).to(patches.dtype), pe.norm, eps)
        cos, sin = (torch.from_numpy(t).to(x.device) for t in build_2d_rope_np(layout.positions, D))
        seg = layout.segment_ids
        for blk in self.blocks:
            normed = rms_norm(x, blk.norm1, eps)
            qkv = linear(normed, blk.qkv).reshape(n, 3, NH, D)
            q, k = rope_apply(qkv[:, 0], cos, sin), rope_apply(qkv[:, 1], cos, sin)
            ctx = segment_attention(q, k, qkv[:, 2], seg).reshape(n, NH * D)
            x = (x.float() + linear(ctx, blk.proj).float()).to(x.dtype)
            normed = rms_norm(x, blk.norm2, eps)
            gate = silu(linear(normed, blk.fc1).float())
            up = linear(normed, blk.fc3).float()
            x = (x.float() + linear((gate * up).to(x.dtype), blk.fc2).float()).to(x.dtype)
        if cfg.post_norm:
            x = rms_norm(x, self.post_trunk_norm, eps)
        m = self.merger
        merge2 = cfg.spatial_merge_size ** 2
        grouped = layer_norm(x, m.ln_q.w, m.ln_q.b, 1e-6).reshape(n // merge2, E * merge2)
        h = gelu_tanh(linear(grouped, m.mlp_in).float()).to(x.dtype)
        return linear(h, m.mlp_out)
