"""PaddleOCR-VL's SigLIP tower (dsocr_tpu/models/paddleocr/vision.py).

Patch embedding as a flattened linear, the learned position grid resized
bilinearly to the image's patch grid (``interpolate_pos_grid``,
align_corners=False), the 2D rotary (``build_2d_rope``), N pre-LayerNorm
layers of full bidirectional attention and gelu-tanh MLPs, and a post
LayerNorm. Norms, softmax and residual sums run in f32; a linear runs in
the wider of its input's and its weight's dtype and casts to the input's,
as the reference's einsum does.

Attention memory: a page may reach 14,400 patches (max_pixels 2,822,400
at patch 14), where the [heads, N, N] f32 scores of the plain
``ops.attention`` would take 13.3 GB a layer, and the engine runs every
page of a wave that shares a grid in one batch. ``blocked_attention``
computes the same attention a block of queries at a time: each query's
softmax is its own, so the values do not change, and the block is sized
so that a call's f32 scores stay within ``SCORE_BYTES`` (512 MiB; with the
softmax's copy about 1 GiB) whatever the batch. It is plain PyTorch, as
the reference's attention here is plain XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops import attention, gelu_tanh, layer_norm, rotate_half
from ..deepseek.sam import Linear, Norm, normal_, param
from .config import PaddleVisionConfig

# the f32 scores one attention call of the tower may hold
SCORE_BYTES = 1 << 29


def affine(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """x @ w + b in f32: the product in the wider of x's and w's dtypes,
    the bias added in f32."""
    wide = torch.promote_types(x.dtype, lin.w.dtype)
    return torch.matmul(x.to(wide), lin.w.to(wide)).float() + lin.b.float()


def linear(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """affine, cast to x's dtype."""
    return affine(x, lin).to(x.dtype)


def interpolate_pos_grid(pos_embedding: torch.Tensor, base_grid: int, target_h: int,
                         target_w: int) -> torch.Tensor:
    """[base², H] → [target_h·target_w, H]: bilinear resize with the
    pixel-centre convention (align_corners=False), in f32, cast back."""
    grid = pos_embedding.float().reshape(base_grid, base_grid, -1)
    dev = grid.device

    def axis_coords(target, base):
        if base <= 1 or target <= 1:
            z = torch.zeros(max(target, 1), dtype=torch.long, device=dev)
            return z, z, torch.zeros(max(target, 1), dtype=torch.float32, device=dev)
        scale = base / target
        real = (torch.arange(target, dtype=torch.float32, device=dev) + 0.5) * scale - 0.5
        clamped = real.clamp(0.0, base - 1)
        low = torch.floor(clamped).long()
        high = (low + 1).clamp(max=base - 1)
        return low, high, clamped - low.float()

    y0, y1, fy = axis_coords(target_h, base_grid)
    x0, x1, fx = axis_coords(target_w, base_grid)
    rows = grid[y0] * (1 - fy)[:, None, None] + grid[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return out.reshape(target_h * target_w, -1).to(pos_embedding.dtype)


def build_2d_rope(height_ids: torch.Tensor, width_ids: torch.Tensor,
                  head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [N, head_dim] f32: frequencies stride by 2 over half the
    head dim; each row is [h-angles, w-angles] twice."""
    base_dim = max(head_dim // 2, 1)
    idx = np.arange(0, base_dim, 2, dtype=np.float32)
    inv_freq = 1.0 / np.power(10000.0, idx / base_dim)
    if inv_freq.size == 0:
        inv_freq = np.ones((1,), np.float32)
    inv_freq = torch.from_numpy(np.asarray(inv_freq, np.float32)).to(height_ids.device)
    h_angles = height_ids.float()[:, None] * inv_freq[None, :]
    w_angles = width_ids.float()[:, None] * inv_freq[None, :]
    stacked = torch.cat([h_angles, w_angles], dim=-1)
    full = torch.cat([stacked, stacked], dim=-1)
    return torch.cos(full), torch.sin(full)


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


def blocked_attention(q, k, v, block: Optional[int] = None) -> torch.Tensor:
    """ops.attention (no mask) over q [B, H, N, D] a block of queries at a
    time → [B, N, H·D]; `block` None sizes it by SCORE_BYTES."""
    B, H, N, _ = q.shape
    if block is None:
        block = max(1, SCORE_BYTES // (4 * B * H * k.shape[2]))
    if block >= N:
        return attention(q, k, v)
    k, v = k.float(), v.float()  # once, not once a block
    return torch.cat([attention(q[:, :, i : i + block], k, v) for i in range(0, N, block)], dim=1)


class SiglipLayer(nn.Module):
    def __init__(self, cfg: PaddleVisionConfig, dtype, device):
        super().__init__()
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = Norm(h, dtype, device)
        self.ln2 = Norm(h, dtype, device)
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(h, h, dtype, device))
        self.fc1 = Linear(h, inter, dtype, device)
        self.fc2 = Linear(inter, h, dtype, device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        self.ln1.reset_()
        self.ln2.reset_()
        for lin in (self.q, self.k, self.v, self.o, self.fc1, self.fc2):
            lin.reset_(gen)


class SiglipTower(nn.Module):
    """The reference's ``siglip_forward``; state names follow
    convert.params_from_jax of its ``params["vision"]``."""

    def __init__(self, cfg: PaddleVisionConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.patch_embed = Linear(cfg.num_channels * cfg.patch_size ** 2, h, dtype, device)
        self.position_embedding = param(cfg.base_grid ** 2, h, dtype=dtype, device=device)
        self.post_layernorm = Norm(h, dtype, device)
        self.layers = nn.ModuleList(SiglipLayer(cfg, dtype, device) for _ in range(cfg.num_hidden_layers))

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Linears N(0, fan_in^-1) with zero bias, positions N(0, 0.02²),
        norms 1 and 0 (vision.py:29-69)."""
        self.patch_embed.reset_(gen)
        normal_(self.position_embedding, 0.02, gen)
        self.post_layernorm.reset_()
        for layer in self.layers:
            layer.reset_(gen)

    def forward(
        self,
        patches: torch.Tensor,  # [B, N, C, p, p] or [B, N, C·p·p], in the activation dtype
        grid_thw: Tuple[int, int, int],
        height_ids: torch.Tensor,  # [N]
        width_ids: torch.Tensor,  # [N]
        use_rope: bool = True,
        block: Optional[int] = None,
    ) -> torch.Tensor:
        """→ [B, N, hidden] in the patches' dtype: B images of one grid."""
        cfg = self.cfg
        B, n = patches.shape[:2]
        t, gh, gw = grid_thw
        x = linear(patches.reshape(B, n, -1), self.patch_embed)
        pos = interpolate_pos_grid(self.position_embedding, cfg.base_grid, gh, gw)
        if t > 1:
            pos = pos.repeat(t, 1)
        x = (x.float() + pos.float()).to(x.dtype)
        rope = build_2d_rope(height_ids, width_ids, cfg.head_dim) if use_rope else None
        heads = cfg.num_attention_heads
        eps = cfg.layer_norm_eps
        for layer in self.layers:
            normed = layer_norm(x, layer.ln1.w, layer.ln1.b, eps)
            q, k, v = (linear(normed, getattr(layer, name)).reshape(B, n, heads, -1).transpose(1, 2)
                       for name in ("q", "k", "v"))
            if rope is not None:
                q, k = _rope_apply(q, *rope), _rope_apply(k, *rope)
            attn = linear(blocked_attention(q, k, v, block), layer.o)
            x = (x.float() + attn.float()).to(x.dtype)
            normed = layer_norm(x, layer.ln2.w, layer.ln2.b, eps)
            h1 = gelu_tanh(linear(normed, layer.fc1).float()).to(x.dtype)
            x = (x.float() + linear(h1, layer.fc2).float()).to(x.dtype)
        return layer_norm(x, self.post_layernorm.w, self.post_layernorm.b, eps)
