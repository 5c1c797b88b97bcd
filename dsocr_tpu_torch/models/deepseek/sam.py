"""SAM ViT-B backbone (dsocr_tpu/models/deepseek/sam.py).

16×16 patch embed, absolute position embedding (antialiased-bicubic
resized to the token grid), 12 pre-LN blocks — windowed 14×14 attention
except the global blocks — with decomposed relative-position bias and
erf-GELU MLPs, then the neck (1×1 conv → LN2d → 3×3 conv → LN2d) and two
stride-2 convs. Projections run in the weight dtype; attention scores,
norms and the residual stream stay f32, as in the reference.

Global blocks at S >= 1024 tokens (the 1024 global view and the 640
tiles) attend through ``sam_flash_attention`` — the CUDA kernel on the
card, its plain twin on the CPU; the windowed blocks (S = 196) are plain
PyTorch, as they are plain XLA in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.kernels import sam_flash_attention
from ...ops.resize import resize_grid
from .config import SamParams

# minimum token count for the global-attention kernel (as sam.py:225)
FLASH_MIN_S = 1024


def param(*shape, dtype=torch.float32, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device), requires_grad=False)


def normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill with N(0, std²) drawn in f32 on p's device from `gen`."""
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32) * std)


class Linear(nn.Module):
    """{"w": [in, out], "b": [out]} — the reference's layout."""

    def __init__(self, i: int, o: int, dtype, device):
        super().__init__()
        self.w = param(i, o, dtype=dtype, device=device)
        self.b = param(o, dtype=dtype, device=device)

    def reset_(self, gen):
        normal_(self.w, self.w.shape[0] ** -0.5, gen)
        self.b.zero_()

    def forward(self, x):
        out = torch.matmul(x.to(self.w.dtype), self.w)
        return out + self.b.to(out.dtype)


class Norm(nn.Module):
    def __init__(self, n: int, dtype, device):
        super().__init__()
        self.w = param(n, dtype=dtype, device=device)
        self.b = param(n, dtype=dtype, device=device)

    def reset_(self, gen=None):
        self.w.fill_(1.0)
        self.b.zero_()

    def forward(self, x, eps):
        """LayerNorm in f32 (output stays f32, like the reference)."""
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        return (x32 - mean) * (var + eps) ** -0.5 * self.w.float() + self.b.float()


def conv2d(x, w, stride=1, padding=0):
    """Conv in the weight dtype with f32 accumulation and f32 output: the
    operands are rounded to w's dtype, then convolved in f32 (exact
    products), which is the reference's `preferred_element_type=f32`."""
    return F.conv2d(x.to(w.dtype).float(), w.float(), stride=stride, padding=padding)


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] → ([B·nWin, win, win, C], padded (Hp, Wp))."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return x[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """[q, k, head_dim] relative-position rows: linear align_corners=False
    resize of the table when its length differs, then floor-indexed
    relative coordinates."""
    max_rel = 2 * max(q_size, k_size) - 1
    L = rel_pos.shape[0]
    table = rel_pos.float()
    if L != max_rel:
        scale = L / max_rel
        pos = torch.arange(max_rel, dtype=torch.float32, device=table.device)
        src = torch.clamp(scale * (pos + 0.5) - 0.5, 0.0, L - 1)
        left = torch.floor(src).long()
        right = torch.clamp(left + 1, max=L - 1)
        frac = (src - left.float())[:, None]
        table = table[left] * (1 - frac) + table[right] * frac
    scale_q = max(k_size / q_size, 1.0)
    scale_k = max(q_size / k_size, 1.0)
    rel = (np.arange(q_size)[:, None] * scale_q - np.arange(k_size)[None, :] * scale_k) + (
        k_size - 1
    ) * scale_k
    idx = np.clip(np.floor(rel), 0, max_rel - 1).astype(np.int64)
    return table[torch.from_numpy(idx).to(table.device)]


def decomposed_bias(q, spatial, rel_pos_h, rel_pos_w):
    """(bias_h [B, heads, qh, qw, kh], bias_w [.., kw]) from the unscaled q."""
    qh, qw = spatial
    b, n, _, d = q.shape
    rh = get_rel_pos(qh, qh, rel_pos_h)
    rw = get_rel_pos(qw, qw, rel_pos_w)
    q_r = q.float().reshape(b, n, qh, qw, d)
    bias_h = torch.einsum("bnhwc,hkc->bnhwk", q_r, rh)
    bias_w = torch.einsum("bnhwc,wkc->bnhwk", q_r, rw)
    return bias_h, bias_w


class SamBlock(nn.Module):
    def __init__(self, p: SamParams, window: int, dtype, device):
        super().__init__()
        E = p.embed_dim
        rel_dim = 2 * (window if window > 0 else p.base_grid) - 1
        self.window = window
        self.norm1 = Norm(E, dtype, device)
        self.norm2 = Norm(E, dtype, device)
        self.qkv = Linear(E, 3 * E, dtype, device)
        self.proj = Linear(E, E, dtype, device)
        self.rel_pos_h = param(rel_dim, p.head_dim, dtype=dtype, device=device)
        self.rel_pos_w = param(rel_dim, p.head_dim, dtype=dtype, device=device)
        self.fc1 = Linear(E, int(E * p.mlp_ratio), dtype, device)
        self.fc2 = Linear(int(E * p.mlp_ratio), E, dtype, device)

    def reset_(self, gen):
        for m in (self.norm1, self.norm2, self.qkv, self.proj, self.fc1, self.fc2):
            m.reset_(gen)
        normal_(self.rel_pos_h, 0.02, gen)
        normal_(self.rel_pos_w, 0.02, gen)

    def attention(self, x, num_heads: int, head_dim: int, spatial) -> torch.Tensor:
        b, h, w, _ = x.shape
        s = h * w
        qkv = self.qkv(x).reshape(b, s, 3, num_heads, head_dim)
        # attention math in f32, like the reference
        q, k, v = (qkv[:, :, i].transpose(1, 2).float() for i in range(3))
        bias_h, bias_w = decomposed_bias(q, spatial, self.rel_pos_h, self.rel_pos_w)
        if s >= FLASH_MIN_S:
            qh, qw = spatial
            n = num_heads
            ctx = sam_flash_attention(
                (q * head_dim ** -0.5).reshape(b * n, s, head_dim).contiguous(),
                k.reshape(b * n, s, head_dim).contiguous(),
                v.reshape(b * n, s, head_dim).contiguous(),
                bias_h.reshape(b * n, s, qh).contiguous(),
                bias_w.reshape(b * n, s, qw).contiguous(),
                width=qw,
            ).reshape(b, n, s, head_dim)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * head_dim ** -0.5
            bias = bias_h[..., :, None] + bias_w[..., None, :]
            scores = scores + bias.reshape(b, num_heads, s, s)
            ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(b, h, w, num_heads * head_dim)
        return self.proj(ctx)

    def forward(self, x, p: SamParams):
        th, tw = x.shape[1], x.shape[2]
        normed = self.norm1(x, p.norm_eps)
        if self.window > 0:
            windows, pad_hw = window_partition(normed, self.window)
            attn = self.attention(windows, p.num_heads, p.head_dim, (self.window, self.window))
            attn = window_unpartition(attn, self.window, pad_hw, (th, tw))
        else:
            attn = self.attention(normed, p.num_heads, p.head_dim, (th, tw))
        x = x + attn
        normed = self.norm2(x, p.norm_eps)
        return x + self.fc2(F.gelu(self.fc1(normed), approximate="none"))


class SamEncoder(nn.Module):
    def __init__(self, p: SamParams, dtype=torch.float32, device=None):
        super().__init__()
        self.p = p
        E = p.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.w = param(E, 3, p.patch_size, p.patch_size, dtype=dtype, device=device)
        self.patch_embed.b = param(E, dtype=dtype, device=device)
        self.pos_embed = param(1, p.base_grid, p.base_grid, E, dtype=dtype, device=device)
        C = p.neck_channels
        self.neck = nn.Module()  # conv1 → LN2d → conv2 → LN2d
        self.neck.conv1 = param(C, E, 1, 1, dtype=dtype, device=device)
        self.neck.norm1 = Norm(C, dtype, device)
        self.neck.conv2 = param(C, C, 3, 3, dtype=dtype, device=device)
        self.neck.norm2 = Norm(C, dtype, device)
        self.net_2 = param(p.out_channels[0], p.neck_channels, 3, 3, dtype=dtype, device=device)
        self.net_3 = param(p.out_channels[1], p.out_channels[0], 3, 3, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            SamBlock(p, 0 if i in p.global_attn_indexes else p.window_size, dtype, device)
            for i in range(p.depth)
        )

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Random init at the reference's scales (sam.py:33-88)."""
        fan = lambda w: (w.shape[1] * w.shape[2] * w.shape[3]) ** -0.5  # noqa: E731
        normal_(self.patch_embed.w, fan(self.patch_embed.w), gen)
        self.patch_embed.b.zero_()
        normal_(self.pos_embed, 0.02, gen)
        for w in (self.neck.conv1, self.neck.conv2, self.net_2, self.net_3):
            normal_(w, fan(w), gen)
        self.neck.norm1.reset_()
        self.neck.norm2.reset_()
        for blk in self.blocks:
            blk.reset_(gen)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] f32 → [B, out_channels[1], H/64, W/64] f32."""
        p = self.p
        w, bias = self.patch_embed.w, self.patch_embed.b
        patch = p.patch_size
        bsz, c, h, wd = pixels.shape
        gh, gw = h // patch, wd // patch
        x = pixels[:, :, : gh * patch, : gw * patch].reshape(bsz, c, gh, patch, gw, patch)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(bsz, gh, gw, c * patch * patch)
        wm = w.reshape(w.shape[0], -1).t()  # [c*p*p, E] from OIHW
        # the patch conv as a matmul, f32 accumulation of w-dtype operands
        x = torch.matmul(x.to(w.dtype).float(), wm.float()) + bias.float()

        pos = self.pos_embed.float()
        if pos.shape[1] != gh or pos.shape[2] != gw:
            pos = resize_grid(pos, gh, gw)
        x = x + pos
        for blk in self.blocks:
            x = blk(x, p)

        x = x.permute(0, 3, 1, 2)  # NCHW
        neck = self.neck
        x = conv2d(x, neck.conv1)
        x = neck.norm1(x.permute(0, 2, 3, 1), p.norm_eps).permute(0, 3, 1, 2)
        x = conv2d(x, neck.conv2, padding=1)
        x = neck.norm2(x.permute(0, 2, 3, 1), p.norm_eps).permute(0, 3, 1, 2)
        x = conv2d(x, self.net_2, stride=2, padding=1)
        return conv2d(x, self.net_3, stride=2, padding=1)
