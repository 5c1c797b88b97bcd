"""CLIP-L tower consuming SAM features as patch embeddings
(dsocr_tpu/models/deepseek/clip.py): class token + position embedding
(grid part antialias-bicubic resized when the token count differs),
pre-layernorm, pre-LN blocks with fused-qkv attention and quick-gelu
MLPs. The output keeps the CLS row; fusion drops it."""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops.activations import quick_gelu
from ...ops.resize import resize_grid
from .config import ClipParams
from .sam import Linear, Norm, normal_, param


class ClipLayer(nn.Module):
    def __init__(self, p: ClipParams, dtype, device):
        super().__init__()
        H = p.hidden_size
        self.ln1 = Norm(H, dtype, device)
        self.ln2 = Norm(H, dtype, device)
        self.qkv = Linear(H, 3 * H, dtype, device)
        self.out = Linear(H, H, dtype, device)
        self.fc1 = Linear(H, p.ffn_hidden_size, dtype, device)
        self.fc2 = Linear(p.ffn_hidden_size, H, dtype, device)


class ClipEncoder(nn.Module):
    def __init__(self, p: ClipParams, dtype=torch.float32, device=None):
        super().__init__()
        self.p = p
        H = p.hidden_size
        self.class_embedding = param(H, dtype=dtype, device=device)
        self.position_embedding = param(p.seq_length + 1, H, dtype=dtype, device=device)
        self.pre_layernorm = Norm(H, dtype, device)
        self.layers = nn.ModuleList(ClipLayer(p, dtype, device) for _ in range(p.num_layers))

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Random init at the reference's scales (clip.py:22-51)."""
        normal_(self.class_embedding, 0.02, gen)
        normal_(self.position_embedding, 0.02, gen)
        self.pre_layernorm.reset_()
        for layer in self.layers:
            for m in (layer.ln1, layer.ln2, layer.qkv, layer.out, layer.fc1, layer.fc2):
                m.reset_(gen)

    def _position_embedding(self, target_tokens: int) -> torch.Tensor:
        pos = self.position_embedding
        total, hidden = pos.shape
        if total == target_tokens:
            return pos
        src = int(round((total - 1) ** 0.5))
        dst = int(round((target_tokens - 1) ** 0.5))
        grid = resize_grid(pos[1:].float().reshape(src, src, hidden), dst, dst)
        return torch.cat([pos[:1].float(), grid.reshape(dst * dst, hidden)])

    def forward(self, patch_embeds: torch.Tensor) -> torch.Tensor:
        """[B, hidden, g, g] (SAM output) → [B, 1 + g², hidden]."""
        p = self.p
        b, hidden, gh, gw = patch_embeds.shape
        n = gh * gw
        patches = patch_embeds.reshape(b, hidden, n).transpose(1, 2).float()
        cls = self.class_embedding.float()[None, None].expand(b, 1, hidden)
        x = torch.cat([cls, patches], dim=1) + self._position_embedding(n + 1)[None]
        x = self.pre_layernorm(x, p.layernorm_epsilon)
        heads = p.num_heads
        hd = hidden // heads
        s = n + 1
        for layer in self.layers:
            qkv = layer.qkv(layer.ln1(x, p.layernorm_epsilon))
            q, k, v = (
                qkv[..., i * hidden : (i + 1) * hidden].reshape(b, s, heads, hd).transpose(1, 2)
                for i in range(3)
            )
            # weight-dtype attention with f32 scores and softmax; probs go
            # back to the weight dtype for the value matmul (as clip.py:104)
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, hidden)
            x = x + layer.out(ctx)
            normed = layer.ln2(x, p.layernorm_epsilon)
            x = x + layer.fc2(quick_gelu(layer.fc1(normed)))
        return x
