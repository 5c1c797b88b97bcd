"""DeepSeek-OCR2's vision path after SAM (dsocr_tpu/models/deepseek/ocr2.py):
a Qwen2-0.5B stack used as an encoder with learned queries, then a
linear projector.

The SAM features of a view (S = g² tokens) are followed by S learned
query rows (``query_768``: 144 for 768-pixel views, ``query_1024``: 256
for 1024-pixel ones), and the [image ‖ query] sequence of 2S runs through
24 Qwen2 layers (hidden 896, 14 query heads over 2 KV heads of 64, qkv
bias, θ 1e6) under ``ocr2_attention_mask``: image rows attend image
columns, query rows every image column and, causally, the earlier
queries. The query half, normed, projects to the decoder's 1280.

The encoder computes in the dtype the reference's does: its weights are
f32 (the reference's init; the loader reads them in f32) and the SAM
features are f32, so every product is f32. Its attention is the plain
``ops.attention`` with the mask, as the reference's is plain XLA, not a
Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ...ops import apply_rope, attention, build_rope_tables, rms_norm, silu
from .sam import normal_, param


@dataclasses.dataclass(frozen=True)
class Qwen2EncoderParams:
    num_layers: int = 24
    hidden_size: int = 896
    num_heads: int = 14
    num_kv_heads: int = 2
    intermediate_size: int = 4864
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    query_768: int = 144
    query_1024: int = 256
    projector_out: int = 1280

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_qwen2_encoder_params() -> Qwen2EncoderParams:
    return Qwen2EncoderParams(
        num_layers=2,
        hidden_size=16,
        num_heads=2,
        num_kv_heads=1,
        intermediate_size=32,
        rope_theta=10000.0,
        query_768=4,
        query_1024=16,
        projector_out=32,
    )


def ocr2_attention_mask(seq: int, device=None) -> torch.Tensor:
    """[2S, 2S] bool: image rows (the first S) attend image columns; query
    rows attend every image column and the queries up to their own."""
    total = 2 * seq
    rows = torch.arange(total, device=device)[:, None]
    cols = torch.arange(total, device=device)[None, :]
    image_col = cols < seq
    return ((rows < seq) & image_col) | ((rows >= seq) & (image_col | (cols <= rows)))


def _proj(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w in the wider of the two dtypes, plus the bias in f32, cast to
    x's dtype (the reference's einsum promotes as torch does)."""
    wide = torch.promote_types(x.dtype, w.dtype)
    out = torch.matmul(x.to(wide), w.to(wide))
    if b is not None:
        out = out.float() + b.float()
    return out.to(x.dtype)


class Qwen2Layer(nn.Module):
    def __init__(self, p: Qwen2EncoderParams, dtype, device):
        super().__init__()
        H, D, NH, NKV, I = p.hidden_size, p.head_dim, p.num_heads, p.num_kv_heads, p.intermediate_size
        self.input_layernorm = param(H, dtype=dtype, device=device)
        self.post_attention_layernorm = param(H, dtype=dtype, device=device)
        self.q_proj = param(H, NH * D, dtype=dtype, device=device)
        self.k_proj = param(H, NKV * D, dtype=dtype, device=device)
        self.v_proj = param(H, NKV * D, dtype=dtype, device=device)
        self.o_proj = param(NH * D, H, dtype=dtype, device=device)
        self.q_bias = param(NH * D, dtype=dtype, device=device)
        self.k_bias = param(NKV * D, dtype=dtype, device=device)
        self.v_bias = param(NKV * D, dtype=dtype, device=device)
        self.gate_proj = param(H, I, dtype=dtype, device=device)
        self.up_proj = param(H, I, dtype=dtype, device=device)
        self.down_proj = param(I, H, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Matrices N(0, fan_in^-1), biases 0, norms 1 (ocr2.py:56-84)."""
        self.input_layernorm.fill_(1.0)
        self.post_attention_layernorm.fill_(1.0)
        for w in (self.q_proj, self.k_proj, self.v_proj, self.o_proj, self.gate_proj, self.up_proj,
                  self.down_proj):
            normal_(w, w.shape[0] ** -0.5, gen)
        for b in (self.q_bias, self.k_bias, self.v_bias):
            b.zero_()


class Ocr2Encoder(nn.Module):
    """The reference's ``ocr2_encode_view``: SAM features [B, hidden, g, g]
    → projected query tokens [B, g², projector_out]. State names follow
    convert.params_from_jax of the reference's ``params["ocr2"]`` (its
    [L, ...] layer stacks split one module per layer)."""

    def __init__(self, p: Qwen2EncoderParams, dtype=torch.float32, device=None):
        super().__init__()
        self.p = p
        H = p.hidden_size
        self.layers = nn.ModuleList(Qwen2Layer(p, dtype, device) for _ in range(p.num_layers))
        self.norm = param(H, dtype=dtype, device=device)
        self.query_768 = param(p.query_768, H, dtype=dtype, device=device)
        self.query_1024 = param(p.query_1024, H, dtype=dtype, device=device)
        self.projector = nn.Module()
        self.projector.w = param(H, p.projector_out, dtype=dtype, device=device)
        self.projector.b = param(p.projector_out, dtype=dtype, device=device)
        self.view_seperator = param(p.projector_out, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_(gen)
        self.norm.fill_(1.0)
        normal_(self.query_768, 0.02, gen)
        normal_(self.query_1024, 0.02, gen)
        normal_(self.projector.w, self.p.hidden_size ** -0.5, gen)
        self.projector.b.zero_()
        normal_(self.view_seperator, 0.02, gen)

    def forward(self, sam_features: torch.Tensor) -> torch.Tensor:
        p = self.p
        b, hidden, gh, gw = sam_features.shape
        seq = gh * gw
        tokens = sam_features.reshape(b, hidden, seq).transpose(1, 2)
        if seq == p.query_768:
            query = self.query_768
        elif seq == p.query_1024:
            query = self.query_1024
        else:
            raise ValueError(
                f"unsupported Qwen2 query length {seq} (expected {p.query_768} or {p.query_1024})"
            )
        x = torch.cat([tokens, query[None].expand(b, seq, hidden).to(tokens.dtype)], dim=1)
        total = 2 * seq
        dev = x.device
        mask = ocr2_attention_mask(seq, dev)[None, None]
        cos, sin = build_rope_tables(total, p.head_dim, p.rope_theta, dev)
        cos, sin = cos[None, None], sin[None, None]
        NH, NKV, D = p.num_heads, p.num_kv_heads, p.head_dim
        for layer in self.layers:
            normed = rms_norm(x, layer.input_layernorm, p.rms_norm_eps)
            q = _proj(normed, layer.q_proj, layer.q_bias).reshape(b, total, NH, D).transpose(1, 2)
            k = _proj(normed, layer.k_proj, layer.k_bias).reshape(b, total, NKV, D).transpose(1, 2)
            v = _proj(normed, layer.v_proj, layer.v_bias).reshape(b, total, NKV, D).transpose(1, 2)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            attn = attention(q, k, v, mask, 1.0 / (D ** 0.5))
            x = (x.float() + _proj(attn, layer.o_proj).float()).to(x.dtype)
            normed = rms_norm(x, layer.post_attention_layernorm, p.rms_norm_eps)
            gate = _proj(normed, layer.gate_proj).float()
            up = _proj(normed, layer.up_proj).float()
            mlp = _proj((silu(gate) * up).to(x.dtype), layer.down_proj)
            x = (x.float() + mlp.float()).to(x.dtype)
        x = rms_norm(x, self.norm, p.rms_norm_eps)
        return _proj(x[:, seq:], self.projector.w, self.projector.b)
