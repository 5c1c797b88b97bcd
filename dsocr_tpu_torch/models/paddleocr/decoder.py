"""PaddleOCR-VL's Ernie-4.5 decoder with 3-axis M-RoPE
(dsocr_tpu/models/paddleocr/decoder.py).

RMSNorm → grouped-query attention (16 query heads over 2 KV heads of 128
at the published width) with the multimodal rotary: per-axis cos/sin
tables sliced by the doubled mrope sections (``mrope_cos_sin``) →
residual → RMSNorm → SwiGLU MLP → residual; final RMSNorm; f32 logits
through the lm_head, or the embeddings' transpose when tied (the
published model ties them). Residuals are ``(x.f32 + y.f32).to(x.dtype)``.

One module per layer (the reference's [L, ...] stacks split), in the
fused layout the reference's engine serves (``fuse_ernie_params``:
qkv_proj, gateup_proj) or the split one of its init and loader. Every
projection goes through ``ops.linear.project``: with ``quantize`` the
layers' linears and an untied lm_head are packed holders
(quantize.packed_kind), whose row matmul kernels (``q8_matmul`` and the
K-quant twins) run prefill and decode alike, as the reference's do.

Modes, as the DeepSeek decoder's:

- ``forward``: over a contiguous KVCache (runtime/kv_cache.py) from
  ``cache.length``; S > 1 from an empty cache with ``flash_prefill``
  attends the tokens' own K/V through ``flash_prefill_attention``
  (grouped KV heads), otherwise plain torch over the cache under the
  causal mask;
- ``prefill``: a forward over a fresh cache of S positions → the
  [L, B, NKV, S, D] K/V stacks of the slot join packets;
- ``slot_step``: one token per row through ``slot_kv_write_attend``
  (``slot_kv_write`` + ``slot_decode_attention`` at NH / NKV = 8).

``compute_position_ids`` builds a row's M-RoPE positions on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops import attention, causal_mask, project, rms_norm, rotate_half, silu, slot_kv_write_attend
from ...ops.kernels import flash_prefill_attention
from ...ops.linear import HOLDERS, Packed
from ...runtime.kv_cache import KVCache, init_kv_cache, layer_kv, write_kv
from ..deepseek.decoder import _fill_
from ..deepseek.sam import normal_, param
from .config import PaddleConfig
from .quantize import packed_kind

_FUSED = ((("q_proj", "k_proj", "v_proj"), "qkv_proj"), (("gate_proj", "up_proj"), "gateup_proj"))
_PACKED_PARTS = ("codes", "scales", "mins", "highs")


def fuse_ernie_params(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """q/k/v → qkv_proj and gate/up → gateup_proj along the output dims in
    a state_dict (``...layers.{i}.{key}``, or ``...{key}.{part}`` for a
    packed weight, concatenated along its row layout's out axis); the
    same function, half the decode projections. A fused state passes
    through."""
    out = dict(state)
    for key in state:
        head, _, name = key.rpartition(".")
        part = ""
        if name in _PACKED_PARTS:
            part = "." + name
            head, _, name = head.rpartition(".")
        if head.split(".")[-2:-1] != ["layers"]:
            continue
        for names, fused in _FUSED:
            srcs = [f"{head}.{n}{part}" for n in names]
            if name == names[0] and all(src in out for src in srcs):
                out[f"{head}.{fused}{part}"] = torch.cat([out.pop(src) for src in srcs],
                                                         dim=-2 if part else -1)
    return out


def _ernie_weight(name: str, shape, dtype, device, quantize: Optional[str]):
    """A float parameter, or the row-layout holder of the format it packs
    with."""
    method = packed_kind(name, shape[-2], quantize) if quantize else None
    if method is None:
        return param(*shape, dtype=dtype, device=device)
    return HOLDERS[method].empty(shape, in_major=False, device=device)


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


_LAYER_WEIGHTS = ("input_layernorm", "post_attention_layernorm", "qkv_proj", "q_proj", "k_proj",
                  "v_proj", "o_proj", "gateup_proj", "gate_proj", "up_proj", "down_proj")


class ErnieLayer(nn.Module):
    def __init__(self, cfg: PaddleConfig, dtype, device, quantize: Optional[str], split: bool):
        super().__init__()
        H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size  # noqa: E741
        NH, NKV = cfg.num_attention_heads, cfg.resolved_num_key_value_heads
        self.split = split

        def weights(fused: str, names, outs):
            if split:
                for name, o in zip(names, outs, strict=True):
                    setattr(self, name, _ernie_weight(name, (H, o), dtype, device, quantize))
            else:
                setattr(self, fused, _ernie_weight(fused, (H, sum(outs)), dtype, device, quantize))

        self.input_layernorm = param(H, dtype=dtype, device=device)
        self.post_attention_layernorm = param(H, dtype=dtype, device=device)
        weights("qkv_proj", ("q_proj", "k_proj", "v_proj"), (NH * D, NKV * D, NKV * D))
        self.o_proj = _ernie_weight("o_proj", (NH * D, H), dtype, device, quantize)
        weights("gateup_proj", ("gate_proj", "up_proj"), (I, I))
        self.down_proj = _ernie_weight("down_proj", (I, H), dtype, device, quantize)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Matrices N(0, fan_in^-1), norms 1 (decoder.py:33-97), drawn in
        registration order; a packed holder draws its float weight and
        packs it."""
        for name in _LAYER_WEIGHTS:
            w = getattr(self, name, None)
            if w is None:
                continue
            if name.endswith("layernorm"):
                w.fill_(1.0)
            else:
                fan_in = (w.float_shape if isinstance(w, Packed) else w.shape)[-2]
                _fill_(w, fan_in ** -0.5, gen, self.input_layernorm.dtype)


class ErnieDecoder(nn.Module):
    def __init__(self, cfg: PaddleConfig, dtype=torch.bfloat16, device=None,
                 quantize: Optional[str] = None, *, split: bool = False):
        super().__init__()
        self.cfg = cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        self.embed_tokens = param(V, H, dtype=dtype, device=device)
        self.norm = param(H, dtype=dtype, device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _ernie_weight("lm_head", (H, V), dtype, device, quantize)
        self.layers = nn.ModuleList(ErnieLayer(cfg, dtype, device, quantize, split)
                                    for _ in range(cfg.num_hidden_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        normal_(self.embed_tokens, 0.02, gen)
        self.norm.fill_(1.0)
        for layer in self.layers:
            layer.reset_(gen)
        if hasattr(self, "lm_head"):
            _fill_(self.lm_head, 0.02, gen, self.dtype)

    # -- blocks -------------------------------------------------------------

    def _qkv(self, x, layer, cos, sin):
        cfg = self.cfg
        B, S, _ = x.shape
        NH, NKV, D = cfg.num_attention_heads, cfg.resolved_num_key_value_heads, cfg.head_dim
        normed = rms_norm(x, layer.input_layernorm, cfg.rms_norm_eps)
        if layer.split:
            q, k, v = (project(normed, w) for w in (layer.q_proj, layer.k_proj, layer.v_proj))
        else:
            q, k, v = torch.split(project(normed, layer.qkv_proj), [NH * D, NKV * D, NKV * D], dim=-1)
        q = _apply_mrope(q.reshape(B, S, NH, D).transpose(1, 2), cos, sin)
        k = _apply_mrope(k.reshape(B, S, NKV, D).transpose(1, 2), cos, sin)
        return q, k, v.reshape(B, S, NKV, D).transpose(1, 2)

    def _mlp(self, x, layer):
        normed = rms_norm(x, layer.post_attention_layernorm, self.cfg.rms_norm_eps)
        if layer.split:
            gate, up = (project(normed, w).float() for w in (layer.gate_proj, layer.up_proj))
        else:
            gate, up = torch.chunk(project(normed, layer.gateup_proj).float(), 2, dim=-1)
        mlp = project((silu(gate) * up).to(x.dtype), layer.down_proj)
        return (x.float() + mlp.float()).to(x.dtype)

    def _layers(self, x, position_ids, attend):
        cos, sin = mrope_cos_sin(position_ids, self.cfg)
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(x, layer, cos, sin)
            attn = project(attend(li, q, k, v), layer.o_proj)
            x = self._mlp((x.float() + attn.float()).to(x.dtype), layer)
        return x

    def _logits(self, x, last_index: Optional[torch.Tensor], full_logits: bool = False) -> torch.Tensor:
        """f32 logits at every position ([B, S, V]) or at last_index ([B, V],
        default the last position); the tied head is embed_tokens.T."""
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        if full_logits:
            rows = x.reshape(-1, x.shape[-1])
        elif last_index is None:
            rows = x[:, -1]
        else:
            rows = x[torch.arange(x.shape[0], device=x.device), last_index]
        head = getattr(self, "lm_head", None)
        if isinstance(head, Packed):
            logits = head.matmul(rows.float().contiguous())
        elif head is None:
            logits = torch.matmul(rows.float(), self.embed_tokens.float().t())
        else:
            logits = torch.matmul(rows.float(), head.float())
        return logits.reshape(*x.shape[:2], -1) if full_logits else logits

    # -- modes ----------------------------------------------------------------

    def forward(
        self,
        embeds: torch.Tensor,  # [B, S, H]
        position_ids: torch.Tensor,  # [3, B, S]
        cache: KVCache,  # written in place at [length, length + S)
        *,
        full_logits: bool = False,
        last_index: Optional[torch.Tensor] = None,  # [B]
        flash_prefill: bool = False,
    ) -> Tuple[torch.Tensor, KVCache]:
        """The reference's ernie_forward over a contiguous KVCache →
        (logits, cache), the length not bumped. Rows are right-padded, so
        the prefill has no left pads."""
        if cache.k_scale is not None:
            raise ValueError("int8 KV cache supports slot decode steps only")
        B, S, _ = embeds.shape
        dev = embeds.device
        start = cache.length
        scale = 1.0 / (self.cfg.head_dim ** 0.5)
        flash = flash_prefill and S > 1
        if flash:
            if start != 0:
                raise ValueError(f"flash prefill starts from an empty cache, not at {start}")
            pad = torch.zeros((B,), dtype=torch.int32, device=dev)
        else:
            mask = causal_mask(S, cache.max_len, start, dev)[None, None]

        def attend(li, q, k, v):
            write_kv(cache, li, k, v, start)
            if flash:
                return flash_prefill_attention(q.contiguous(), k.to(q.dtype).contiguous(),
                                               v.to(q.dtype).contiguous(), pad, scale=scale)
            k_layer, v_layer = layer_kv(cache, li)
            return attention(q, k_layer.to(q.dtype), v_layer.to(q.dtype), mask, scale)

        x = self._layers(embeds, position_ids, attend)
        return self._logits(x, last_index, full_logits), cache

    def prefill(self, embeds: torch.Tensor, position_ids: torch.Tensor, *,
                last_index: Optional[torch.Tensor] = None):
        """→ (logits [B, V] f32 at last_index, k [L, B, NKV, S, D], v): a
        forward over a fresh cache of S positions."""
        cfg = self.cfg
        B, S, _ = embeds.shape
        cache = init_kv_cache(cfg.num_hidden_layers, B, cfg.resolved_num_key_value_heads, S,
                              cfg.head_dim, cfg.head_dim, embeds.dtype, embeds.device)
        logits, cache = self.forward(embeds, position_ids, cache, last_index=last_index,
                                     flash_prefill=True)
        return logits, cache.k, cache.v

    def slot_step(self, embeds: torch.Tensor, position_ids: torch.Tensor, cache) -> torch.Tensor:
        """One token per row (embeds [B, 1, H], position_ids [3, B, 1]) →
        logits [B, V] f32; row r's K/V lands at cache.lengths[r] (lengths
        NOT bumped)."""
        scale = 1.0 / (self.cfg.head_dim ** 0.5)

        def attend(li, q, k, v):
            return slot_kv_write_attend(q, k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, li,
                                        cache.lengths, scale)

        return self._logits(self._layers(embeds, position_ids, attend), None)
