"""The dense grouped-query decoder that PaddleOCR-VL (Ernie-4.5), DotsOCR
(Qwen2) and GLM-OCR share, and the conversion of the reference's trees
into its state_dicts.

RMSNorm → grouped-query attention (NH query heads over NKV KV heads of D,
with q/k/v biases where the config's ``attention_bias`` says) under the
family's rotary → residual → RMSNorm → SwiGLU MLP → residual; final
RMSNorm; f32 logits through the lm_head, or the embeddings' transpose
when tied. Residuals are ``(x.f32 + y.f32).to(x.dtype)``. The config
names its KV heads ``resolved_num_key_value_heads``; a subclass gives the
rotary (``rope``: positions → (cos, sin); ``rotate``: q or k by them) and
may change the layer (``LAYER``).

One module per layer (the reference's [L, ...] stacks split), in the
fused layout the reference's engines serve (``fuse_gqa_params``:
qkv_proj with qkv_bias, gateup_proj) or the split one of their inits and
loaders. Every projection goes through ``ops.linear.project``: with
``quantize`` the layers' linears and an untied lm_head are packed holders
(gqa_quantize.packed_kind), whose row matmul kernels (``q8_matmul`` and
the K-quant twins) run prefill and decode alike, as the reference's do.

Modes, as the DeepSeek decoder's:

- ``forward``: over a contiguous KVCache (runtime/kv_cache.py) from
  ``cache.length``; S > 1 from an empty cache with ``flash_prefill``
  attends the tokens' own K/V through ``flash_prefill_attention``
  (grouped KV heads), otherwise plain torch over the cache under the
  causal mask;
- ``prefill``: a forward over a fresh cache of S positions → the
  [L, B, NKV, S, D] K/V stacks of the slot join packets;
- ``slot_step``: one token per row through ``slot_kv_write_attend``
  (``slot_kv_write`` + ``slot_decode_attention``).

Each mode takes a ``share`` (a ``HeadShare``: a mesh rank's block of KV
heads and the query heads that read them, q head h reading KV head
h // (NH / NKV)): the replicated q/k/v projection is sliced to those
heads, which are rotated, written and attended alone, and their
attention outputs are gathered over the rank's mp group
(``share.gather``) before the replicated o_proj. The per-head
arithmetic is the single process's; nothing is reduced
(models/gqa_mesh.py). ``embed_row`` and ``prefill_rows`` build a
wave's right-padded rows and prefill them, in one process or on each
rank alike.

``params_from_jax`` converts a reference engine's {"decoder", and the
tower's parts} tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops import attention, causal_mask, project, rms_norm, silu, slot_kv_write_attend
from ..ops.kernels import flash_prefill_attention
from ..ops.linear import HOLDERS, Packed
from ..runtime.kv_cache import KVCache, init_kv_cache, layer_kv, write_kv
from .deepseek.convert import _flatten, _from_planes, _tensors
from .deepseek.decoder import _fill_
from .deepseek.sam import normal_, param
from .gqa_quantize import packed_kind

@dataclasses.dataclass(frozen=True)
class HeadShare:
    """A mesh rank's heads: KV heads [kv0, kv0 + nkv) and query heads [q0,
    q0 + nq); ``gather`` joins the mp group's attention outputs [B, S,
    nq·D] along the last dim, in head order."""

    kv0: int
    nkv: int
    q0: int
    nq: int
    gather: Callable[[torch.Tensor], torch.Tensor]


def embed_row(decoder, tokens: Sequence[int], image_mask: Sequence[int], images: Optional[torch.Tensor],
              s_pad: int, dtype) -> torch.Tensor:
    """One row right-padded to s_pad → embeds [s_pad, H]: the token
    embeddings, the image tokens' rows replaced by `images` [n, H]."""
    dev = decoder.embed_tokens.device
    padded = np.zeros(s_pad, np.int64)
    padded[: len(tokens)] = tokens
    embeds = decoder.embed_tokens[torch.from_numpy(padded).to(dev)].to(dtype)
    if images is not None:
        idx = np.nonzero(np.asarray(image_mask, bool))[0]
        embeds[torch.from_numpy(idx).to(dev)] = images.to(dtype)
    return embeds


def prefill_rows(decoder, dtype, tokens, masks, images, positions: np.ndarray, s_pad: int,
                 share: Optional[HeadShare] = None):
    """Rows (token lists, image masks, image embeddings or None) of one
    s_pad bucket, their positions in the decoder's layout ([B, s_pad], or
    [3, B, s_pad] for M-RoPE) → (logits [B, V] at each row's last token,
    k, v [L, B, heads, s_pad, D]) from one batched prefill."""
    dev = decoder.embed_tokens.device
    embeds = torch.stack([embed_row(decoder, t, m, img, s_pad, dtype) for t, m, img in zip(tokens, masks, images)])
    lens = torch.tensor([len(t) for t in tokens], device=dev)
    return decoder.prefill(embeds, torch.from_numpy(np.ascontiguousarray(positions)).to(dev),
                           last_index=lens - 1, share=share)


_FUSED = ((("q_proj", "k_proj", "v_proj"), "qkv_proj"), (("q_bias", "k_bias", "v_bias"), "qkv_bias"),
          (("gate_proj", "up_proj"), "gateup_proj"))
_PACKED_PARTS = ("codes", "scales", "mins", "highs")


def fuse_gqa_params(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """q/k/v → qkv_proj (their biases → qkv_bias, where the decoder has
    them) and gate/up → gateup_proj along the output dims in a state_dict
    (``...layers.{i}.{key}``, or ``...{key}.{part}`` for a packed weight,
    concatenated along its row layout's out axis); the same function,
    half the decode projections. A fused state passes through."""
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


def _weight(name: str, shape, dtype, device, quantize: Optional[str]):
    """A float parameter, or the row-layout holder of the format it packs
    with."""
    method = packed_kind(name, shape[-2], quantize) if quantize else None
    if method is None:
        return param(*shape, dtype=dtype, device=device)
    return HOLDERS[method].empty(shape, in_major=False, device=device)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference engine's NumPy tree → state_dict: every part beside
    the decoder (``vision``, PaddleOCR-VL's ``projector``) flattens by its
    keys (a layer or block list by index); the decoder's [L, ...]
    ``layers`` stacks split one entry per layer
    (``decoder.layers.{i}.qkv_proj``), fused or split as the tree is. A
    packed Q8_0 weight ({codes, scales}) splits per layer the same way
    (``...qkv_proj.codes``); a packed lm_head becomes
    ``decoder.lm_head.codes``. K-quant plane dicts take the port's layout
    as the DeepSeek converter gives it."""
    flat: Dict[str, np.ndarray] = {}
    for part, node in tree.items():
        if part != "decoder":
            _flatten(part, node, flat)
    decoder = dict(tree["decoder"])
    for key, stack in decoder.pop("layers").items():
        stack = _from_planes(stack, in_major=False)
        for part, arr in (stack.items() if isinstance(stack, dict) else [("", stack)]):
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                flat[f"decoder.layers.{i}.{key}" + (f".{part}" if part else "")] = arr[i]
    if isinstance(decoder.get("lm_head"), dict):
        decoder["lm_head"] = _from_planes(decoder["lm_head"], in_major=False)
    _flatten("decoder", decoder, flat)
    return _tensors(flat)


_LAYER_WEIGHTS = ("input_layernorm", "post_attention_layernorm", "qkv_proj", "q_proj", "k_proj",
                  "v_proj", "o_proj", "gateup_proj", "gate_proj", "up_proj", "down_proj")
_BIASES = ("qkv_bias", "q_bias", "k_bias", "v_bias")


class GqaLayer(nn.Module):
    """One layer's weights, with the q/k/v biases where the config has
    them."""

    def __init__(self, cfg, dtype, device, quantize: Optional[str], split: bool):
        super().__init__()
        H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size  # noqa: E741
        NH, NKV = cfg.num_attention_heads, cfg.resolved_num_key_value_heads
        self.split = split

        def weights(fused: str, names, outs):
            if split:
                for name, o in zip(names, outs, strict=True):
                    setattr(self, name, _weight(name, (H, o), dtype, device, quantize))
            else:
                setattr(self, fused, _weight(fused, (H, sum(outs)), dtype, device, quantize))

        self.input_layernorm = param(H, dtype=dtype, device=device)
        self.post_attention_layernorm = param(H, dtype=dtype, device=device)
        weights("qkv_proj", ("q_proj", "k_proj", "v_proj"), (NH * D, NKV * D, NKV * D))
        if cfg.attention_bias:
            outs = (NH * D, NKV * D, NKV * D)
            for name, o in zip(("q_bias", "k_bias", "v_bias"), outs) if split else [("qkv_bias", sum(outs))]:
                setattr(self, name, param(o, dtype=dtype, device=device))
        self.o_proj = _weight("o_proj", (NH * D, H), dtype, device, quantize)
        weights("gateup_proj", ("gate_proj", "up_proj"), (I, I))
        self.down_proj = _weight("down_proj", (I, H), dtype, device, quantize)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Matrices N(0, fan_in^-1), norms 1, biases 0 (the reference's inits),
        drawn in registration order; a packed holder draws its float
        weight and packs it."""
        for name in _BIASES:
            if hasattr(self, name):
                getattr(self, name).zero_()
        for name in _LAYER_WEIGHTS:
            w = getattr(self, name, None)
            if w is None:
                continue
            if name.endswith("layernorm"):
                w.fill_(1.0)
            else:
                fan_in = (w.float_shape if isinstance(w, Packed) else w.shape)[-2]
                _fill_(w, fan_in ** -0.5, gen, self.input_layernorm.dtype)


class GqaDecoder(nn.Module):
    """The dense GQA decoder; a subclass gives its rotary (``rope``,
    ``rotate``) and may change the layer class (``LAYER``)."""

    LAYER = GqaLayer

    def __init__(self, cfg, dtype=torch.bfloat16, device=None,
                 quantize: Optional[str] = None, *, split: bool = False):
        super().__init__()
        self.cfg = cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        self.n_kv = cfg.resolved_num_key_value_heads
        self.embed_tokens = param(V, H, dtype=dtype, device=device)
        self.norm = param(H, dtype=dtype, device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _weight("lm_head", (H, V), dtype, device, quantize)
        self.layers = nn.ModuleList(
            self.LAYER(cfg, dtype, device, quantize, split) for _ in range(cfg.num_hidden_layers))

    def rope(self, position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Positions → (cos, sin) [B, S, ·] f32."""
        raise NotImplementedError

    @staticmethod
    def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """q or k [B, H, S, D] rotated by (cos, sin), in x's dtype."""
        raise NotImplementedError

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

    def heads(self, share: Optional[HeadShare]) -> Tuple[int, int, int, int]:
        """(q0, nq, kv0, nkv): the heads `share` names, else all."""
        if share is None:
            return 0, self.cfg.num_attention_heads, 0, self.n_kv
        return share.q0, share.nq, share.kv0, share.nkv

    def _split_heads(self, q, k, v, share, cos, sin, rotate):
        """q/k/v [B, S, ·] of every head → the share's heads [B, heads, S,
        D], q and k rotated."""
        B, S, _ = q.shape
        D = self.cfg.head_dim
        q0, nq, kv0, nkv = self.heads(share)
        q = q[..., q0 * D : (q0 + nq) * D].reshape(B, S, nq, D).transpose(1, 2)
        k = k[..., kv0 * D : (kv0 + nkv) * D].reshape(B, S, nkv, D).transpose(1, 2)
        v = v[..., kv0 * D : (kv0 + nkv) * D].reshape(B, S, nkv, D).transpose(1, 2)
        return rotate(q, cos, sin), rotate(k, cos, sin), v

    def _qkv(self, x, layer, cos, sin, share=None):
        cfg = self.cfg
        NH, NKV, D = cfg.num_attention_heads, self.n_kv, cfg.head_dim
        normed = rms_norm(x, layer.input_layernorm, cfg.rms_norm_eps)
        if layer.split:
            q, k, v = (project(normed, getattr(layer, f"{n}_proj"), getattr(layer, f"{n}_bias", None))
                       for n in "qkv")
        else:
            qkv = project(normed, layer.qkv_proj, getattr(layer, "qkv_bias", None))
            q, k, v = torch.split(qkv, [NH * D, NKV * D, NKV * D], dim=-1)
        return self._split_heads(q, k, v, share, cos, sin, self.rotate)

    @staticmethod
    def _attend(li, q, k, v, attend, share):
        """The share's attention outputs, gathered over its mp group."""
        out = attend(li, q, k, v)
        return out if share is None else share.gather(out)

    def _mlp(self, x, layer):
        normed = rms_norm(x, layer.post_attention_layernorm, self.cfg.rms_norm_eps)
        if layer.split:
            gate, up = (project(normed, w).float() for w in (layer.gate_proj, layer.up_proj))
        else:
            gate, up = torch.chunk(project(normed, layer.gateup_proj).float(), 2, dim=-1)
        mlp = project((silu(gate) * up).to(x.dtype), layer.down_proj)
        return (x.float() + mlp.float()).to(x.dtype)

    def _layers(self, x, position_ids, attend, share=None):
        cos, sin = self.rope(position_ids)
        for li, layer in enumerate(self.layers):
            q, k, v = self._qkv(x, layer, cos, sin, share)
            attn = project(self._attend(li, q, k, v, attend, share), layer.o_proj)
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
        position_ids: torch.Tensor,  # what rope takes: [B, S], or [3, B, S] for M-RoPE
        cache: KVCache,  # written in place at [length, length + S)
        *,
        full_logits: bool = False,
        last_index: Optional[torch.Tensor] = None,  # [B]
        flash_prefill: bool = False,
        share: Optional[HeadShare] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        """The reference's forward (ernie_forward, qwen2_forward,
        glm_forward) over a contiguous KVCache of the share's KV heads →
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

        x = self._layers(embeds, position_ids, attend, share)
        return self._logits(x, last_index, full_logits), cache

    def prefill(self, embeds: torch.Tensor, position_ids: torch.Tensor, *,
                last_index: Optional[torch.Tensor] = None, share: Optional[HeadShare] = None):
        """→ (logits [B, V] f32 at last_index, k [L, B, NKV, S, D], v): a
        forward over a fresh cache of S positions (the share's NKV)."""
        cfg = self.cfg
        B, S, _ = embeds.shape
        cache = init_kv_cache(cfg.num_hidden_layers, B, self.heads(share)[3], S,
                              cfg.head_dim, cfg.head_dim, embeds.dtype, embeds.device)
        logits, cache = self.forward(embeds, position_ids, cache, last_index=last_index,
                                     flash_prefill=True, share=share)
        return logits, cache.k, cache.v

    def slot_step(self, embeds: torch.Tensor, position_ids: torch.Tensor, cache,
                  share: Optional[HeadShare] = None) -> torch.Tensor:
        """One token per row (embeds [B, 1, H], position_ids of one step) →
        logits [B, V] f32; row r's K/V lands at cache.lengths[r] (lengths
        NOT bumped). The cache holds the share's KV heads."""
        scale = 1.0 / (self.cfg.head_dim ** 0.5)

        def attend(li, q, k, v):
            return slot_kv_write_attend(q, k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, li,
                                        cache.lengths, scale)

        return self._logits(self._layers(embeds, position_ids, attend, share), None)
