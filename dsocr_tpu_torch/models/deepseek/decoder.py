"""DeepSeek-V2 MoE language decoder (dsocr_tpu/models/deepseek/decoder.py).

RMSNorm → attention with partial RoPE (MLA even/odd regroup) → residual →
RMSNorm → dense SwiGLU (first_k_dense_replace layers) or the DeepSeek-V2
MoE (f32 gating, greedy top-k, shared experts) → residual; final RMSNorm;
f32 lm_head. Residuals are `(x.f32 + y.f32).to(x.dtype)`, as in the
reference.

Weights are the reference's FUSED layout (fuse_decoder_params): qkv_proj,
gateup_proj, shared_gateup and experts_gateup concatenated along their
output dims, [in, out] matrices, one module per layer (the reference's
[L, ...] stacks split). With ``quantize="q8_0"``, ``"q4_k"`` or
``"q6_k"`` the eligible weights (quantize.packed_kind) are packed holders
instead (ops.linear.HOLDERS), each weight in the format it packs with
(a K-quant's fallback is Q8_0), and the layers
dispatch as the reference does (decoder.py:481-507, :567-585): the
routed experts run the packed decode kernels when B·S ≤ 32 and both
stacks are packed (moe_apply_quant_fused, each projection its own
format's kernel), else dequantize to bf16 for the float tiers; a packed
lm_head runs its format's matmul kernel.

Two modes, as the slice needs:

- ``prefill``: S > 1 tokens from an empty cache; attention over the
  prompt's own K/V through ``flash_prefill_attention``; returns the
  last-position logits and the [L, B, NKV, S, D] K/V stacks.
- ``slot_step``: one token per row; row r's K/V is written at
  ``row_lengths[r]`` of the cache (in place) and attends
  ``[0, row_lengths[r]]``: through the slot kernels on a contiguous
  SlotCache, through the paged kernels and the row's page table on a
  PagedSlotCache (the reference's ``page_tables`` branch, decoder.py
  :244-252, :324-381, :403-429: the new token quantized for an int8
  pool, q attending in f32).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops import (
    MoeConfig,
    moe_apply_fused,
    moe_router,
    paged_kv_write_attend,
    partial_rope,
    project,
    rms_norm,
    silu,
    slot_kv_write_attend,
)
from ...ops.kernels import flash_prefill_attention
from ...ops.linear import HOLDERS, Packed
from ...ops.moe import dequant_stack, is_quantized, moe_apply_quant_fused
from ...runtime.paged import PagedSlotCache
from .config import DeepseekV2Config
from .quantize import packed_kind
from .sam import normal_, param


def split_layers(cfg: DeepseekV2Config) -> Tuple[int, int]:
    """(num_dense, num_moe) for the standard dense-prefix pattern."""
    pattern = [cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers)]
    num_dense = pattern.index(True) if True in pattern else len(pattern)
    if not all(pattern[num_dense:]):
        raise NotImplementedError("non-contiguous MoE layer patterns are not supported")
    return num_dense, cfg.num_hidden_layers - num_dense


_FUSED = (
    (("q_proj", "k_proj", "v_proj"), "qkv_proj"),
    (("gate_proj", "up_proj"), "gateup_proj"),
    (("shared_gate", "shared_up"), "shared_gateup"),
    (("experts_gate", "experts_up"), "experts_gateup"),
)


def fuse_decoder_params(params: Dict) -> Dict:
    """Concatenate column-independent projections along their output dims
    (dsocr_tpu/models/deepseek/decoder.py:150): q/k/v → qkv_proj, gate/up →
    gateup_proj, shared gate/up → shared_gateup, expert gate/up →
    experts_gateup — the layout this decoder's layers hold. Takes NumPy
    arrays or tensors; a tree that is already fused passes through."""
    out = dict(params)
    for group in ("dense_layers", "moe_layers"):
        if group not in out:
            continue
        grp = dict(out[group])
        for keys, fused in _FUSED:
            if all(k in grp for k in keys):
                parts = [grp.pop(k) for k in keys]
                if all(isinstance(p, torch.Tensor) for p in parts):
                    grp[fused] = torch.cat(parts, dim=-1)
                else:
                    grp[fused] = np.concatenate([np.asarray(p) for p in parts], axis=-1)
        out[group] = grp
    return out


def _weight(name: str, shape, dtype, device, quantize: Optional[str]):
    """A float parameter, or the holder of the format `quantize` packs it
    with (a Q8_0 fallback under a K-quant where the in dim misses 256)."""
    found = packed_kind(name, shape[-2], quantize) if quantize else None
    if found is None:
        return param(*shape, dtype=dtype, device=device)
    kind, method = found
    return HOLDERS[method].empty(shape, in_major=kind == "experts", device=device)


@torch.no_grad()
def _fill_(w, std: float, gen: torch.Generator, dtype) -> float:
    """Draw N(0, std²) into a parameter, or draw the float weight a holder
    stands for (rounded to the model dtype, as a float model holds it) and
    pack it; returns the seconds spent packing."""
    if not isinstance(w, Packed):
        normal_(w, std, gen)
        return 0.0
    tmp = torch.empty(w.float_shape, dtype=dtype, device=w.codes.device)
    normal_(tmp, std, gen)
    if tmp.is_cuda:
        torch.cuda.synchronize(tmp.device)
    t0 = time.perf_counter()
    w.pack_(tmp)
    if tmp.is_cuda:
        torch.cuda.synchronize(tmp.device)
    return time.perf_counter() - t0


# a layer's weights in registration order (the order random init draws them)
_LAYER_WEIGHTS = (
    "input_layernorm", "post_attention_layernorm", "qkv_proj", "o_proj", "gate_weight",
    "experts_gateup", "experts_down", "shared_gateup", "shared_down", "gateup_proj", "down_proj",
)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, moe: bool, dtype, device,
                 quantize: Optional[str] = None):
        super().__init__()
        H, D, DV = cfg.hidden_size, cfg.head_dim, cfg.resolved_v_head_dim
        NH, NKV = cfg.num_attention_heads, cfg.resolved_kv_heads
        self.moe = moe
        p = lambda *s: param(*s, dtype=dtype, device=device)  # noqa: E731
        w = lambda name, *s: _weight(name, s, dtype, device, quantize)  # noqa: E731
        self.input_layernorm = p(H)
        self.post_attention_layernorm = p(H)
        self.qkv_proj = w("qkv_proj", H, NH * D + NKV * D + NKV * DV)
        self.o_proj = w("o_proj", NH * DV, H)
        if moe:
            E = cfg.n_routed_experts
            MI = cfg.moe_intermediate_size or cfg.intermediate_size
            self.gate_weight = p(E, H)
            self.experts_gateup = w("experts_gateup", E, H, 2 * MI)
            self.experts_down = w("experts_down", E, MI, H)
            SI = MI * (cfg.n_shared_experts or 0)
            if SI:
                self.shared_gateup = w("shared_gateup", H, 2 * SI)
                self.shared_down = w("shared_down", SI, H)
        else:
            I = cfg.intermediate_size  # noqa: E741
            self.gateup_proj = p(H, 2 * I)
            self.down_proj = p(I, H)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> float:
        """Random init at the reference's scales (decoder.py:57-147): every
        matrix N(0, fan_in^-1), norms 1, drawn in registration order (a
        packed holder draws its float weight in its place, so one seed
        gives a packed model the float model's weights). Returns the
        seconds spent packing."""
        packing = 0.0
        for name in _LAYER_WEIGHTS:
            w = getattr(self, name, None)
            if w is None:
                continue
            if name.endswith("layernorm"):
                w.fill_(1.0)
            elif name == "gate_weight":
                normal_(w, w.shape[-1] ** -0.5, gen)
            else:
                fan_in = (w.float_shape if isinstance(w, Packed) else w.shape)[-2]
                packing += _fill_(w, fan_in ** -0.5, gen, self.input_layernorm.dtype)
        return packing


class DeepseekDecoder(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dtype=torch.bfloat16, device=None,
                 quantize: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        num_dense, num_moe = split_layers(cfg)
        H, V = cfg.hidden_size, cfg.vocab_size
        self.embed_tokens = param(V, H, dtype=dtype, device=device)
        self.norm = param(H, dtype=dtype, device=device)
        self.lm_head = _weight("lm_head", (H, V), dtype, device, quantize)
        self.dense_layers = nn.ModuleList(
            DecoderLayer(cfg, False, dtype, device, quantize) for _ in range(num_dense)
        )
        self.moe_layers = nn.ModuleList(
            DecoderLayer(cfg, True, dtype, device, quantize) for _ in range(num_moe)
        )
        self.quantize_s = 0.0  # seconds spent packing at random init (reset_)
        self.moe_cfg = MoeConfig(
            num_experts=cfg.n_routed_experts or 0,
            top_k=cfg.num_experts_per_tok or 1,
            scoring=cfg.scoring_func or "softmax",
            norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        """Random init; ``quantize_s`` records the seconds spent packing."""
        normal_(self.embed_tokens, 0.02, gen)
        self.norm.fill_(1.0)
        self.quantize_s = _fill_(self.lm_head, 0.02, gen, self.dtype)
        for layer in self.layers():
            self.quantize_s += layer.reset_(gen)

    def layers(self):
        return list(self.dense_layers) + list(self.moe_layers)

    # -- blocks -------------------------------------------------------------

    def _qkv(self, x, layer, cos, sin):
        cfg = self.cfg
        B, S, _ = x.shape
        NH, NKV, D, DV = cfg.num_attention_heads, cfg.resolved_kv_heads, cfg.head_dim, cfg.resolved_v_head_dim
        normed = rms_norm(x, layer.input_layernorm, cfg.rms_norm_eps)
        qkv = project(normed, layer.qkv_proj)
        q, k, v = torch.split(qkv, [NH * D, NKV * D, NKV * DV], dim=-1)
        q = q.reshape(B, S, NH, D).transpose(1, 2)
        k = k.reshape(B, S, NKV, D).transpose(1, 2)
        v = v.reshape(B, S, NKV, DV).transpose(1, 2)
        q = partial_rope(q, cos, sin, cfg.rope_dim, cfg.use_mla)
        k = partial_rope(k, cos, sin, cfg.rope_dim, cfg.use_mla)
        return q, k, v

    def _mlp(self, x, layer):
        cfg = self.cfg
        B, S, H = x.shape
        normed = rms_norm(x, layer.post_attention_layernorm, cfg.rms_norm_eps)
        if not layer.moe:
            gate, up = torch.chunk(project(normed, layer.gateup_proj).float(), 2, dim=-1)
            mlp = project((silu(gate) * up).to(x.dtype), layer.down_proj)
            return (x.float() + mlp.float()).to(x.dtype)
        tokens = normed.reshape(B * S, H)
        weights, indices = moe_router(tokens, layer.gate_weight, self.moe_cfg)
        egu, ed = layer.experts_gateup, layer.experts_down
        if is_quantized(egu) and is_quantized(ed) and B * S <= 32:
            routed = moe_apply_quant_fused(tokens, weights, indices, egu, ed)
        else:  # float stacks, or prefill of packed ones: bf16 weights, grouped tier
            routed = moe_apply_fused(tokens, weights, indices,
                                     dequant_stack(egu).to(x.dtype), dequant_stack(ed).to(x.dtype))
        out = routed.float()
        if hasattr(layer, "shared_gateup"):
            sg, su = torch.chunk(project(normed, layer.shared_gateup).float(), 2, dim=-1)
            shared = project((silu(sg) * su).to(x.dtype), layer.shared_down)
            out = out + shared.reshape(B * S, H).float()
        return (x.float() + out.reshape(B, S, H)).to(x.dtype)

    def _residual_attn(self, x, attn, layer):
        attn = project(attn, layer.o_proj)
        return (x.float() + attn.float()).to(x.dtype)

    def _logits(self, x, last_index: Optional[torch.Tensor]) -> torch.Tensor:
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        if last_index is None:
            x_last = x[:, -1]
        else:
            x_last = x[torch.arange(x.shape[0], device=x.device), last_index]
        if isinstance(self.lm_head, Packed):
            return self.lm_head.matmul(x_last.contiguous())
        return torch.matmul(x_last.float(), self.lm_head.float())

    # -- modes ----------------------------------------------------------------

    def prefill(
        self,
        embeds: torch.Tensor,  # [B, S, H]
        positions: torch.Tensor,  # [B, S] absolute positions
        rope: Tuple[torch.Tensor, torch.Tensor],
        *,
        last_index: Optional[torch.Tensor] = None,  # [B]
    ):
        """→ (logits [B, V] f32 at last_index, k [L, B, NKV, S, D], v).
        Rows are right-padded, so no query is masked out entirely."""
        cfg = self.cfg
        B, S, _ = embeds.shape
        dev = embeds.device
        cos = rope[0][positions][:, None]
        sin = rope[1][positions][:, None]
        pad_start = torch.zeros((B,), dtype=torch.int32, device=dev)
        L, NKV = cfg.num_hidden_layers, cfg.resolved_kv_heads
        k_all = torch.empty((L, B, NKV, S, cfg.head_dim), dtype=embeds.dtype, device=dev)
        v_all = torch.empty((L, B, NKV, S, cfg.resolved_v_head_dim), dtype=embeds.dtype, device=dev)
        scale = cfg.head_dim ** -0.5
        x = embeds
        for li, layer in enumerate(self.layers()):
            q, k, v = self._qkv(x, layer, cos, sin)
            k_all[li] = k
            v_all[li] = v
            attn = flash_prefill_attention(
                q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous(),
                pad_start, scale=scale,
            )
            x = self._mlp(self._residual_attn(x, attn, layer), layer)
        return self._logits(x, last_index), k_all, v_all

    def slot_step(
        self,
        embeds: torch.Tensor,  # [B, 1, H]
        positions: torch.Tensor,  # [B, 1]
        rope: Tuple[torch.Tensor, torch.Tensor],
        cache,  # SlotCache or PagedSlotCache, optional scales — updated in place
    ) -> torch.Tensor:
        """One token per row → logits [B, V] f32; row r's K/V lands at
        cache.lengths[r] (lengths are NOT bumped here)."""
        cos = rope[0][positions][:, None]
        sin = rope[1][positions][:, None]
        scale = self.cfg.head_dim ** -0.5
        paged = isinstance(cache, PagedSlotCache)
        x = embeds
        for li, layer in enumerate(self.layers()):
            q, k, v = self._qkv(x, layer, cos, sin)
            if paged:
                attn = paged_kv_write_attend(
                    q, k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.tables, li,
                    cache.lengths, scale,
                )
            else:
                attn = slot_kv_write_attend(
                    q, k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, li,
                    cache.lengths, scale,
                )
            x = self._mlp(self._residual_attn(x, attn, layer), layer)
        return self._logits(x, None)
