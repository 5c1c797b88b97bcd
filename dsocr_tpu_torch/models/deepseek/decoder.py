"""DeepSeek-V2 MoE language decoder (dsocr_tpu/models/deepseek/decoder.py).

RMSNorm → attention with partial RoPE (MLA even/odd regroup) → residual →
RMSNorm → dense SwiGLU (first_k_dense_replace layers) or the DeepSeek-V2
MoE (f32 gating, greedy top-k, shared experts) → residual; final RMSNorm;
f32 lm_head. Residuals are `(x.f32 + y.f32).to(x.dtype)`, as in the
reference.

A decoder holds one of the reference's two weight layouts, [in, out]
matrices, one module per layer (the reference's [L, ...] stacks split):

- fused (fuse_decoder_params; what the engine serves): qkv_proj,
  gateup_proj, shared_gateup and experts_gateup concatenated along their
  output dims;
- split (what the reference's init and loader produce; a decoder built by
  ``from_state`` on a split state): q_proj/k_proj/v_proj,
  gate_proj/up_proj, shared_gate/shared_up and experts_gate/experts_up.

The blocks branch on the layout as the reference's do (decoder.py
:483-545). With ``quantize="q8_0"``, ``"q4_k"`` or ``"q6_k"`` the
eligible weights (quantize.packed_kind) are packed holders instead
(ops.linear.HOLDERS), each weight in the format it packs with (a
K-quant's fallback is Q8_0), and the layers dispatch as the reference
does (decoder.py:481-545, :567-585): the routed experts run the packed
decode kernels when B·S ≤ 32 and every stack is packed
(moe_apply_quant_fused or moe_apply_quant, each projection its own
format's kernel), else dequantize to bf16 for the float tiers (a mixed
group, where one projection's in dim misses the block size, too); a
packed lm_head runs its format's matmul kernel.

One layer body serves three modes, which differ only in how a layer's
attention reads and writes K/V:

- ``forward``: the reference's deepseek_forward over a contiguous
  KVCache (runtime/kv_cache.py): S tokens written at ``cache.length``;
  at S > 1 from an empty cache with ``flash_prefill``, attention over the
  tokens' own K/V through ``flash_prefill_attention``, else over the
  cache under a causal (and left-pad) mask in plain torch, as the
  reference attends there without a Pallas kernel;
- ``prefill``: a forward over a fresh cache of S positions, returning
  the [L, B, NKV, S, D] K/V stacks (the slot join packets);
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

import torch
import torch.nn as nn

from ...ops import (
    MoeConfig,
    attention,
    causal_mask,
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
from ...ops.moe import dequant_stack, is_quantized, moe_apply, moe_apply_quant, moe_apply_quant_fused
from ...runtime.kv_cache import KVCache, init_kv_cache, layer_kv, write_kv
from ...runtime.paged import PagedSlotCache
from .config import DeepseekV2Config
from .quantize import EXPERT_KEYS, packed_kind
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


_PACKED_PARTS = ("codes", "scales", "mins", "highs")


def fuse_decoder_params(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Concatenate column-independent projections along their output dims
    (dsocr_tpu/models/deepseek/decoder.py:150) in a state_dict
    (``...{group}.{i}.{key}``, or ``...{key}.{part}`` for a packed one): q/k/v
    → qkv_proj, gate/up → gateup_proj, shared gate/up → shared_gateup,
    expert gate/up → experts_gateup. A packed weight concatenates part by
    part along its out axis (last in-major, second to last in the row
    layout): every Q8_0 / K-quant block lies within one output column, so
    this equals packing the fused weight. A fused state passes through."""
    out = dict(state)
    for key in state:
        head, _, name = key.rpartition(".")
        part = ""
        if name in _PACKED_PARTS:
            part = "." + name
            head, _, name = head.rpartition(".")
        if head.split(".")[-2:-1] not in (["dense_layers"], ["moe_layers"]):
            continue  # only the decoder's layers fuse
        for names, fused in _FUSED:
            srcs = [f"{head}.{n}{part}" for n in names]
            if name == names[0] and all(src in out for src in srcs):
                axis = -2 if part and fused not in EXPERT_KEYS else -1
                out[f"{head}.{fused}{part}"] = torch.cat([out.pop(src) for src in srcs], dim=axis)
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


# a layer's weights in registration order (the order random init draws
# them); a layer holds the fused or the split names of each group
_LAYER_WEIGHTS = (
    "input_layernorm", "post_attention_layernorm", "qkv_proj", "q_proj", "k_proj", "v_proj",
    "o_proj", "gate_weight", "experts_gateup", "experts_gate", "experts_up", "experts_down",
    "shared_gateup", "shared_gate", "shared_up", "shared_down", "gateup_proj", "gate_proj",
    "up_proj", "down_proj",
)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, moe: bool, dtype, device,
                 quantize: Optional[str] = None, split: bool = False):
        super().__init__()
        H, D, DV = cfg.hidden_size, cfg.head_dim, cfg.resolved_v_head_dim
        NH, NKV = cfg.num_attention_heads, cfg.resolved_kv_heads
        self.moe = moe
        self.split = split

        def weights(fused: str, names, *shape_in, outs):
            """One fused weight, or one weight per part (split layout)."""
            if split:
                for name, o in zip(names, outs, strict=True):
                    setattr(self, name, _weight(name, (*shape_in, o), dtype, device, quantize))
            else:
                setattr(self, fused, _weight(fused, (*shape_in, sum(outs)), dtype, device, quantize))

        self.input_layernorm = param(H, dtype=dtype, device=device)
        self.post_attention_layernorm = param(H, dtype=dtype, device=device)
        weights("qkv_proj", ("q_proj", "k_proj", "v_proj"), H, outs=(NH * D, NKV * D, NKV * DV))
        self.o_proj = _weight("o_proj", (NH * DV, H), dtype, device, quantize)
        if moe:
            E = cfg.n_routed_experts
            MI = cfg.moe_intermediate_size or cfg.intermediate_size
            self.gate_weight = param(E, H, dtype=dtype, device=device)
            weights("experts_gateup", ("experts_gate", "experts_up"), E, H, outs=(MI, MI))
            self.experts_down = _weight("experts_down", (E, MI, H), dtype, device, quantize)
            SI = MI * (cfg.n_shared_experts or 0)
            if SI:
                weights("shared_gateup", ("shared_gate", "shared_up"), H, outs=(SI, SI))
                self.shared_down = _weight("shared_down", (SI, H), dtype, device, quantize)
        else:
            I = cfg.intermediate_size  # noqa: E741
            weights("gateup_proj", ("gate_proj", "up_proj"), H, outs=(I, I))
            self.down_proj = param(I, H, dtype=dtype, device=device)

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
                 quantize: Optional[str] = None, *, split: bool = False):
        """The fused layout; ``split`` builds the split one (what
        ``from_state`` does for a split state)."""
        super().__init__()
        self.cfg = cfg
        num_dense, num_moe = split_layers(cfg)
        H, V = cfg.hidden_size, cfg.vocab_size
        self.embed_tokens = param(V, H, dtype=dtype, device=device)
        self.norm = param(H, dtype=dtype, device=device)
        self.lm_head = _weight("lm_head", (H, V), dtype, device, quantize)
        self.dense_layers = nn.ModuleList(
            DecoderLayer(cfg, False, dtype, device, quantize, split) for _ in range(num_dense)
        )
        self.moe_layers = nn.ModuleList(
            DecoderLayer(cfg, True, dtype, device, quantize, split) for _ in range(num_moe)
        )
        self.quantize_s = 0.0  # seconds spent packing at random init (reset_)
        self.moe_cfg = MoeConfig(
            num_experts=cfg.n_routed_experts or 0,
            top_k=cfg.num_experts_per_tok or 1,
            scoring=cfg.scoring_func or "softmax",
            norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor,
        )

    @classmethod
    def from_state(cls, cfg: DeepseekV2Config, state: Dict[str, torch.Tensor],
                   dtype=torch.bfloat16, device=None) -> "DeepseekDecoder":
        """A decoder in the layout of `state` (this module's state_dict
        names: the split layout where it holds ``q_proj``, else the fused
        one), its packed entries in holders of their format, loaded with
        `state`."""
        parts = {key.rsplit(".", 1)[-1] for key in state}
        quantize = ("q4_k" if "mins" in parts else "q6_k" if "highs" in parts
                    else "q8_0" if "codes" in parts else None)
        split = any(key.endswith(".q_proj") or ".q_proj." in key for key in state)
        decoder = cls(cfg, dtype, device, quantize, split=split)
        decoder.load_state_dict(state)
        return decoder

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
        if layer.split:
            q, k, v = (project(normed, w) for w in (layer.q_proj, layer.k_proj, layer.v_proj))
        else:
            q, k, v = torch.split(project(normed, layer.qkv_proj), [NH * D, NKV * D, NKV * DV], dim=-1)
        q = q.reshape(B, S, NH, D).transpose(1, 2)
        k = k.reshape(B, S, NKV, D).transpose(1, 2)
        v = v.reshape(B, S, NKV, DV).transpose(1, 2)
        q = partial_rope(q, cos, sin, cfg.rope_dim, cfg.use_mla)
        k = partial_rope(k, cos, sin, cfg.rope_dim, cfg.use_mla)
        return q, k, v

    @staticmethod
    def _swiglu(x, normed, layer, fused: str, names, down) -> torch.Tensor:
        """silu(gate) · up in f32 from the fused projection or the split
        pair, cast to x's dtype, through `down`."""
        if layer.split:
            gate, up = (project(normed, getattr(layer, n)).float() for n in names)
        else:
            gate, up = torch.chunk(project(normed, getattr(layer, fused)).float(), 2, dim=-1)
        return project((silu(gate) * up).to(x.dtype), down)

    def _mlp(self, x, layer):
        cfg = self.cfg
        B, S, H = x.shape
        normed = rms_norm(x, layer.post_attention_layernorm, cfg.rms_norm_eps)
        if not layer.moe:
            mlp = self._swiglu(x, normed, layer, "gateup_proj", ("gate_proj", "up_proj"),
                               layer.down_proj)
            return (x.float() + mlp.float()).to(x.dtype)
        tokens = normed.reshape(B * S, H)
        weights, indices = moe_router(tokens, layer.gate_weight, self.moe_cfg)
        gate_up = ((layer.experts_gate, layer.experts_up) if layer.split
                   else (layer.experts_gateup,))
        stacks = (*gate_up, layer.experts_down)
        if all(map(is_quantized, stacks)) and B * S <= 32:
            apply = moe_apply_quant if layer.split else moe_apply_quant_fused
            routed = apply(tokens, weights, indices, *stacks)
        else:  # float stacks, or prefill of packed (or mixed) ones: bf16 weights
            apply = moe_apply if layer.split else moe_apply_fused
            routed = apply(tokens, weights, indices, *(dequant_stack(w).to(x.dtype) for w in stacks))
        out = routed.float()
        if hasattr(layer, "shared_down"):
            shared = self._swiglu(x, normed, layer, "shared_gateup", ("shared_gate", "shared_up"),
                                  layer.shared_down)
            out = out + shared.reshape(B * S, H).float()
        return (x.float() + out.reshape(B, S, H)).to(x.dtype)

    def _layers(self, x, positions, rope, attend):
        """Every layer over x [B, S, H] at `positions` [B, S]; `attend(li,
        q, k, v)` writes layer li's K/V where the mode keeps it and
        returns the attention [B, S, NH*DV]."""
        cos = rope[0][positions][:, None]
        sin = rope[1][positions][:, None]
        for li, layer in enumerate(self.layers()):
            q, k, v = self._qkv(x, layer, cos, sin)
            attn = project(attend(li, q, k, v), layer.o_proj)
            x = self._mlp((x.float() + attn.float()).to(x.dtype), layer)
        return x

    def _logits(self, x, last_index: Optional[torch.Tensor], full_logits: bool = False) -> torch.Tensor:
        """f32 logits at every position ([B, S, V]) or at last_index ([B, V],
        default the last position)."""
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        if full_logits:
            rows = x.reshape(-1, x.shape[-1])
        elif last_index is None:
            rows = x[:, -1]
        else:
            rows = x[torch.arange(x.shape[0], device=x.device), last_index]
        if isinstance(self.lm_head, Packed):
            logits = self.lm_head.matmul(rows.contiguous())
        else:
            logits = torch.matmul(rows.float(), self.lm_head.float())
        return logits.reshape(*x.shape[:2], -1) if full_logits else logits

    # -- modes ----------------------------------------------------------------

    def forward(
        self,
        embeds: torch.Tensor,  # [B, S, H]
        positions: torch.Tensor,  # [B, S] absolute positions
        cache: KVCache,  # written in place at [length, length + S)
        rope: Tuple[torch.Tensor, torch.Tensor],
        *,
        full_logits: bool = False,
        last_index: Optional[torch.Tensor] = None,  # [B]
        pad_start: Optional[torch.Tensor] = None,  # [B] left-pad boundary
        flash_prefill: bool = False,
    ) -> Tuple[torch.Tensor, KVCache]:
        """The reference's deepseek_forward over a contiguous KVCache →
        (logits, cache); the cache's length is NOT bumped. Attention: S > 1
        with `flash_prefill` (from an empty cache, the reference's engine
        invariant) through flash_prefill_attention on the tokens' own K/V;
        otherwise plain torch over the whole cache, query i attending
        positions ≤ length + i (and ≥ pad_start[b])."""
        if cache.k_scale is not None:
            raise ValueError("int8 KV cache supports single-token slot steps only")
        B, S, _ = embeds.shape
        dev = embeds.device
        start = cache.length
        scale = self.cfg.head_dim ** -0.5
        flash = flash_prefill and S > 1
        if flash:
            if start != 0:
                raise ValueError(f"flash prefill starts from an empty cache, not at {start}")
            pad = pad_start if pad_start is not None else torch.zeros((B,), dtype=torch.int32, device=dev)
        else:
            mask = causal_mask(S, cache.max_len, start, dev)[None, None]
            if pad_start is not None:
                kv_pos = torch.arange(cache.max_len, device=dev)
                mask = mask & (kv_pos[None, None, None, :] >= pad_start[:, None, None, None])

        def attend(li, q, k, v):
            write_kv(cache, li, k, v, start)
            if flash:
                return flash_prefill_attention(
                    q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous(), pad,
                    scale=scale,
                )
            k_layer, v_layer = layer_kv(cache, li)
            return attention(q, k_layer.to(q.dtype), v_layer.to(q.dtype), mask, scale)

        x = self._layers(embeds, positions, rope, attend)
        return self._logits(x, last_index, full_logits), cache

    def prefill(
        self,
        embeds: torch.Tensor,  # [B, S, H]
        positions: torch.Tensor,  # [B, S] absolute positions
        rope: Tuple[torch.Tensor, torch.Tensor],
        *,
        last_index: Optional[torch.Tensor] = None,  # [B]
    ):
        """→ (logits [B, V] f32 at last_index, k [L, B, NKV, S, D], v): a
        forward over a fresh cache of S positions, through
        flash_prefill_attention. Rows are right-padded, so no query is
        masked out entirely."""
        cfg = self.cfg
        B, S, _ = embeds.shape
        cache = init_kv_cache(cfg.num_hidden_layers, B, cfg.resolved_kv_heads, S, cfg.head_dim,
                              cfg.resolved_v_head_dim, embeds.dtype, embeds.device)
        logits, cache = self.forward(embeds, positions, cache, rope, last_index=last_index,
                                     flash_prefill=True)
        return logits, cache.k, cache.v

    def slot_step(
        self,
        embeds: torch.Tensor,  # [B, 1, H]
        positions: torch.Tensor,  # [B, 1]
        rope: Tuple[torch.Tensor, torch.Tensor],
        cache,  # SlotCache or PagedSlotCache, optional scales — updated in place
    ) -> torch.Tensor:
        """One token per row → logits [B, V] f32; row r's K/V lands at
        cache.lengths[r] (lengths are NOT bumped here)."""
        scale = self.cfg.head_dim ** -0.5
        paged = isinstance(cache, PagedSlotCache)

        def attend(li, q, k, v):
            if paged:
                return paged_kv_write_attend(
                    q, k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.tables, li,
                    cache.lengths, scale,
                )
            return slot_kv_write_attend(
                q, k, v, cache.k, cache.v, cache.k_scale, cache.v_scale, li, cache.lengths, scale,
            )

        return self._logits(self._layers(embeds, positions, rope, attend), None)
