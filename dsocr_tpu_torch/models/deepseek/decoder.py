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
:483-545). A MoE layer may hold the router's score-correction bias
(``gate_bias``, the checkpoint's ``e_score_correction_bias``; a decoder
built with ``gate_bias=True`` or from a state that has one), which the
router adds to its logits (decoder.py:479). With ``quantize="q8_0"``, ``"q4_k"`` or ``"q6_k"`` the
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

Under a mesh (dsocr_tpu_torch/parallel) a decoder holds one rank's shard
of the split layout (``shard_decoder``; its ``shard`` a DecoderShard):
q/k/v split by whole heads and o_proj by its input rows, dense and shared
gate/up by intermediate columns and down by rows, the routed float
experts over their intermediate dim (or, with ``ep``, and always for
packed stacks, over E: selections of other ranks' experts are clipped
and weighted zero, the reference's ``_ep_localize``), embed_tokens by
vocab rows (a masked lookup, then a sum) and lm_head by vocab columns.
Each block's partial sums meet in one f32 all-reduce over the rank's mp
group: one after o_proj, one after the MLP; a part that mp does not
divide stays whole on every rank (attention where mp does not divide the
heads). The logits stay vocab-local: the engine's mesh runtime gathers
them to rank 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

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


def has_gate_bias(state: Dict[str, torch.Tensor]) -> bool:
    """Does a state_dict hold a router score-correction bias?"""
    return any(key.endswith(".gate_bias") for key in state)


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


def unfuse_decoder_params(state: Dict[str, torch.Tensor], cfg: DeepseekV2Config) -> Dict[str, torch.Tensor]:
    """fuse_decoder_params undone: each fused projection split back into
    its parts along the axis it was concatenated on (views of it). A
    split state passes through."""
    NH, NKV = cfg.num_attention_heads, cfg.resolved_kv_heads
    sizes = {"qkv_proj": (NH * cfg.head_dim, NKV * cfg.head_dim, NKV * cfg.resolved_v_head_dim)}
    out = dict(state)
    for key in state:
        head, _, name = key.rpartition(".")
        part = ""
        if name in _PACKED_PARTS:
            part = "." + name
            head, _, name = head.rpartition(".")
        for names, fused in _FUSED:
            if name != fused:
                continue
            axis = -2 if part and fused not in EXPERT_KEYS else -1
            t = out.pop(key)
            split = sizes.get(fused, (t.shape[axis] // 2,) * 2)
            for n, piece in zip(names, torch.split(t, list(split), dim=axis), strict=True):
                out[f"{head}.{n}{part}"] = piece
    return out


@dataclasses.dataclass
class DecoderShard:
    """One rank's share of the decoder under a mesh: local sizes, which
    parts mp splits, and the collectives (``comm``: parallel/comm.py's
    Comm). A part that mp does not split is held whole."""

    comm: Any
    n_heads: int
    n_kv_heads: int
    attn_split: bool
    dense_inter: int
    dense_split: bool
    moe_inter: int
    shared_inter: int
    shared_split: bool
    experts: int  # routed experts held (all, or E / mp under expert parallelism)
    expert_offset: int
    experts_split: Optional[str]  # "I" (intermediate dim), "E" (experts) or None
    vocab: int
    vocab_offset: int
    vocab_split: bool


def decoder_shard(cfg: DeepseekV2Config, mesh, rank: int, comm, packed: bool) -> DecoderShard:
    """Rank `rank`'s DecoderShard: a dimension splits over mp where mp
    divides it (parallel/mesh.py's rules); packed serving splits only
    the routed experts, over E."""
    mp = mesh.mp
    _, m = mesh.coords(rank)
    NH, NKV = cfg.num_attention_heads, cfg.resolved_kv_heads
    E = cfg.n_routed_experts or 0
    MI = cfg.moe_intermediate_size or cfg.intermediate_size
    SI = MI * (cfg.n_shared_experts or 0)
    I, V = cfg.intermediate_size, cfg.vocab_size  # noqa: E741
    tp = not packed

    def div(n: int) -> bool:
        return tp and n % mp == 0

    attn = div(NH) and div(NKV)
    ep = (mesh.ep or packed) and E % mp == 0
    experts_split = "E" if ep else ("I" if div(MI) and not mesh.ep else None)
    return DecoderShard(
        comm=comm, n_heads=NH // mp if attn else NH, n_kv_heads=NKV // mp if attn else NKV,
        attn_split=attn, dense_inter=I // mp if div(I) else I, dense_split=div(I),
        moe_inter=MI // mp if experts_split == "I" else MI,
        shared_inter=SI // mp if div(SI) else SI, shared_split=div(SI),
        experts=E // mp if ep else E, expert_offset=m * (E // mp) if ep else 0,
        experts_split=experts_split, vocab=V // mp if div(V) else V,
        vocab_offset=m * (V // mp) if div(V) else 0, vocab_split=div(V),
    )


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
    "o_proj", "gate_weight", "gate_bias", "experts_gateup", "experts_gate", "experts_up", "experts_down",
    "shared_gateup", "shared_gate", "shared_up", "shared_down", "gateup_proj", "gate_proj",
    "up_proj", "down_proj",
)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, moe: bool, dtype, device,
                 quantize: Optional[str] = None, split: bool = False, gate_bias: bool = False,
                 shard: Optional[DecoderShard] = None):
        super().__init__()
        H, D, DV = cfg.hidden_size, cfg.head_dim, cfg.resolved_v_head_dim
        NH, NKV = cfg.num_attention_heads, cfg.resolved_kv_heads
        if shard is not None:
            NH, NKV = shard.n_heads, shard.n_kv_heads
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
            SI = MI * (cfg.n_shared_experts or 0)
            self.gate_weight = param(E, H, dtype=dtype, device=device)
            if gate_bias:
                self.gate_bias = param(E, dtype=dtype, device=device)
            if shard is not None:
                E, MI, SI = shard.experts, shard.moe_inter, shard.shared_inter
            weights("experts_gateup", ("experts_gate", "experts_up"), E, H, outs=(MI, MI))
            self.experts_down = _weight("experts_down", (E, MI, H), dtype, device, quantize)
            if SI:
                weights("shared_gateup", ("shared_gate", "shared_up"), H, outs=(SI, SI))
                self.shared_down = _weight("shared_down", (SI, H), dtype, device, quantize)
        else:
            I = shard.dense_inter if shard is not None else cfg.intermediate_size  # noqa: E741
            weights("gateup_proj", ("gate_proj", "up_proj"), H, outs=(I, I))
            self.down_proj = param(I, H, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> float:
        """Random init at the reference's scales (decoder.py:57-147): every
        matrix N(0, fan_in^-1), norms 1, a router bias 0, drawn in
        registration order (a
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
            elif name == "gate_bias":
                w.zero_()
            else:
                fan_in = (w.float_shape if isinstance(w, Packed) else w.shape)[-2]
                packing += _fill_(w, fan_in ** -0.5, gen, self.input_layernorm.dtype)
        return packing


class DeepseekDecoder(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dtype=torch.bfloat16, device=None,
                 quantize: Optional[str] = None, *, split: bool = False, gate_bias: bool = False,
                 shard: Optional[DecoderShard] = None):
        """The fused layout; ``split`` builds the split one (what
        ``from_state`` does for a split state); ``gate_bias`` gives every
        MoE layer a router bias; ``shard`` (split layout only) builds one
        rank's shard of it (``shard_decoder``)."""
        super().__init__()
        if shard is not None and not split:
            raise ValueError("a decoder shard holds the split layout")
        self.cfg = cfg
        self.shard = shard
        self.n_heads = shard.n_heads if shard is not None else cfg.num_attention_heads
        self.n_kv_heads = shard.n_kv_heads if shard is not None else cfg.resolved_kv_heads
        num_dense, num_moe = split_layers(cfg)
        H = cfg.hidden_size
        V = shard.vocab if shard is not None else cfg.vocab_size
        self.embed_tokens = param(V, H, dtype=dtype, device=device)
        self.norm = param(H, dtype=dtype, device=device)
        self.lm_head = _weight("lm_head", (H, V), dtype, device, quantize)
        self.dense_layers = nn.ModuleList(
            DecoderLayer(cfg, False, dtype, device, quantize, split, shard=shard) for _ in range(num_dense)
        )
        self.moe_layers = nn.ModuleList(
            DecoderLayer(cfg, True, dtype, device, quantize, split, gate_bias, shard=shard)
            for _ in range(num_moe)
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
        decoder = cls(cfg, dtype, device, quantize, split=split, gate_bias=has_gate_bias(state))
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

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings [..., H] in the table's dtype; a vocab shard
        looks up the ids it holds, zeros elsewhere, and sums over mp."""
        shard = self.shard
        if shard is None or not shard.vocab_split:
            return self.embed_tokens[token_ids]
        local = token_ids - shard.vocab_offset
        hit = (local >= 0) & (local < shard.vocab)
        rows = self.embed_tokens[local.clamp(0, shard.vocab - 1)] * hit[..., None].to(self.dtype)
        return shard.comm.all_reduce_f32(rows).to(self.dtype)

    def _reduce(self, partial: torch.Tensor, split: bool) -> torch.Tensor:
        """A block's output in f32: summed over mp when `split` (its
        partial sums), as it is otherwise."""
        return self.shard.comm.all_reduce_f32(partial) if split else partial.float()

    def _qkv(self, x, layer, cos, sin):
        cfg = self.cfg
        B, S, _ = x.shape
        NH, NKV, D, DV = self.n_heads, self.n_kv_heads, cfg.head_dim, cfg.resolved_v_head_dim
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
        shard = self.shard
        B, S, H = x.shape
        normed = rms_norm(x, layer.post_attention_layernorm, cfg.rms_norm_eps)
        if not layer.moe:
            mlp = self._swiglu(x, normed, layer, "gateup_proj", ("gate_proj", "up_proj"),
                               layer.down_proj)
            mlp = self._reduce(mlp, shard is not None and shard.dense_split)
            return (x.float() + mlp).to(x.dtype)
        tokens = normed.reshape(B * S, H)
        weights, indices = moe_router(tokens, layer.gate_weight, self.moe_cfg,
                                      aux_bias=getattr(layer, "gate_bias", None))
        if shard is not None and shard.experts_split == "E":
            # the reference's _ep_localize: other ranks' selections weigh 0
            local = indices - shard.expert_offset
            weights = torch.where((local >= 0) & (local < shard.experts), weights,
                                  torch.zeros_like(weights))
            indices = local.clamp(0, shard.experts - 1)
        gate_up = ((layer.experts_gate, layer.experts_up) if layer.split
                   else (layer.experts_gateup,))
        stacks = (*gate_up, layer.experts_down)
        if all(map(is_quantized, stacks)) and B * S <= 32:
            apply = moe_apply_quant if layer.split else moe_apply_quant_fused
            routed = apply(tokens, weights, indices, *stacks)
        else:  # float stacks, or prefill of packed (or mixed) ones: bf16 weights
            apply = moe_apply if layer.split else moe_apply_fused
            routed = apply(tokens, weights, indices, *(dequant_stack(w).to(x.dtype) for w in stacks))
        shared = None
        if hasattr(layer, "shared_down"):
            shared = self._swiglu(x, normed, layer, "shared_gateup", ("shared_gate", "shared_up"),
                                  layer.shared_down).reshape(B * S, H).float()
        if shard is None:
            out = routed.float() if shared is None else routed.float() + shared
        else:  # the partial sums meet in one all-reduce; whole parts add after it
            parts = [(routed, shard.experts_split is not None)]
            if shared is not None:
                parts.append((shared, shard.shared_split))
            split = [p.float() for p, s in parts if s]
            out = self._reduce(sum(split[1:], split[0]), True) if split else None
            for p, s in parts:
                if not s:
                    out = p.float() if out is None else out + p.float()
        return (x.float() + out.reshape(B, S, H)).to(x.dtype)

    def _layers(self, x, positions, rope, attend):
        """Every layer over x [B, S, H] at `positions` [B, S]; `attend(li,
        q, k, v)` writes layer li's K/V where the mode keeps it and
        returns the attention [B, S, NH*DV]."""
        cos = rope[0][positions][:, None]
        sin = rope[1][positions][:, None]
        split = self.shard is not None and self.shard.attn_split
        for li, layer in enumerate(self.layers()):
            q, k, v = self._qkv(x, layer, cos, sin)
            attn = self._reduce(project(attend(li, q, k, v), layer.o_proj), split)
            x = self._mlp((x.float() + attn).to(x.dtype), layer)
        return x

    def _logits(self, x, last_index: Optional[torch.Tensor], full_logits: bool = False) -> torch.Tensor:
        """f32 logits at every position ([B, S, V]) or at last_index ([B, V],
        default the last position); a vocab shard's own columns."""
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
        cache = init_kv_cache(cfg.num_hidden_layers, B, self.n_kv_heads, S, cfg.head_dim,
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


def shard_decoder(decoder: DeepseekDecoder, mesh, rank: int, comm,
                  quantize: Optional[str] = None) -> DeepseekDecoder:
    """Rank `rank`'s shard of a whole decoder (either layout, float or
    packed with `quantize`): its state split into the split layout, each
    parameter cut by parallel/mesh.py's rule where its DecoderShard
    splits that part, loaded into a split decoder of the local shapes."""
    from ...parallel.mesh import deepseek_param_shardings, shard_tensor

    cfg = decoder.cfg
    packed = quantize is not None
    shard = decoder_shard(cfg, mesh, rank, comm, packed)
    splits = {
        "embed_tokens": shard.vocab_split, "lm_head": shard.vocab_split,
        "q_proj": shard.attn_split, "k_proj": shard.attn_split, "v_proj": shard.attn_split,
        "o_proj": shard.attn_split, "gate_proj": shard.dense_split, "up_proj": shard.dense_split,
        "down_proj": shard.dense_split, "shared_gate": shard.shared_split,
        "shared_up": shard.shared_split, "shared_down": shard.shared_split,
        **dict.fromkeys(("experts_gate", "experts_up", "experts_down"), shard.experts_split is not None),
    }
    state = unfuse_decoder_params(decoder.state_dict(), cfg)
    specs = deepseek_param_shardings({k: tuple(t.shape) for k, t in state.items()}, mesh,
                                     ep=shard.experts_split == "E", packed=packed)
    local = {}
    for name, t in state.items():
        parts = name.split(".")
        leaf = parts[-2] if parts[-1] in _PACKED_PARTS else parts[-1]
        local[name] = shard_tensor(t, specs[name], mesh, rank) if splits.get(leaf, False) else t
    out = DeepseekDecoder(cfg, decoder.dtype, decoder.embed_tokens.device, quantize, split=True,
                          gate_bias=has_gate_bias(state), shard=shard)
    out.load_state_dict(local)
    return out
