"""Mixture-of-experts routing, the float expert tiers and the packed
decode tiers (dsocr_tpu/ops/moe.py: moe_router; moe_apply with
moe_apply_single, moe_apply_gather and moe_apply_dense; moe_apply_fused;
dequant_stack; moe_apply_quant with moe_apply_q8 and moe_apply_kq_dense;
moe_apply_quant_fused with moe_apply_q8_fused's megafused branch).

Expert stacks keep the reference's layouts, [E, in, out]. The decoder
holds one of two: fused, gate+up concatenated along the output dim
([E, hidden, 2*inter], what the engine serves), or split, separate gate
and up stacks (what the reference's init and loader produce and its mesh
path keeps). Down is [E, inter, hidden] in both. One body per tier serves
both layouts: it takes the gate+up weights as (gateup,) or (gate, up).
The float tiers, by token count N, as in the reference:

- N = 1: an unrolled loop over the K selected experts;
- 2 <= N <= gather_threshold (split layout only, off by default): one
  gathered row per selection through the gather_matmul kernel;
- N <= 32: every expert on every token (reads each expert once), then a
  gather of the selected outputs;
- N > 32: assignments sorted by expert and run as a grouped GEMM, one
  torch.matmul per expert on its contiguous slice — the product that the
  reference leaves to XLA's ragged_dot.

Packed stacks (ops.linear's PackedQ8 / PackedQ4K / PackedQ6K, in-major)
run at decode through the kernels: the gather tier while N·top_k ≤ E, the
dense all-expert sweep above that. Each projection runs its own format's
kernel, because a group may be mixed: K-quant (Q4_K or Q6_K) gate+up
with a Q8_0 down whose in dim misses the 256-value super-block
(DeepSeek's 896); the holder runs it. With ``DSOCR_Q8_MEGAFUSED=1`` (off
by default, as in the reference) an all-Q8_0 fused group's dense tier is
one ``q8_moe_megafused`` call instead; other groups keep the sweep.
Prefill dequantizes the stacks to bf16 for the grouped tier.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from .activations import silu
from .kernels import gather_matmul, q8_moe_megafused
from .linear import Packed, PackedQ8


@dataclasses.dataclass
class MoeConfig:
    num_experts: int
    top_k: int
    scoring: str = "softmax"  # "softmax" | "sigmoid"
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0


def moe_router(
    tokens: torch.Tensor,  # [N, hidden]
    gate_weight: torch.Tensor,  # [E, hidden]
    cfg: MoeConfig,
    aux_bias: Optional[torch.Tensor] = None,  # [E]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(topk_weights [N, K] f32, topk_indices [N, K] int64); the gating
    matmul runs in full f32 (core.device turns TF32 off)."""
    logits = torch.matmul(tokens.float(), gate_weight.float().t())
    if aux_bias is not None:
        logits = logits + aux_bias.float()[None, :]
    if cfg.scoring == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif cfg.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(f"MoE scoring `{cfg.scoring}` not supported")
    topk_weights, topk_indices = torch.topk(scores, cfg.top_k, dim=-1)
    if cfg.top_k > 1 and cfg.norm_topk_prob:
        topk_weights = topk_weights / (topk_weights.sum(dim=-1, keepdim=True) + 1e-20)
    if cfg.routed_scaling_factor != 1.0:
        topk_weights = topk_weights * cfg.routed_scaling_factor
    return topk_weights, topk_indices


def _split_gateup(x: torch.Tensor):
    half = x.shape[-1] // 2
    return x[..., :half], x[..., half:]


def _swiglu(gate_up, dtype) -> torch.Tensor:
    """silu(gate) · up → dtype, from the f32 outputs of one fused gate+up
    stack (split in halves) or of separate gate and up stacks."""
    gate, up = _split_gateup(gate_up[0]) if len(gate_up) == 1 else gate_up
    return (silu(gate) * up).to(dtype)


def _combine(sel: torch.Tensor, topk_weights: torch.Tensor, dtype) -> torch.Tensor:
    """The reference's combine: f32 outputs [N, K, H] times f32 weights,
    summed over k, then cast."""
    return (sel.float() * topk_weights[..., None]).sum(dim=1).to(dtype)


# Each tier takes the gate+up weights as a tuple: (gateup,) for the fused
# layout, (gate, up) for the split one; one body serves both.


def _single(tokens, topk_weights, topk_indices, gate_up, down):
    """N = 1: loop over the K selected experts (reads K of E)."""
    out = torch.zeros((1, down.shape[-1]), dtype=torch.float32, device=tokens.device)
    for slot in range(topk_indices.shape[1]):
        e = topk_indices[0, slot : slot + 1]  # stays on the device: no sync
        inter = _swiglu([torch.matmul(tokens, w.index_select(0, e)[0]).float() for w in gate_up],
                        tokens.dtype)
        wd = down.index_select(0, e)[0]
        out = out + topk_weights[:, slot : slot + 1] * torch.matmul(inter, wd).float()
    return out.to(tokens.dtype)


def _gather(x, w, idx):
    """out[n] = x[n] @ w[idx[n]] → f32: a packed stack's gather kernel, or
    gather_matmul on a float one."""
    return w.gather(x, idx) if is_quantized(w) else gather_matmul(x, w, idx)


def _gathered(tokens, topk_weights, topk_indices, gate_up, down):
    """Only the selected experts, one gathered row per selection."""
    n, k = topk_indices.shape
    flat_idx = topk_indices.reshape(n * k).to(torch.int32)
    flat_x = tokens.repeat_interleave(k, dim=0)  # slot s uses token s // k
    inter = _swiglu([_gather(flat_x, w, flat_idx) for w in gate_up], tokens.dtype)
    sel = _gather(inter, down, flat_idx).reshape(n, k, -1)
    return _combine(sel, topk_weights, tokens.dtype)


def _dense(x, w):
    """out[e] = x @ w[e] → [E, N, out] f32 (a packed stack's sweep)."""
    return w.dense(x) if is_quantized(w) else torch.matmul(x[None], w).float()


def _dense_perx(x, w):
    """out[e] = x[e] @ w[e] → [E, N, out] f32."""
    return w.dense_perx(x) if is_quantized(w) else torch.matmul(x, w).float()


def _all_experts(tokens, topk_weights, topk_indices, gate_up, down):
    """Every expert on every token (reads each expert once), then the K
    selected outputs."""
    inter = _swiglu([_dense(tokens, w) for w in gate_up], tokens.dtype)  # [E, N, I]
    outs = _dense_perx(inter, down)  # [E, N, H]
    n_idx = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
    return _combine(outs[topk_indices, n_idx], topk_weights, tokens.dtype)


def _grouped(tokens, topk_weights, topk_indices, gate_up, down):
    """N > 32: assignments sorted by expert, one matmul per expert slice."""
    n, hidden = tokens.shape
    k = topk_indices.shape[1]
    flat_expert = topk_indices.reshape(n * k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = tokens[order // k]
    # the one host sync of the grouped tier: slice bounds per expert
    counts = torch.bincount(flat_expert, minlength=down.shape[0]).tolist()
    outs = torch.empty((n * k, hidden), dtype=tokens.dtype, device=tokens.device)
    start = 0
    for e, count in enumerate(counts):
        if count == 0:
            continue
        seg = slice(start, start + count)
        inter = _swiglu([torch.matmul(sorted_tokens[seg], w[e]).float() for w in gate_up],
                        tokens.dtype)
        outs[seg] = torch.matmul(inter, down[e])
        start += count
    unsorted = torch.empty_like(outs)
    unsorted[order] = outs
    return _combine(unsorted.reshape(n, k, hidden), topk_weights, tokens.dtype)


def _float_tiers(tokens, topk_weights, topk_indices, gate_up, down, gather_threshold,
                 dense_threshold):
    n = tokens.shape[0]
    if n == 1:
        tier = _single
    elif n <= gather_threshold:
        tier = _gathered
    elif n <= dense_threshold:
        tier = _all_experts
    else:
        tier = _grouped
    return tier(tokens, topk_weights, topk_indices, gate_up, down)


def moe_apply(
    tokens: torch.Tensor,  # [N, hidden]
    topk_weights: torch.Tensor,  # [N, K] f32
    topk_indices: torch.Tensor,  # [N, K]
    gate: torch.Tensor,  # [E, hidden, inter]
    up: torch.Tensor,  # [E, hidden, inter]
    down: torch.Tensor,  # [E, inter, hidden]
    *,
    gather_threshold: int = 1,
    dense_threshold: int = 32,
) -> torch.Tensor:
    """Routed experts of the split layout → [N, hidden] in tokens.dtype.
    N = 1 loops over the selected experts; 2 ≤ N ≤ gather_threshold runs
    the gather tier (gather_matmul: the reference kept it "for
    experimentation", default off); N ≤ dense_threshold every expert; above,
    the sorted grouped matmuls."""
    return _float_tiers(tokens, topk_weights, topk_indices, (gate, up), down, gather_threshold,
                        dense_threshold)


def moe_apply_fused(
    tokens: torch.Tensor,  # [N, hidden]
    topk_weights: torch.Tensor,  # [N, K] f32
    topk_indices: torch.Tensor,  # [N, K]
    gateup: torch.Tensor,  # [E, hidden, 2*inter]
    down: torch.Tensor,  # [E, inter, hidden]
    *,
    dense_threshold: int = 32,
) -> torch.Tensor:
    """Routed experts of the fused layout → [N, hidden] in tokens.dtype
    (tier by N; the reference's fused tiers have no gather tier)."""
    return _float_tiers(tokens, topk_weights, topk_indices, (gateup,), down, 1, dense_threshold)


# -- packed stacks ---------------------------------------------------------------


def is_quantized(q) -> bool:
    return isinstance(q, Packed)


def dequant_stack(q) -> torch.Tensor:
    """A packed stack of any format dequantized to bf16 [E, in, out]; a
    float stack as it is."""
    return q.dequant() if is_quantized(q) else q


def _quant_tiers(tokens, topk_weights, topk_indices, gate_up, down_q):
    """Decode MoE straight from packed stacks, each projection through its
    own format's kernel: the gather tier while N·top_k ≤ E, the dense
    sweep above. Under DSOCR_Q8_MEGAFUSED=1 the dense tier of an all-Q8_0
    fused group is the megafused chain, combined over experts by a dense
    [E, N] routing map (a scatter-add: an expert chosen twice for a token
    adds its weights)."""
    n, k = topk_indices.shape
    E = down_q.codes.shape[0]
    if n * k <= E:
        return _gathered(tokens, topk_weights, topk_indices, gate_up, down_q)
    if (len(gate_up) == 1 and all(isinstance(q, PackedQ8) for q in (*gate_up, down_q))
            and os.environ.get("DSOCR_Q8_MEGAFUSED", "0") == "1"):
        rows = torch.arange(n, device=tokens.device)[:, None].expand(n, k)
        w_dense = torch.zeros((E, n), dtype=torch.float32, device=tokens.device)
        w_dense.index_put_((topk_indices.reshape(-1), rows.reshape(-1)),
                           topk_weights.reshape(-1).float(), accumulate=True)
        out = q8_moe_megafused(tokens, w_dense, gate_up[0].codes, gate_up[0].scales,
                               down_q.codes, down_q.scales)
        return out.to(tokens.dtype)
    return _all_experts(tokens, topk_weights, topk_indices, gate_up, down_q)


def moe_apply_quant(tokens, topk_weights, topk_indices, gate_q: Packed, up_q: Packed,
                    down_q: Packed):
    """Decode MoE of the split layout from packed gate, up and down stacks
    → [N, hidden] in tokens.dtype (the reference's moe_apply_quant with
    moe_apply_q8 and moe_apply_kq_dense). One difference in dispatch: an
    all-Q8_0 split group of the reference stays on the gather kernels at
    every N (moe_apply_q8 has no dense tier); here it takes the dense
    sweep above N·top_k > E, as every other group does. The values are the
    same up to the order of f32 sums."""
    return _quant_tiers(tokens, topk_weights, topk_indices, (gate_q, up_q), down_q)


def moe_apply_quant_fused(tokens, topk_weights, topk_indices, gateup_q: Packed, down_q: Packed):
    """Decode MoE of the fused layout from packed stacks → [N, hidden] in
    tokens.dtype."""
    return _quant_tiers(tokens, topk_weights, topk_indices, (gateup_q,), down_q)
