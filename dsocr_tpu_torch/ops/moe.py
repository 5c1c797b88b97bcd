"""Mixture-of-experts routing, the fused float expert tiers and the packed
decode tiers (dsocr_tpu/ops/moe.py: moe_router, moe_apply_fused,
dequant_stack, moe_apply_q8_fused with its megafused branch, and
moe_apply_quant_fused; one function serves both of the latter).

Expert stacks keep the reference layout: gate+up fused along the output
dim, [E, hidden, 2*inter], and down [E, inter, hidden]. Three tiers by
token count N, as in the reference:

- N = 1: an unrolled loop over the K selected experts;
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
by default, as in the reference) an all-Q8_0 group's dense tier is one
``q8_moe_megafused`` call instead; mixed groups keep the sweep. Prefill
dequantizes the stacks to bf16 for the grouped tier.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from .activations import silu
from .kernels import q8_moe_megafused
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


def moe_apply_single_fused(tokens, topk_weights, topk_indices, gateup, down):
    """N = 1: loop over the K selected experts (reads K of E)."""
    out = torch.zeros((1, down.shape[-1]), dtype=torch.float32, device=tokens.device)
    for slot in range(topk_indices.shape[1]):
        e = topk_indices[0, slot : slot + 1]  # stays on the device: no sync
        gu = torch.matmul(tokens, gateup.index_select(0, e)[0]).float()
        gate, up = _split_gateup(gu)
        inter = (silu(gate) * up).to(tokens.dtype)
        wd = down.index_select(0, e)[0]
        out = out + topk_weights[:, slot : slot + 1] * torch.matmul(inter, wd).float()
    return out.to(tokens.dtype)


def moe_apply_dense_fused(tokens, topk_weights, topk_indices, gateup, down):
    """N <= 32: all experts on all tokens, then the K selected outputs."""
    gus = torch.matmul(tokens[None], gateup).float()  # [E, N, 2I]
    gates, ups = _split_gateup(gus)
    inter = (silu(gates) * ups).to(tokens.dtype)
    outs = torch.matmul(inter, down).float()  # [E, N, H]
    n_idx = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
    sel = outs[topk_indices, n_idx]  # [N, K, H]
    return (sel * topk_weights[..., None]).sum(dim=1).to(tokens.dtype)


def moe_apply_grouped_fused(tokens, topk_weights, topk_indices, gateup, down):
    """N > 32: assignments sorted by expert, one matmul per expert slice."""
    n, hidden = tokens.shape
    k = topk_indices.shape[1]
    flat_expert = topk_indices.reshape(n * k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = tokens[order // k]
    # the one host sync of the grouped tier: slice bounds per expert
    counts = torch.bincount(flat_expert, minlength=gateup.shape[0]).tolist()
    outs = torch.empty((n * k, hidden), dtype=tokens.dtype, device=tokens.device)
    start = 0
    for e, count in enumerate(counts):
        if count == 0:
            continue
        seg = slice(start, start + count)
        gates, ups = _split_gateup(torch.matmul(sorted_tokens[seg], gateup[e]).float())
        inter = (silu(gates) * ups).to(tokens.dtype)
        outs[seg] = torch.matmul(inter, down[e])
        start += count
    unsorted = torch.empty_like(outs)
    unsorted[order] = outs
    per_slot = unsorted.reshape(n, k, hidden).float()
    return (per_slot * topk_weights[..., None]).sum(dim=1).to(tokens.dtype)


def moe_apply_fused(
    tokens: torch.Tensor,  # [N, hidden]
    topk_weights: torch.Tensor,  # [N, K] f32
    topk_indices: torch.Tensor,  # [N, K]
    gateup: torch.Tensor,  # [E, hidden, 2*inter]
    down: torch.Tensor,  # [E, inter, hidden]
    *,
    dense_threshold: int = 32,
) -> torch.Tensor:
    """Routed experts → [N, hidden] in tokens.dtype (tier by N)."""
    if tokens.shape[0] == 1:
        return moe_apply_single_fused(tokens, topk_weights, topk_indices, gateup, down)
    if tokens.shape[0] <= dense_threshold:
        return moe_apply_dense_fused(tokens, topk_weights, topk_indices, gateup, down)
    return moe_apply_grouped_fused(tokens, topk_weights, topk_indices, gateup, down)


# -- packed stacks ---------------------------------------------------------------


def is_quantized(q) -> bool:
    return isinstance(q, Packed)


def dequant_stack(q) -> torch.Tensor:
    """A packed stack of any format dequantized to bf16 [E, in, out]; a
    float stack as it is."""
    return q.dequant() if is_quantized(q) else q


def moe_apply_quant_fused(tokens, topk_weights, topk_indices, gateup_q: Packed, down_q: Packed):
    """Decode MoE straight from packed stacks → [N, hidden] in
    tokens.dtype, each projection through its own format's kernel.
    N·top_k ≤ E: the gather kernels read only the selected experts, one
    row per selection. Above: every expert once (dense sweep), then the
    selected outputs. The combine is the reference's: f32 outputs times
    f32 weights, summed over k, then cast. Under DSOCR_Q8_MEGAFUSED=1 the
    dense tier of an all-Q8_0 group is the megafused chain, combined over
    experts by a dense [E, N] routing map (a scatter-add: an expert chosen
    twice for a token adds its weights)."""
    n, k = topk_indices.shape
    hidden = tokens.shape[1]
    E = gateup_q.codes.shape[0]
    if (n * k > E and isinstance(gateup_q, PackedQ8) and isinstance(down_q, PackedQ8)
            and os.environ.get("DSOCR_Q8_MEGAFUSED", "0") == "1"):
        rows = torch.arange(n, device=tokens.device)[:, None].expand(n, k)
        w_dense = torch.zeros((E, n), dtype=torch.float32, device=tokens.device)
        w_dense.index_put_((topk_indices.reshape(-1), rows.reshape(-1)),
                           topk_weights.reshape(-1).float(), accumulate=True)
        out = q8_moe_megafused(tokens, w_dense, gateup_q.codes, gateup_q.scales,
                               down_q.codes, down_q.scales)
        return out.to(tokens.dtype)
    if n * k > E:
        gates, ups = _split_gateup(gateup_q.dense(tokens))  # [E, N, I] each
        inter = (silu(gates) * ups).to(tokens.dtype)
        outs = down_q.dense_perx(inter)  # [E, N, H]
        n_idx = torch.arange(n, device=tokens.device)[:, None]
        sel = outs[topk_indices, n_idx]  # [N, K, H]
    else:
        flat_idx = topk_indices.reshape(n * k).to(torch.int32)
        flat_x = tokens.repeat_interleave(k, dim=0)  # slot s uses token s // k
        gates, ups = _split_gateup(gateup_q.gather(flat_x, flat_idx))
        inter = (silu(gates) * ups).to(tokens.dtype)
        sel = down_q.gather(inter, flat_idx).reshape(n, k, hidden)
    return (sel * topk_weights[..., None]).sum(dim=1).to(tokens.dtype)
