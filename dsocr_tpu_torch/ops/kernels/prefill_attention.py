"""Decoder prefill attention over the prompt's own K/V.

Replaces ``flash_prefill_attention``
(dsocr_tpu/ops/pallas/prefill_attention.py:69).

Mask ``kv <= q and kv >= pad_start[b]``; GQA takes KV head
``h // (H / H_kv)``; scores and softmax in f32 with the finite -1e30 fill,
so a fully masked (left-pad) query row comes out as the uniform mean of v
over all S keys, exactly as in the reference. Main path: q [B, 10, S,
128] bf16 with S the prompt padded to a multiple of 128 (1024 for the
904-token crop-mode page the serving benchmarks use), output [B, S, 1280]
in q's dtype.

What bounds it on the H100: under the causal mask a (row, head) does
2·S²·D FLOPs (two products over the lower triangle) on 4·S·D elements,
~256 FLOPs per byte at S = 1024, near the card's ridge of ~295: the bf16
tensor cores and the memory bound it about alike there, the tensor cores
at longer prompts. The plain
version writes and re-reads an [B, H, S, S] f32 score tensor (0.6 GiB
for a 16-row wave of 1024).

What the design does (csrc/prefill_attention.cu): bf16 inputs run a
Hopper kernel, 128 queries of one (row, head) a block in two warpgroups
that share its K/V tiles, with both products on wgmma (Q and P from
registers, K and V read by the tensor cores from 128-byte-swizzled shared
memory), the online softmax in registers, a three-stage cp.async ring of
K/V tiles, and only the key tiles a warpgroup's rows need: from the pad's
tile to their diagonal, or all S keys for rows among which a fully masked
(left-pad) one is. f32 inputs (the
tiny parity configs) run the CUDA-core f32 body of csrc/flash_tile.cuh,
which the SAM kernel shares: TF32 would not meet the f32 tolerance. Both
are kernels written for this card; a CUDA tensor of any other dtype
raises.
"""

from __future__ import annotations

import torch

from ..attention import attention, causal_mask
from . import _lib


def flash_prefill_attention_plain(q, k, v, pad_start, *, scale: float):
    """The same function in plain PyTorch: dense masked attention."""
    S = q.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = causal_mask(S, S, device=q.device)[None, None] & (
        pos[None, None, None, :] >= pad_start.to(q.device)[:, None, None, None]
    )
    return attention(q, k, v, mask, scale)


def flash_prefill_attention(q, k, v, pad_start, *, scale: float):
    """q [B, H, S, D], k [B, H_kv, S, D], v [B, H_kv, S, Dv] (one dtype,
    f32 or bf16), pad_start [B] int32 → [B, S, H·Dv] in q's dtype. CPU
    tensors run the plain version; CUDA tensors launch the kernel for
    their dtype (bf16: tensor cores; f32: CUDA cores)."""
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, pad_start, scale=scale)
    name = "flash_prefill_attention"
    _lib.require_cuda(name, q, k, v, pad_start)
    B, H, S, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share an f32 or bf16 dtype")
    if pad_start.dtype != torch.int32 or pad_start.shape != (B,):
        raise ValueError(f"{name}: pad_start must be int32 [B]")
    if k.shape != (B, Hkv, S, D) or v.shape[:3] != (B, Hkv, S) or H % Hkv:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    if D > 128 or Dv > 128:
        raise ValueError(f"{name}: head dims above 128 are not supported")
    out = torch.empty((B, S, H * Dv), dtype=q.dtype, device=q.device)
    err = _lib.lib().dsocr_flash_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_start.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, D, Dv, float(scale),
        _lib.DTYPE_CODES[q.dtype], _lib.stream_ptr(q),
    )
    _lib.check(err, name)
    _lib.count_launch(flash_prefill_attention)
    return out


flash_prefill_attention.launches = 0
