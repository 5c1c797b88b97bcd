"""Decoder prefill attention over the prompt's own K/V.

Replaces ``flash_prefill_attention``
(dsocr_tpu/ops/pallas/prefill_attention.py:69).

Mask ``kv <= q and kv >= pad_start[b]``; GQA takes KV head
``h // (H / H_kv)``; scores and softmax in f32 with the finite -1e30 fill,
so a fully masked (left-pad) query row comes out as the uniform mean of v
over all S keys, exactly as in the reference. Main path: q [B, 10, S,
128] bf16 with S the prompt padded to a multiple of 128 (~1.8k tokens
for a crop-mode page), output [B, S, 1280] in q's dtype.

What bounds it on the H100: arithmetic — 4·S²·D FLOPs per (row, head),
~1.6 GFLOP at S = 1792, on O(S·D) bytes. The plain version writes and
re-reads an [B, H, S, S] f32 score tensor (2 GiB for a 16-row wave).

What the design does (csrc/prefill_attention.cu over
csrc/flash_tile.cuh): one block per 64 queries of one (row, head), f32
online softmax over key tiles staged in shared memory; the score tile
never leaves shared memory. It visits EVERY key tile, including those
above the diagonal, because left-padded rows must see all S keys to
reproduce the reference's uniform mean. f32 CUDA-core math; tensor-core
(wgmma) tiles and skipping the dead tiles of unpadded rows are later
work.
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
    tensors run the plain version; CUDA tensors launch the kernel."""
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
