"""SAM global attention with the decomposed relative-position bias.

Replaces ``sam_flash_attention`` (dsocr_tpu/ops/pallas/sam_attention.py:74).

    out = softmax(q·kᵀ + bias_h[i, j // W] + bias_w[i, j % W]) · v

with q pre-scaled by D^-0.5 and f32 throughout. It runs in SAM's global
blocks (2, 5, 8, 11) at S = 4096 for a 1024 view and S = 1600 for a 640
tile, D = 64.

What bounds it on the H100: arithmetic. Per (view, head) it does
4·S²·D FLOPs (~4.3 GFLOP at S = 4096) on O(S·D) bytes, far above the
card's ridge point — the plain version instead writes and re-reads an
[S, S] f32 score tensor and its bias (~64 MiB each per head at 4096).

What the design does (csrc/sam_attention.cu over csrc/flash_tile.cuh):
one block per 64 queries of one (view, head) walks all key tiles with an
f32 online softmax in shared memory; the bias is rebuilt per score from
the block's [64, qh] and [64, qw] rows staged in shared memory, so no
S×S tensor reaches device memory. The Pallas kernel's one-hot expansion
matmuls were a Mosaic workaround and are not carried over. The math is
f32 on CUDA cores, not tensor cores: f32 is what the reference computes,
and wgmma/TF32 tiling is later work.
"""

from __future__ import annotations

import torch

from . import _lib


def sam_flash_attention_plain(q, k, v, bias_h, bias_w, *, width: int):
    """The same function in plain PyTorch: [BH, S, D] f32."""
    bh, s, _ = q.shape
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(1, 2))
    bias = bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
    scores = scores + bias.reshape(bh, s, kh * kw)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float())


def sam_flash_attention(q, k, v, bias_h, bias_w, *, width: int):
    """q, k, v [BH, S, D] f32 (q pre-scaled), bias_h [BH, S, qh], bias_w
    [BH, S, qw] f32 → [BH, S, D] f32. CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return sam_flash_attention_plain(q, k, v, bias_h, bias_w, width=width)
    name = "sam_flash_attention"
    _lib.require_cuda(name, q, k, v, bias_h, bias_w)
    bh, s, d = q.shape
    kh, kw = bias_h.shape[-1], bias_w.shape[-1]
    if any(t.dtype != torch.float32 for t in (q, k, v, bias_h, bias_w)):
        raise ValueError(f"{name}: expects f32 operands")
    if k.shape != q.shape or v.shape != q.shape or kh * kw != s or kw != width:
        raise ValueError(f"{name}: bad shapes {q.shape} {bias_h.shape} {bias_w.shape}")
    out = torch.empty_like(q)
    err = _lib.lib().dsocr_sam_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(),
        bias_w.data_ptr(), out.data_ptr(), bh, s, d, kh, kw, width,
        _lib.stream_ptr(q),
    )
    _lib.check(err, name)
    _lib.count_launch(sam_flash_attention)
    return out


sam_flash_attention.launches = 0
