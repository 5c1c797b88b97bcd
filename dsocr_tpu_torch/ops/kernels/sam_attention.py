"""SAM global attention with the decomposed relative-position bias.

Replaces ``sam_flash_attention`` (dsocr_tpu/ops/pallas/sam_attention.py:74,
``pallas_call`` at :92).

    out = softmax(q·kᵀ + bias_h[i, j // W] + bias_w[i, j % W]) · v

with q pre-scaled by D^-0.5 and f32 throughout. It runs in SAM's global
blocks (2, 5, 8, 11) at S = 4096 for a 1024 view (6400 for a 1280 view)
and S = 1600 for a 640 tile, D = 64; the engine pools 4 views (BH 48) or
16 tiles (BH 192) a call.

What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): operations.
Per (view, head) it does 4·S²·D FLOPs (~4.3 GFLOP at S = 4096) on O(S·D)
bytes, far above the card's ridge point; the plain version instead writes
and re-reads an [S, S] f32 score tensor and its bias (~64 MiB each per
head at 4096). f32 is what the reference computes, so the bound is either
f32 FMAs on the CUDA cores (67 TFLOP/s: 0.769 ms at BH 12, S 4096) or
3xTF32 on the tensor cores (three TF32 products per f32 product at 494.7
TFLOP/s: 0.313 ms).

What the design does (csrc/sam_attention.cu): 3xTF32 — each operand splits
into hi = tf32(x) and lo = tf32(x − hi), a product is lo·hi + hi·lo +
hi·hi in f32 — for both q·kᵀ and p·v, so the tensor cores do f32-accurate
work (tests/test_torch_sam_split.py emulates it against the Pallas
kernel). At D ≤ 64 (the main path) a block of two warpgroups owns 128
queries of one (view, head) and runs both products on wgmma: K and V tiles
of 64 keys come through a cp.async ring and are split once a tile into
hi/lo planes in shared memory (V transposed), Q's fragments, the score
tile, the online softmax (log2 units) and the output stay in registers,
and each tile's P·V sums in fresh accumulators (the tensor cores round
their f32 sums toward zero). 64 < D ≤ 128 runs an mma.sync body. The
TF32 split is the kernel's own arithmetic: torch's TF32 switches are not
touched.

The bias is read per score (the Pallas kernel's one-hot expansion matmuls
were a Mosaic workaround and are not carried over), from the block's bias
rows staged in shared memory while they fit beside the ring — 8 bytes ×
64 × ((kh + 1) + kw rounded up to 16) at D ≤ 64: 64.5 KB at 64 × 64,
80.5 KB at the 1280 view's 80 × 80, square grids up to about 112 × 112;
about 190 × 190 at D > 64 — and past that straight from bias_h and bias_w
through L1 and L2. The C entry chooses by the card's shared-memory limit,
so every grid the reference takes runs on the card; the only limits are D
(a multiple of 4 up to 128) and 16-byte alignment of q, k and v.
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
    if d % 4 or d > 128:
        raise ValueError(f"{name}: needs D a multiple of 4 up to 128, got D={d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on a 16-byte boundary")
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
