"""Expert-gather matmul over a float expert stack.

``gather_matmul`` replaces gather_matmul
(dsocr_tpu/ops/pallas/gather_matmul.py:62, ``pallas_call`` at :86):
``out[n] = x[n] @ w[idx[n]]`` → [N, I] f32, for x [N, H] and an expert
stack w [E, H, I], each f32 or bf16, and idx [N] int32. Its one caller is
ops/moe.py's gather tier, ``moe_apply(..., gather_threshold=N)`` on the
decoder's split layout: gate and up at [N·6, 1280] × [64, 1280, 896] and
down at [N·6, 896] × [64, 896, 1280] at full width.

What bounds it on the H100: device-memory bytes. Each row reads one
expert's [H, I] slab and does 2 FLOPs per weight, far below the ~295
FLOPs per byte where the tensor cores would be the limit. Counted per
row, the slabs are N·H·I·elem bytes (N·K = 96 rows of gate at bf16:
96 · 1280 · 896 · 2 = 220 MB, 66 µs at 3.35 TB/s); counted per distinct
expert, each slab is read once, ``#distinct(idx) · H·I·elem`` (at most
64 slabs, 147 MB, 44 µs). The bound is the second.

What the design does (csrc/gather_matmul.cu): one block per (row, tile
of 128 columns); the block loads its own idx[n] (no scalar prefetch, no
masked-sum row select, no 128-multiple tile picker: any N, H and I),
stages x[n] in shared memory and reads the slab along the contiguous I
axis, 32 neighbouring elements per warp load; the eight warps split H
and their partial sums are added in warp order, so two launches give
the same bits. It reads a slab once per row that selects it, not once
per expert: rows that share an expert hit the 50 MB L2 at best. A later
design groups rows by expert (sort idx, one block per expert and column
tile over all its rows) so each slab crosses device memory once.

An index outside [0, E) reads nothing: the kernel writes a zero row, and
so does the plain version.
"""

from __future__ import annotations

import torch

from . import _lib


def gather_matmul_plain(x, w, idx):
    """The plain version: one [1, H] @ [H, I] product per row, in f32."""
    idx = idx.long()
    valid = (idx >= 0) & (idx < w.shape[0])
    rows = w[torch.where(valid, idx, torch.zeros_like(idx))].float()  # [N, H, I]
    out = torch.bmm(x.float()[:, None], rows)[:, 0]
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def gather_matmul(x, w, idx):
    """out[n] = x[n] @ w[idx[n]] → [N, I] f32; x [N, H] and w [E, H, I]
    f32 or bf16, idx [N] int32. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return gather_matmul_plain(x, w, idx)
    name = "gather_matmul"
    _lib.require_cuda(name, x, w, idx)
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: x must be [N, H] and w [E, H, I], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    N, H = x.shape
    E, _, I = w.shape
    if idx.shape != (N,) or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be [N] = [{N}] int32")
    for t in (x, w):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: x and w must be f32 or bf16, got {t.dtype}")
    out = torch.empty((N, I), dtype=torch.float32, device=x.device)
    if N == 0 or I == 0:
        return out
    err = _lib.lib().dsocr_gather_matmul(
        x.data_ptr(), w.data_ptr(), idx.data_ptr(), out.data_ptr(), N, H, I, E,
        _lib.DTYPE_CODES[x.dtype], _lib.DTYPE_CODES[w.dtype], _lib.stream_ptr(x),
    )
    _lib.check(err, name)
    _lib.count_launch(gather_matmul)
    return out


gather_matmul.launches = 0
