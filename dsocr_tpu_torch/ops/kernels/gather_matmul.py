"""Expert-gather matmul over a float expert stack.

``gather_matmul`` replaces gather_matmul
(dsocr_tpu/ops/pallas/gather_matmul.py:62, ``pallas_call`` at :86):
``out[n] = x[n] @ w[idx[n]]`` → [N, I] f32, for x [N, H] and an expert
stack w [E, H, I], each f32 or bf16, and idx [N] int32. Its one caller is
ops/moe.py's gather tier, ``moe_apply(..., gather_threshold=N)`` on the
decoder's split layout: gate and up at [N·6, 1280] × [64, 1280, 896] and
down at [N·6, 896] × [64, 896, 1280] at full width.

What bounds it on the H100: device-memory bytes. Each selected expert's
[H, I] slab must be read once, and each weight then takes part in one
product per selection of its expert: 2 FLOPs a weight a selection, far
below the ~295 FLOPs per byte where the tensor cores would be the limit.
Counted per distinct expert, the bytes are ``#distinct(idx) · H·I·elem``:
at full width gate/up, 48 distinct experts of 96 selections in bf16 are
110 MB (33 µs at 3.35 TB/s), 11 of 12 in f32 50.5 MB (15 µs). That is the
bound; reading a slab once per selection instead (220 MB at 96 bf16 rows)
is what the design avoids.

What the design does (csrc/gather_matmul.cu): blocks group the
selections by expert from idx themselves (no host sort, no sync), up to
16 selections of one expert a task (the 17th starts the next), so a
slab's column tile crosses device memory once per 16 of its selections;
the slab streams through a ring of 16 KB stages (3 for a bf16 stack, 2
for f32) filled by 16-byte cp.async copies (narrower where I or the
pointer allow no 16; zero past H and I); where
few experts are selected, a cluster of 2 to 8 blocks splits each task's
K and adds its sums in rank order through distributed shared memory.
bf16 x with bf16 w runs on mma.sync (products exact in f32, f32 sums);
any f32 operand runs on FFMA with f32 products, as the reference's
``dot_general`` multiplies: rounding x or w to bf16 would break the
tolerance of 1e-5 · max(|x| @ |W|), and TF32 would need three products
a weight to keep f32. The summation order is fixed and no sum crosses
rows, so two launches give the same bits and a row's bits do not depend
on which other selections share its expert. Any N, H and I.

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
