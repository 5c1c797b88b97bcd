"""The launch plan and the one launch of the row-layout dequant matmuls.

``q8_matmul``, ``q4k_matmul`` and ``q6k_matmul`` (dequant_matmul.py,
kquant_matmul.py) check their packed weights and call :func:`row_launch`,
which runs csrc/row_matmul.cu's ``dsocr_row_matmul``: the decode GEMV
for N ≤ ``GEMV_MAX_N`` rows of x, else the dequant pass into a bf16
workspace and the wgmma GEMM. :func:`row_plan` is the whole shape logic,
pure Python so that the CPU tests reach it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _lib

# format codes shared with csrc/quant_decode.cuh (QFormat)
FORMAT_CODES = {"q8_0": 0, "q4_k": 1, "q6_k": 2}
# rows of x the GEMV takes (two n8 tiles); above this the GEMM runs
GEMV_MAX_N = 16
TARGET_BLOCKS = 264   # two GEMV blocks per SM on the H100's 132
GEMM_ROWS, GEMM_COLS = 128, 256  # a GEMM block's rows of x and rows of W


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class RowPlan(NamedTuple):
    """How one row matmul launches: ``path`` "gemv" (``wm`` of a block's
    eight warps own 16 W rows each, the other 8 / wm split K) or "gemm"
    (W dequantized into a bf16 ``workspace`` of that shape first, then
    the wgmma GEMM); ``grid`` is the (GEMM's) grid."""

    path: str
    wm: int
    grid: Tuple[int, int]
    workspace: Optional[Tuple[int, int]]


def row_plan(N: int, K: int, M: int) -> RowPlan:
    """The launch of out [N, M] = x [N, K] @ W [M, K]ᵀ. The GEMV takes the
    most W rows a block (wm = 8, 4 or 2 warps of 16) that still leaves
    TARGET_BLOCKS blocks, else wm = 1: its warps split K, and the grid
    has as many blocks as the weight has 16-row tiles."""
    if N > GEMV_MAX_N:
        return RowPlan("gemm", 0, (_cdiv(M, GEMM_COLS), _cdiv(N, GEMM_ROWS)), (M, K))
    tiles = _cdiv(M, 16)
    wm = next((wm for wm in (8, 4, 2) if _cdiv(tiles, wm) >= TARGET_BLOCKS), 1)
    return RowPlan("gemv", wm, (_cdiv(tiles, wm), 1), None)


def row_launch(wrapper, fmt: str, x: torch.Tensor, parts) -> torch.Tensor:
    """x [N, K] (f32 or bf16, on the card) @ dequant(W)ᵀ → [N, M] f32 for
    the checked packed `parts` of W (2 or 3 tensors, M rows). f32 x is
    rounded to bf16 first, as the reference rounds it; x must start on a
    16-byte boundary (TMA and the GEMV's 16-byte loads)."""
    name = wrapper.__name__
    N, K = x.shape
    M = parts[0].shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    if N == 0 or M == 0:
        return out
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    if xb.data_ptr() % 16 or (K * 2) % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary with rows a multiple of 16 bytes")
    plan = row_plan(N, K, M)
    ws = None
    if plan.workspace is not None:
        ws = torch.empty(plan.workspace, dtype=torch.bfloat16, device=x.device)
    p = tuple(parts) + (None,) * (3 - len(parts))
    err = _lib.lib().dsocr_row_matmul(
        FORMAT_CODES[fmt], xb.data_ptr(), *(_lib.ptr(t) for t in p), _lib.ptr(ws), out.data_ptr(),
        N, K, M, plan.wm, _lib.stream_ptr(x),
    )
    _lib.check(err, name)
    _lib.count_launch(wrapper)
    return out
