"""The launch plan and the one launch of the row-layout dequant matmuls.

``q8_matmul``, ``q4k_matmul`` and ``q6k_matmul`` (dequant_matmul.py,
kquant_matmul.py) check their packed weights and call :func:`row_launch`,
which runs csrc/row_matmul.cu's ``dsocr_row_matmul``: the decode GEMV
for N ≤ ``GEMV_MAX_N`` rows of x, else the dequant pass into a bf16
workspace and the wgmma GEMM. :func:`row_plan` is the whole shape logic,
pure Python so that the CPU tests reach it.

The GEMV stages its x rows in shared memory whole (``gemv_smem``): 16
rows of DotsOCR's down projection (K 8,960) would take 295 KB, past the
card's 227 KB a block, so such a call runs the GEMV once per 8 rows
(each launch reads W again), and a K too long for 8 rows takes the GEMM.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _lib

# format codes shared with csrc/quant_decode.cuh (QFormat)
FORMAT_CODES = {"q8_0": 0, "q4_k": 1, "q6_k": 2}
# rows of x the GEMV takes (two n8 tiles); above this the GEMM runs
GEMV_MAX_N = 16
TARGET_BLOCKS = 264   # two GEMV blocks per SM on the H100's 132
GEMM_ROWS, GEMM_COLS = 128, 256  # a GEMM block's rows of x and rows of W
GV_STEP, GV_WARPS = 128, 8  # csrc/row_matmul.cu: K values a warp step, warps a GEMV block
GEMV_SMEM_BYTES = 227 * 1024  # the H100's opt-in shared memory a block


def gemv_smem(n: int, k: int) -> int:
    """The GEMV's dynamic shared memory for n rows of x at K = k (as
    csrc/row_matmul.cu's launch_gemv sizes it): the rows of one n8 tile
    (n ≤ 8) or two, staged as bf16 over K padded to GV_STEP, and the K
    groups' partial sums."""
    nt = 1 if n <= 8 else 2
    kx = _cdiv(k, GV_STEP) * GV_STEP
    return 8 * nt * (kx + 8) * 2 + GV_WARPS * 16 * 8 * nt * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class RowPlan(NamedTuple):
    """How one row matmul launches: ``path`` "gemv" (``wm`` of a block's
    eight warps own 16 W rows each, the other 8 / wm split K) or "gemm"
    (W dequantized into a bf16 ``workspace`` of that shape first, then
    the wgmma GEMM); ``grid`` is the (GEMM's) grid; ``rows`` the rows of
    x one launch takes (all N, or 8 where N rows' staged x would not fit)."""

    path: str
    wm: int
    grid: Tuple[int, int]
    workspace: Optional[Tuple[int, int]]
    rows: int


def row_plan(N: int, K: int, M: int, smem_bytes: int = GEMV_SMEM_BYTES) -> RowPlan:
    """The launch of out [N, M] = x [N, K] @ W [M, K]ᵀ. The GEMV takes the
    most W rows a block (wm = 8, 4 or 2 warps of 16) that still leaves
    TARGET_BLOCKS blocks, else wm = 1: its warps split K, and the grid
    has as many blocks as the weight has 16-row tiles. Its x rows go in
    launches of N, or of 8 where N rows exceed `smem_bytes`; the GEMM
    takes N > GEMV_MAX_N, and a K that 8 rows exceed."""
    if N > GEMV_MAX_N or gemv_smem(min(N, 8), K) > smem_bytes:
        return RowPlan("gemm", 0, (_cdiv(M, GEMM_COLS), _cdiv(N, GEMM_ROWS)), (M, K), N)
    tiles = _cdiv(M, 16)
    wm = next((wm for wm in (8, 4, 2) if _cdiv(tiles, wm) >= TARGET_BLOCKS), 1)
    return RowPlan("gemv", wm, (_cdiv(tiles, wm), 1), None, N if gemv_smem(N, K) <= smem_bytes else 8)


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
    plan = row_plan(N, K, M, _smem_optin(x.device))
    ws = None
    if plan.workspace is not None:
        ws = torch.empty(plan.workspace, dtype=torch.bfloat16, device=x.device)
    p = tuple(parts) + (None,) * (3 - len(parts))
    for r0 in range(0, N, plan.rows):
        n = min(plan.rows, N - r0)
        err = _lib.lib().dsocr_row_matmul(
            FORMAT_CODES[fmt], xb.data_ptr() + r0 * K * 2, *(_lib.ptr(t) for t in p), _lib.ptr(ws),
            out.data_ptr() + r0 * M * 4, n, K, M, plan.wm, _lib.stream_ptr(x),
        )
        _lib.check(err, name)
        _lib.count_launch(wrapper)
    return out


def _smem_optin(device: torch.device) -> int:
    """The card's opt-in shared memory a block (GEMV_SMEM_BYTES where the
    properties do not say), read once per card."""
    if device.type != "cuda":
        return GEMV_SMEM_BYTES
    return _card_smem_optin(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _card_smem_optin(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return int(getattr(props, "shared_memory_per_block_optin", GEMV_SMEM_BYTES))
