"""The launch plan and the launch of the row-layout dequant matmuls
(ops/kernels/row_matmul.py), on the CPU: which path a shape takes, how the
GEMV's and the GEMM's grids and the GEMV's K steps cover the product, the
workspace, and what row_launch hands the CUDA library (a stand-in
library records the call; no card is needed)."""

import ctypes
import pathlib
import math

import pytest
import torch

from dsocr_tpu_torch.ops.kernels import _lib
from dsocr_tpu_torch.ops.kernels import row_matmul as rm

# (name, K, M) of the main path's row-layout weights at full width
MAIN_SHAPES = [("qkv", 1280, 3840), ("o", 1280, 1280), ("shared_gate_up", 1280, 3584),
               ("shared_down", 1792, 1280), ("lm_head", 1280, 129280)]
GV_STEP, GV_WARPS = 128, 8  # csrc/row_matmul.cu


def _gemv_cover(K, M, plan):
    """(row → times covered, K step → times covered per W row tile) as the
    GEMV kernel walks them: block b, warp w owns rows 16 (b·wm + w % wm)
    .. + 15 and the steps w / wm, + 8 / wm, ..."""
    wm = plan.wm
    wk = GV_WARPS // wm
    ksteps = math.ceil(K / GV_STEP)
    rows, steps = [0] * M, {}
    for b in range(plan.grid[0]):
        for w in range(GV_WARPS):
            m0 = (b * wm + w % wm) * 16
            if w // wm == 0:
                for m in range(m0, min(m0 + 16, M)):
                    rows[m] += 1
            for s in range(w // wm, ksteps, wk):
                steps[(m0, s)] = steps.get((m0, s), 0) + 1
    return rows, steps


@pytest.mark.parametrize("n", [1, 2, 8, 16])
@pytest.mark.parametrize("name,k,m", MAIN_SHAPES + [("tail", 96, 200), ("tail", 32, 36)])
def test_gemv_plan_covers_every_row_and_k_step_once(n, name, k, m):
    plan = rm.row_plan(n, k, m)
    assert plan.path == "gemv" and plan.workspace is None and plan.grid[1] == 1
    assert plan.wm in (1, 2, 4, 8)
    rows, steps = _gemv_cover(k, m, plan)
    assert rows == [1] * m
    tiles = range(0, plan.grid[0] * plan.wm * 16, 16)
    assert steps == {(m0, s): 1 for m0 in tiles for s in range(math.ceil(k / GV_STEP))}


@pytest.mark.parametrize("name,k,m", MAIN_SHAPES)
def test_gemv_plan_fills_the_card(name, k, m):
    """The most W rows a block that still leaves two blocks per SM, else a
    block per 16-row tile (wm 1), the most blocks the GEMV makes."""
    assert rm.TARGET_BLOCKS == 2 * 132
    plan = rm.row_plan(16, k, m)
    tiles = math.ceil(m / 16)
    assert plan.grid[0] == math.ceil(tiles / plan.wm)
    assert plan.grid[0] >= rm.TARGET_BLOCKS or plan.wm == 1
    if plan.wm < 8:
        assert math.ceil(tiles / (2 * plan.wm)) < rm.TARGET_BLOCKS
    if name == "lm_head":
        assert plan.wm == 8


@pytest.mark.parametrize("n", [17, 300, 1024, 16384])
@pytest.mark.parametrize("name,k,m", MAIN_SHAPES[:4] + [("tail", 96, 200), ("tail", 32, 36)])
def test_gemm_plan_tiles_cover_the_output_once(n, name, k, m):
    plan = rm.row_plan(n, k, m)
    assert plan.path == "gemm" and plan.workspace == (m, k)
    gx, gy = plan.grid
    assert (gx - 1) * rm.GEMM_COLS < m <= gx * rm.GEMM_COLS
    assert (gy - 1) * rm.GEMM_ROWS < n <= gy * rm.GEMM_ROWS


def test_gemv_takes_at_most_sixteen_rows():
    assert rm.GEMV_MAX_N == 16
    assert rm.row_plan(16, 1280, 3840).path == "gemv"
    assert rm.row_plan(17, 1280, 3840).path == "gemm"


class _FakeLib:
    """Stands in for the CUDA library: records dsocr_row_matmul's args."""

    def __init__(self):
        self.calls = []
        self.x_head = None

    def dsocr_row_matmul(self, *args):
        self.calls.append(args)
        self.x_head = ctypes.string_at(args[1], 16)  # x's first 16 bytes, as the kernel would read them
        return 0


def _launch(monkeypatch, x, parts, fmt="q8_0"):
    fake = _FakeLib()
    monkeypatch.setattr(_lib, "lib", lambda: fake)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 0)
    empties = []
    real_empty = torch.empty

    def spy(*shape, **kw):
        t = real_empty(*shape, **kw)
        empties.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)

    def wrapper():
        pass

    wrapper.launches = 0
    out = rm.row_launch(wrapper, fmt, x, parts)
    return out, fake.calls, empties, wrapper.launches, fake.x_head


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("n,x_dtype", [(16, torch.float32), (16, torch.bfloat16), (300, torch.float32),
                                       (300, torch.bfloat16)])
def test_row_launch_hands_bf16_x_and_the_workspace(monkeypatch, fmt, n, x_dtype):
    k, m = 256, 96
    x = torch.randn((n, k), generator=torch.Generator().manual_seed(n)).to(x_dtype)
    parts = (torch.zeros((m, k // 2), dtype=torch.uint8), torch.zeros((m, k // 32)),
             torch.zeros((m, k // 32)))[: 2 if fmt == "q8_0" else 3]
    out, calls, empties, launches, x_head = _launch(monkeypatch, x, parts, fmt)
    assert out.shape == (n, m) and out.dtype == torch.float32
    assert launches == 1 and len(calls) == 1
    fmt_code, x_ptr, p0, p1, p2, ws_ptr, out_ptr, N, K, M, wm, stream = calls[0]
    assert fmt_code == rm.FORMAT_CODES[fmt] and (N, K, M) == (n, k, m) and stream == 0
    assert (p0, p1) == (parts[0].data_ptr(), parts[1].data_ptr())
    assert p2 == (None if fmt == "q8_0" else parts[2].data_ptr())
    assert out_ptr == out.data_ptr()
    plan = rm.row_plan(n, k, m)
    assert wm == plan.wm
    # the kernel reads bf16(x): the reference's rounding, a tensor of its own for f32 x
    assert x_head == x[0, :8].to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    assert (x_ptr == x.data_ptr()) == (x_dtype == torch.bfloat16)
    if plan.path == "gemm":
        ws = [t for t in empties if t.dtype == torch.bfloat16 and t.shape == (m, k)]
        assert len(ws) == 1 and ws_ptr == ws[0].data_ptr()
    else:
        assert ws_ptr is None


def test_row_launch_raises_on_misaligned_x(monkeypatch):
    flat = torch.zeros(16 * 256 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(16, 256)  # 2 bytes past a 16-byte boundary
    parts = (torch.zeros((96, 256), dtype=torch.int8), torch.zeros((96, 8)))
    with pytest.raises(ValueError, match="16-byte"):
        _launch(monkeypatch, x, parts)


def test_row_launch_skips_empty_products(monkeypatch):
    x = torch.zeros((0, 256), dtype=torch.bfloat16)
    parts = (torch.zeros((96, 256), dtype=torch.int8), torch.zeros((96, 8)))
    out, calls, _, launches, _ = _launch(monkeypatch, x, parts)
    assert out.shape == (0, 96) and calls == [] and launches == 0


def test_gemv_smem_is_the_kernels_and_long_k_splits_rows():
    """csrc/row_matmul.cu's launch_gemv asks for 8·NT·(K padded to 128 + 8)
    bf16 x values and 8·16·8·NT f32 partial sums (NT = 1 for N ≤ 8, else
    2). DotsOCR's down projection (K 8,960) at 16 rows would need 295 KB
    against the card's 227 KB: the GEMV runs it 8 rows a launch; a K too
    long for 8 rows takes the GEMM; DeepSeek's longest (6,848) still fits
    16 rows."""
    source = (pathlib.Path(rm.__file__).parents[2] / "csrc" / "row_matmul.cu").read_text()
    assert "const size_t smem = (size_t)8 * NT * (kx + 8) * 2 + (size_t)GV_WARPS * 16 * 8 * NT * 4;" in source
    assert rm.gemv_smem(16, 8960) == 16 * 8968 * 2 + 8 * 16 * 8 * 2 * 4 > rm.GEMV_SMEM_BYTES
    assert rm.gemv_smem(8, 8960) < rm.GEMV_SMEM_BYTES
    for n in (1, 8):
        assert rm.row_plan(n, 8960, 1536).rows == n
    for n in (9, 16):
        plan = rm.row_plan(n, 8960, 1536)
        assert plan.path == "gemv" and plan.rows == 8
    assert rm.row_plan(16, 6848, 1280).rows == 16
    assert rm.row_plan(16, 1536, 151936).rows == 16
    long_k = rm.row_plan(4, 16384, 1024)
    assert long_k.path == "gemm" and long_k.workspace == (1024, 16384) and long_k.rows == 4
    assert rm.row_plan(16, 8960, 1536, smem_bytes=300 * 1024).rows == 16


def test_row_launch_runs_long_k_in_row_chunks(monkeypatch):
    n, k, m = 13, 8960, 64
    x = torch.randn((n, k), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    parts = (torch.zeros((m, k), dtype=torch.int8), torch.zeros((m, k // 32)))
    out, calls, _, launches, _ = _launch(monkeypatch, x, parts)
    assert launches == 2 and len(calls) == 2
    for (_, x_ptr, _, _, _, ws_ptr, out_ptr, N, K, M, _, _), r0, rows in zip(calls, (0, 8), (8, 5)):
        assert (x_ptr, out_ptr, N, K, M, ws_ptr) == (x.data_ptr() + r0 * k * 2, out.data_ptr() + r0 * m * 4, rows,
                                                     k, m, None)
