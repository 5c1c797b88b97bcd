"""Fused dequantize-matmul over packed Q4_K and Q6_K weights.

For each format, four wrappers over CUDA kernels (the row layout in
csrc/row_matmul.cu; the gather tier and the dense expert sweeps in
csrc/expert_sweep.cu through csrc/kquant_matmul.cu's C entries; one body
each with Q8_0's) serve the
six Pallas functions of dsocr_tpu/ops/pallas/kquant_matmul.py that the
packed serving path reaches (a torch view of ``W[layer]`` costs no copy,
so one kernel serves a function and its ``_layered`` twin):

- ``q4k_matmul`` ← q4k_matmul (:210) and q4k_matmul_layered (:334);
  ``q6k_matmul`` ← q6k_matmul (:278) and q6k_matmul_layered (:403). Row
  layout: the plain projections (qkv 1280→3840, o 1280→1280, shared
  gate+up 1280→3584, shared down 1792→1280) at N = 16 rows per decode
  step and up to 16 × 1024 rows per prefill wave, and the lm_head
  (1280→129280).
- ``q4k_gather_matmul`` ← q4k_gather_matmul (:568) and
  q4k_gather_matmul_layered (:609); ``q6k_gather_matmul`` ←
  q6k_gather_matmul (:706) and q6k_gather_matmul_layered (:746):
  ``out[n] = x[n] @ W[idx[n]]``, in-major; the routed experts' gate+up
  while N·top_k ≤ E.
- ``q4k_dense_experts`` ← q4k_dense_experts_layered (:821);
  ``q6k_dense_experts`` ← q6k_dense_experts_layered (:959):
  ``out[e] = x @ W[e]`` → [E, N, M]; expert gate+up once N·top_k > E.
- ``q4k_dense_experts_perx`` ← q4k_dense_experts_perx_layered (:885);
  ``q6k_dense_experts_perx`` ← q6k_dense_experts_perx_layered (:1002):
  ``out[e] = x[e] @ W[e]``. DeepSeek's full-width down projection (in
  dim 896) is Q8_0 and never reaches them; an expert intermediate that is
  a multiple of 256 does.

Layouts (dsq/serve_quant.py packs them; not the reference's plane
splits): adjacent K values per byte, the first in the low bits. Q4_K:
4-bit codes, per 32 K values an f32 scale s = d·sc and an f32 min
b = dmin·m; row layout codes [M, K/2] uint8, scales and mins [M, K/32];
in-major codes [E, K/2, M], scales and mins [E, K/32, M]; 0.75 bytes per
weight. Q6_K: the low 4 bits of the 6-bit codes as Q4_K's codes, the
2-bit high parts four per byte, per 16 K values an f32 scale s = d·sc;
row layout codes [M, K/2], highs [M, K/4], scales [M, K/16]; in-major
[E, K/2, M], [E, K/4, M], [E, K/16, M]; 1.0 byte per weight, as the
reference's. K is a multiple of 256 (a super-block).

Numerics are the reference's: the weight is bf16(f32(q) · s − b) (Q4_K,
q · s exact in f32) or bf16(f32(q − 32) · s) (Q6_K: one rounded product;
(q − 32) · s may need 25 bits), rounded once per element; the activation
is bf16(x) whatever the model dtype; products accumulate in f32. A bf16 ×
bf16 product is exact in f32, so the kernels' sums differ from the twins
only in order.

What bounds them on the H100, and what the designs do about it:
- the row layout: as ``q8_matmul`` (dequant_matmul.py, row_matmul.py):
  at decode (N ≤ 16) a bytes-bound GEMV that dequantizes 16-byte code
  vectors in registers into mma.sync fragments (the lm_head's 124 MB of
  Q4_K codes, ≥ 0.037 ms at 3.35 TB/s, and 165.5 MB of Q6_K, ≥ 0.049
  ms); at prefill a dequant pass into a bf16 workspace and the wgmma GEMM
  fed by TMA (qkv at N 16384: 161 GFLOP, ≥ 0.16 ms at 989 TFLOP/s).
- the experts at decode (N ≤ 16) are device-memory bytes: expert gate+up
  of one layer is 110 MB in Q4_K (≥ 0.033 ms at 3.35 TB/s) and 146.8 MB in
  Q6_K (≥ 0.044 ms); the gather tier reads each distinct selected expert
  once (1.72 MB of Q4_K gate+up, 2.29 MB of Q6_K). Both tiers run
  csrc/expert_sweep.cu's body (as ``q8_dense_experts`` and
  ``q8_gather_matmul``, dequant_matmul.py): codes, highs, scales, mins and
  x through a cp.async ring, decoded in registers into mma.sync
  fragments; a lane's two code rows hold its 4 K rows (two K values a
  byte), a Q6_K lane's one highs row their high bits. The gather tier's
  blocks group the selections by expert from ``idx`` in the kernel, so
  each selected expert is read once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ...dsq.quant import Q4K_SUB, Q6K_SUB, QK_K
from ...dsq.serve_quant import unpack_bits
from . import _lib
from .row_matmul import row_launch


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def dequant_q4k(codes: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Packed codes with K/2 bytes along `dim` (-1 row layout, -2
    in-major) → bf16(f32(q) · s − b) with K values along `dim`. The scales
    and mins broadcast over their 32 values instead of being repeated, and
    the product and difference run in place: one f32 weight is the peak."""
    dim %= codes.dim()
    w = unpack_bits(codes, dim, 4).unflatten(dim, (-1, Q4K_SUB)).float()
    w.mul_(scales.unsqueeze(dim + 1)).sub_(mins.unsqueeze(dim + 1))
    return w.flatten(dim, dim + 1).to(torch.bfloat16)


def dequant_q6k(codes: torch.Tensor, highs: torch.Tensor, scales: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Packed low nibbles (K/2 bytes along `dim`) and highs (K/4 bytes) →
    bf16(f32(q − 32) · s) with K values along `dim`, in place as above."""
    dim %= codes.dim()
    q = unpack_bits(codes, dim, 4) | (unpack_bits(highs, dim, 2) << 4)
    w = q.unflatten(dim, (-1, Q6K_SUB)).float().sub_(32.0)
    w.mul_(scales.unsqueeze(dim + 1))
    return w.flatten(dim, dim + 1).to(torch.bfloat16)


def q4k_matmul_plain(x, codes, scales, mins):
    return torch.matmul(_bf16(x), dequant_q4k(codes, scales, mins, -1).float().t())


def q4k_gather_matmul_plain(x, codes, scales, mins, idx):
    idx = idx.long()
    w = dequant_q4k(codes[idx], scales[idx], mins[idx], -2).float()  # [N, K, M]
    return torch.bmm(_bf16(x)[:, None, :], w)[:, 0]


def q4k_dense_experts_plain(x, codes, scales, mins):
    return torch.matmul(_bf16(x)[None], dequant_q4k(codes, scales, mins, -2).float())


def q4k_dense_experts_perx_plain(x, codes, scales, mins):
    return torch.matmul(_bf16(x), dequant_q4k(codes, scales, mins, -2).float())


def q6k_matmul_plain(x, codes, highs, scales):
    return torch.matmul(_bf16(x), dequant_q6k(codes, highs, scales, -1).float().t())


def q6k_gather_matmul_plain(x, codes, highs, scales, idx):
    idx = idx.long()
    w = dequant_q6k(codes[idx], highs[idx], scales[idx], -2).float()  # [N, K, M]
    return torch.bmm(_bf16(x)[:, None, :], w)[:, 0]


def q6k_dense_experts_plain(x, codes, highs, scales):
    return torch.matmul(_bf16(x)[None], dequant_q6k(codes, highs, scales, -2).float())


def q6k_dense_experts_perx_plain(x, codes, highs, scales):
    return torch.matmul(_bf16(x), dequant_q6k(codes, highs, scales, -2).float())


# A format's buffers in argument order: (name, dtype, K values per element
# along K). ops/linear.py's holders register the same buffers.
Q4K_PARTS = (("codes", torch.uint8, 2), ("scales", torch.float32, Q4K_SUB),
             ("mins", torch.float32, Q4K_SUB))
Q6K_PARTS = (("codes", torch.uint8, 2), ("highs", torch.uint8, 4), ("scales", torch.float32, Q6K_SUB))


class _Format(NamedTuple):
    """A packed format as the kernels take it: its buffers, its name
    (row_matmul.FORMAT_CODES) and the expert kernel's C entry point."""

    parts: Tuple[Tuple[str, torch.dtype, int], ...]
    method: str
    expert_fn: str


_Q4K = _Format(Q4K_PARTS, "q4_k", "dsocr_q4k_expert_matmul")
_Q6K = _Format(Q6K_PARTS, "q6_k", "dsocr_q6k_expert_matmul")


def _check_x(name, x, K):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if x.shape[-1] != K or K % QK_K:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match K = {K} (a multiple of {QK_K})")


def _check_packed(name, fmt: _Format, packed, K, in_major):
    """Dtypes, shapes and 16-byte alignment of the packed buffers for a
    K-deep weight: row layout [M, K/d], in-major [E, K/d, M]."""
    lead = packed[0].shape[:1] if in_major else packed[0].shape[:-1]
    tail = packed[0].shape[-1:] if in_major else ()
    for t, (part, dtype, per) in zip(packed, fmt.parts):
        want = (*lead, K // per, *tail)
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"{name}: {part} {t.dtype} {tuple(t.shape)}, expected {dtype} {want}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {part} must be 16-byte aligned")


def _row_launch(wrapper, fmt: _Format, x, *packed):
    """x [N, K] @ dequant(W [M, K])ᵀ through csrc/row_matmul.cu."""
    name = wrapper.__name__
    _lib.require_cuda(name, x, *packed)
    N, K = x.shape
    _check_x(name, x, K)
    _check_packed(name, fmt, packed, K, in_major=False)
    return row_launch(wrapper, fmt.method, x, packed)


def _expert_launch(wrapper, fmt: _Format, x, packed, idx, groups, rows, x_group_stride, out):
    """One launch of the in-major expert kernel: group g multiplies
    `rows` rows of x (from x + g * x_group_stride) by expert idx[g] (or
    expert g when idx is None) into out[g]."""
    name = wrapper.__name__
    E, K2, M = packed[0].shape
    K = 2 * K2
    _check_x(name, x, K)
    _check_packed(name, fmt, packed, K, in_major=True)
    if M % 4:
        raise ValueError(f"{name}: M = {M} must be a multiple of 4")
    if groups == 0 or rows == 0 or M == 0:
        return out
    err = getattr(_lib.lib(), fmt.expert_fn)(
        x.data_ptr(), *(t.data_ptr() for t in packed), _lib.ptr(idx), out.data_ptr(), groups, rows,
        K, M, E, x_group_stride, _lib.DTYPE_CODES[x.dtype], _lib.stream_ptr(x),
    )
    _lib.check(err, name)
    _lib.count_launch(wrapper)
    return out


def _gather(wrapper, fmt, x, packed, idx):
    name = wrapper.__name__
    _lib.require_cuda(name, x, *packed, idx)
    N = x.shape[0]
    if x.dim() != 2 or idx.shape != (N,) or idx.dtype != torch.int32:
        raise ValueError(f"{name}: x must be [N, K] and idx [N] int32")
    out = torch.empty((N, packed[0].shape[-1]), dtype=torch.float32, device=x.device)
    return _expert_launch(wrapper, fmt, x, packed, idx, N, 1, x.shape[1], out)


def _dense(wrapper, fmt, x, packed):
    name = wrapper.__name__
    _lib.require_cuda(name, x, *packed)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [N, K]")
    E, _, M = packed[0].shape
    out = torch.empty((E, x.shape[0], M), dtype=torch.float32, device=x.device)
    return _expert_launch(wrapper, fmt, x, packed, None, E, x.shape[0], 0, out)


def _dense_perx(wrapper, fmt, x, packed):
    name = wrapper.__name__
    _lib.require_cuda(name, x, *packed)
    E, _, M = packed[0].shape
    if x.dim() != 3 or x.shape[0] != E:
        raise ValueError(f"{name}: x must be [E, N, K] with E = {E}")
    N, K = x.shape[1], x.shape[2]
    out = torch.empty((E, N, M), dtype=torch.float32, device=x.device)
    return _expert_launch(wrapper, fmt, x, packed, None, E, N, N * K, out)


# Each wrapper runs its twin on a CPU tensor and launches its kernel on a
# CUDA tensor (raising on what the kernel does not take).


def q4k_matmul(x, codes, scales, mins):
    """x [N, K] (f32 or bf16) @ dequant(W)ᵀ → [N, M] f32, with W in row
    layout: codes [M, K/2] uint8, scales and mins [M, K/32] f32."""
    if x.device.type == "cpu":
        return q4k_matmul_plain(x, codes, scales, mins)
    return _row_launch(q4k_matmul, _Q4K, x, codes, scales, mins)


def q4k_gather_matmul(x, codes, scales, mins, idx):
    """out[n] = bf16(x[n]) @ dequant(W[idx[n]]) → [N, M] f32; x [N, K],
    in-major codes [E, K/2, M] uint8, scales and mins [E, K/32, M] f32,
    idx [N] int32 (an index outside [0, E) gives a zero row on the card)."""
    if x.device.type == "cpu":
        return q4k_gather_matmul_plain(x, codes, scales, mins, idx)
    return _gather(q4k_gather_matmul, _Q4K, x, (codes, scales, mins), idx)


def q4k_dense_experts(x, codes, scales, mins):
    """out[e] = bf16(x) @ dequant(W[e]) → [E, N, M] f32; x [N, K] shared by
    every expert, in-major codes [E, K/2, M], scales and mins [E, K/32, M]."""
    if x.device.type == "cpu":
        return q4k_dense_experts_plain(x, codes, scales, mins)
    return _dense(q4k_dense_experts, _Q4K, x, (codes, scales, mins))


def q4k_dense_experts_perx(x, codes, scales, mins):
    """out[e] = bf16(x[e]) @ dequant(W[e]) → [E, N, M] f32; x [E, N, K]."""
    if x.device.type == "cpu":
        return q4k_dense_experts_perx_plain(x, codes, scales, mins)
    return _dense_perx(q4k_dense_experts_perx, _Q4K, x, (codes, scales, mins))


def q6k_matmul(x, codes, highs, scales):
    """x [N, K] (f32 or bf16) @ dequant(W)ᵀ → [N, M] f32, with W in row
    layout: codes [M, K/2] and highs [M, K/4] uint8, scales [M, K/16] f32."""
    if x.device.type == "cpu":
        return q6k_matmul_plain(x, codes, highs, scales)
    return _row_launch(q6k_matmul, _Q6K, x, codes, highs, scales)


def q6k_gather_matmul(x, codes, highs, scales, idx):
    """out[n] = bf16(x[n]) @ dequant(W[idx[n]]) → [N, M] f32; x [N, K],
    in-major codes [E, K/2, M] and highs [E, K/4, M] uint8, scales
    [E, K/16, M] f32, idx [N] int32 (outside [0, E): a zero row on the card)."""
    if x.device.type == "cpu":
        return q6k_gather_matmul_plain(x, codes, highs, scales, idx)
    return _gather(q6k_gather_matmul, _Q6K, x, (codes, highs, scales), idx)


def q6k_dense_experts(x, codes, highs, scales):
    """out[e] = bf16(x) @ dequant(W[e]) → [E, N, M] f32; x [N, K] shared by
    every expert, in-major as q6k_gather_matmul."""
    if x.device.type == "cpu":
        return q6k_dense_experts_plain(x, codes, highs, scales)
    return _dense(q6k_dense_experts, _Q6K, x, (codes, highs, scales))


def q6k_dense_experts_perx(x, codes, highs, scales):
    """out[e] = bf16(x[e]) @ dequant(W[e]) → [E, N, M] f32; x [E, N, K]."""
    if x.device.type == "cpu":
        return q6k_dense_experts_perx_plain(x, codes, highs, scales)
    return _dense_perx(q6k_dense_experts_perx, _Q6K, x, (codes, highs, scales))


for _fn in (q4k_matmul, q4k_gather_matmul, q4k_dense_experts, q4k_dense_experts_perx,
            q6k_matmul, q6k_gather_matmul, q6k_dense_experts, q6k_dense_experts_perx):
    _fn.launches = 0
