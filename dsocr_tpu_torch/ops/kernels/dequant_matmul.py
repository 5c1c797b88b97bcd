"""Fused dequantize-matmul over packed Q8_0 weights.

Five wrappers over the CUDA kernels of csrc/row_matmul.cu,
csrc/expert_sweep.cu (through csrc/dequant_matmul.cu's C entry) and
csrc/moe_megafused.cu serve the seven Q8_0
Pallas functions of
dsocr_tpu/ops/pallas/dequant_matmul.py that the packed serving path
reaches (a torch view of ``W[layer]`` costs no copy, so one kernel serves
a function and its ``_layered`` twin):

- ``q8_matmul`` ← q8_matmul (:151) and q8_matmul_layered (:282). Row
  layout, codes [M, K], scales [M, K/32]: the plain projections (qkv
  1280→3840, o 1280→1280, shared gate+up 1280→3584, shared down
  1792→1280) at N = 16 rows per decode step and up to 16 × 1024 rows per
  prefill wave, and the lm_head (1280→129280); csrc/row_matmul.cu, one
  body with ``q4k_matmul`` and ``q6k_matmul`` (row_matmul.py).
- ``q8_gather_matmul`` ← q8_gather_matmul (:220) and
  q8_gather_matmul_layered (:349): ``out[n] = x[n] @ W[idx[n]]``,
  in-major codes [E, K, M], scales [E, K/32, M]; the routed experts while
  N·top_k ≤ E (≤ 60 rows at full width).
- ``q8_dense_experts`` ← q8_dense_experts_layered (:455):
  ``out[e] = x @ W[e]`` → [E, N, M]; expert gate+up once N·top_k > E.
- ``q8_dense_experts_perx`` ← q8_dense_experts_perx_layered (:495):
  ``out[e] = x[e] @ W[e]``; the down projection of that sweep.
- ``q8_moe_megafused`` ← q8_moe_megafused_layered (:629), in
  csrc/moe_megafused.cu on the sweep's body: the dense tier's whole
  expert chain in one kernel, ``out[n] = Σ_e w[e, n] · (silu(x@Wg[e]) ·
  (x@Wu[e])) @ Wd[e]``, under ``DSOCR_Q8_MEGAFUSED=1`` (ops/moe.py).

Numerics are the reference's ("fast" expand mode): the weight is
bf16(f32(code) · scale), rounded once per element; the activation is
bf16(x) whatever the model dtype; products accumulate in f32. A bf16 ×
bf16 product is exact in f32, so the kernels' tensor-core sums differ
from the twins only in summation order.

What bounds them on the H100, and what the designs do about it:
- the row layout at decode (N ≤ 16: qkv, o, shared gate+up and down
  at every step, the lm_head) is device-memory bytes: 4.9 MB of codes
  for qkv (1.5 µs at 3.35 TB/s), 165 MB for the lm_head. The GEMV of
  csrc/row_matmul.cu streams each warp's 16 W rows as 16-byte vectors,
  two steps of 128 K values in flight, and dequantizes them in registers
  straight into mma.sync fragments; a block per 16-row tile unless larger
  blocks still leave two per SM (row_matmul.row_plan).
- the row layout at prefill (N = 16384) is tensor-core work, 161 GFLOP
  for qkv (≥ 0.163 ms at 989 TFLOP/s) and 252 MB of f32 output: a
  dequant pass writes W once as bf16 into a workspace, and a wgmma GEMM
  fed by TMA through a 4-stage ring (a producer thread, two consumer
  warpgroups, 128 × 256 tiles) multiplies it.
- the experts at decode (N ≤ 32) are device-memory bytes: the dense tier
  reads every expert's codes once per step, ~2.4 GB of int8 plus ~0.3 GB
  of f32 scales over 11 MoE layers, ≥ ~0.8 ms per step at 3.35 TB/s
  (gate+up of one layer 0.052 ms, down 0.027); the gather tier reads each
  distinct selected expert once (2.58 MB of gate+up, 1.29 MB of down: at
  one request's 6 selections 15.5 MB, ≥ 4.6 µs). All four expert wrappers
  (``q8_gather_matmul``, ``q8_dense_experts``, ``q8_dense_experts_perx``)
  run csrc/expert_sweep.cu, one body with the K-quants': a block owns an
  expert's 128-column slab over all of K and streams its codes, scales
  and x through a 4-stage cp.async ring of 64 K rows, one barrier a
  stage; each lane decodes its 16 columns × 4 K rows of a 16-K chunk in
  registers straight into mma.sync.m16n8k16 A fragments (W as A, x as
  B), and the epilogue stores float4s from the C fragments after a sum
  over the block's 4 K-split warps in warp order. In the gather tier the
  blocks group the selections by expert from ``idx`` themselves: the
  block of an expert's first selection takes up to 16 of that expert's
  selections as one task (x rows gathered, output rows scattered), the
  others return at once, and where few experts are selected a cluster of
  blocks splits each task's K (sums added in rank order through
  distributed shared memory).
- the megafused chain is device-memory bytes too: one MoE layer's
  gate+up and down codes and scales, 146.8 + 18.4 + 73.4 + 9.2 ≈ 248 MB,
  ≥ 0.074 ms at 3.35 TB/s, against the two-kernel sweep's extra [E, N,
  2·MI] and [E, N, H] f32 round trips and its combine. It runs on the
  sweep's body (csrc/moe_megafused.cu over csrc/expert_sweep.cuh): a
  cluster of blocks serves one expert, each taking a share of its inter
  chunks (64 gate columns beside the 64 matching up columns, so a lane's
  C fragments hold gate and up of one column and bf16(silu(g)·u) forms in
  registers) and then a share of its output slabs, whose stages read the
  inter chunk they multiply from the block that owns it through
  distributed shared memory; one ring of stages runs through both phases.
  Per-expert f32 partials [E, N, H] (5.2 MB at full width) are summed in
  expert order by a second small kernel: two launches on the same inputs
  give the same bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...dsq.serve_quant import Q8_BLOCK
from . import _lib
from .row_matmul import row_launch


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dequant_rows(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Row layout [.., M, K] → f32 holding bf16(f32(code) · scale)."""
    return _bf16(codes.float() * scales.repeat_interleave(Q8_BLOCK, dim=-1))


def _dequant_inmajor(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """In-major layout [.., K, M] → f32 holding bf16(f32(code) · scale)."""
    return _bf16(codes.float() * scales.repeat_interleave(Q8_BLOCK, dim=-2))


def q8_matmul_plain(x, codes, scales):
    return torch.matmul(_bf16(x), _dequant_rows(codes, scales).t())


def q8_gather_matmul_plain(x, codes, scales, idx):
    idx = idx.long()
    w = _dequant_inmajor(codes[idx], scales[idx])  # [N, K, M]
    return torch.bmm(_bf16(x)[:, None, :], w)[:, 0]


def q8_dense_experts_plain(x, codes, scales):
    return torch.matmul(_bf16(x)[None], _dequant_inmajor(codes, scales))


def q8_dense_experts_perx_plain(x, codes, scales):
    return torch.matmul(_bf16(x), _dequant_inmajor(codes, scales))


def q8_moe_megafused_plain(x, weights, gu_codes, gu_scales, dn_codes, dn_scales):
    """The reference's chain and roundings: bf16(x), f32 gate+up, bf16
    inter, f32 down, weighted and summed over experts in expert order."""
    gus = torch.matmul(_bf16(x)[None], _dequant_inmajor(gu_codes, gu_scales))  # [E, N, 2MI]
    gate, up = torch.chunk(gus, 2, dim=-1)
    inter = _bf16(F.silu(gate) * up)
    dn = torch.matmul(inter, _dequant_inmajor(dn_codes, dn_scales))  # [E, N, H]
    out = torch.zeros_like(dn[0])
    for e in range(dn.shape[0]):
        out = out + weights[e][:, None].float() * dn[e]
    return out


def _check_x(name, x, K):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if x.shape[-1] != K or K % Q8_BLOCK:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match K = {K} (a multiple of 32)")


def _check_packed(name, codes, scales, c_shape, s_shape):
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{name}: codes must be int8 and scales f32")
    if tuple(codes.shape) != c_shape or tuple(scales.shape) != s_shape:
        raise ValueError(f"{name}: codes {tuple(codes.shape)} / scales {tuple(scales.shape)}, "
                         f"expected {c_shape} / {s_shape}")
    if codes.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError(f"{name}: codes and scales must be 16-byte aligned")


def q8_matmul(x, codes, scales):
    """x [N, K] (f32 or bf16) @ dequant(W)ᵀ → [N, M] f32, with W in row
    layout: codes [M, K] int8, scales [M, K/32] f32. CPU tensors run the
    plain version; CUDA tensors launch csrc/row_matmul.cu's kernels."""
    if x.device.type == "cpu":
        return q8_matmul_plain(x, codes, scales)
    name = "q8_matmul"
    _lib.require_cuda(name, x, codes, scales)
    N, K = x.shape
    M = codes.shape[0]
    _check_x(name, x, K)
    _check_packed(name, codes, scales, (M, K), (M, K // Q8_BLOCK))
    return row_launch(q8_matmul, "q8_0", x, (codes, scales))


q8_matmul.launches = 0


def _expert_launch(name, wrapper, x, codes, scales, idx, groups, rows, x_group_stride, out):
    """One launch of the in-major expert kernel: group g multiplies
    `rows` rows of x (from x + g * x_group_stride) by expert idx[g] (or
    expert g when idx is None) into out[g]."""
    E, K, M = codes.shape
    _check_x(name, x, K)
    _check_packed(name, codes, scales, (E, K, M), (E, K // Q8_BLOCK, M))
    if M % 4:
        raise ValueError(f"{name}: M = {M} must be a multiple of 4")
    if groups == 0 or rows == 0 or M == 0:
        return out
    err = _lib.lib().dsocr_q8_expert_matmul(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), _lib.ptr(idx), out.data_ptr(),
        groups, rows, K, M, E, x_group_stride, _lib.DTYPE_CODES[x.dtype], _lib.stream_ptr(x),
    )
    _lib.check(err, name)
    _lib.count_launch(wrapper)
    return out


def q8_gather_matmul(x, codes, scales, idx):
    """out[n] = bf16(x[n]) @ dequant(W[idx[n]]) → [N, M] f32; x [N, K],
    in-major codes [E, K, M] int8, scales [E, K/32, M] f32, idx [N] int32
    (an index outside [0, E) gives a zero row on the card)."""
    if x.device.type == "cpu":
        return q8_gather_matmul_plain(x, codes, scales, idx)
    name = "q8_gather_matmul"
    _lib.require_cuda(name, x, codes, scales, idx)
    N = x.shape[0]
    if x.dim() != 2 or idx.shape != (N,) or idx.dtype != torch.int32:
        raise ValueError(f"{name}: x must be [N, K] and idx [N] int32")
    out = torch.empty((N, codes.shape[-1]), dtype=torch.float32, device=x.device)
    return _expert_launch(name, q8_gather_matmul, x, codes, scales, idx, N, 1, x.shape[1], out)


q8_gather_matmul.launches = 0


def q8_dense_experts(x, codes, scales):
    """out[e] = bf16(x) @ dequant(W[e]) → [E, N, M] f32; x [N, K] shared by
    every expert, in-major codes [E, K, M], scales [E, K/32, M]."""
    if x.device.type == "cpu":
        return q8_dense_experts_plain(x, codes, scales)
    name = "q8_dense_experts"
    _lib.require_cuda(name, x, codes, scales)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [N, K]")
    E, _, M = codes.shape
    N = x.shape[0]
    out = torch.empty((E, N, M), dtype=torch.float32, device=x.device)
    return _expert_launch(name, q8_dense_experts, x, codes, scales, None, E, N, 0, out)


q8_dense_experts.launches = 0


def q8_dense_experts_perx(x, codes, scales):
    """out[e] = bf16(x[e]) @ dequant(W[e]) → [E, N, M] f32; x [E, N, K]."""
    if x.device.type == "cpu":
        return q8_dense_experts_perx_plain(x, codes, scales)
    name = "q8_dense_experts_perx"
    _lib.require_cuda(name, x, codes, scales)
    E, _, M = codes.shape
    if x.dim() != 3 or x.shape[0] != E:
        raise ValueError(f"{name}: x must be [E, N, K] with E = {E}")
    N, K = x.shape[1], x.shape[2]
    out = torch.empty((E, N, M), dtype=torch.float32, device=x.device)
    return _expert_launch(name, q8_dense_experts_perx, x, codes, scales, None, E, N, N * K, out)


q8_dense_experts_perx.launches = 0


def q8_moe_megafused(x, weights, gu_codes, gu_scales, dn_codes, dn_scales):
    """out[n] = Σ_e weights[e, n] · (silu(x@Wg[e]) · (x@Wu[e])) @ Wd[e] →
    [N, H] f32. x [N, H] (f32 or bf16, rounded to bf16), weights [E, N]
    f32 (0 where unrouted), gate+up codes [E, H, 2·MI] int8 and scales
    [E, H/32, 2·MI] f32 (gate columns first), down codes [E, MI, H] and
    scales [E, MI/32, H]; N ≤ 32."""
    if x.device.type == "cpu":
        return q8_moe_megafused_plain(x, weights, gu_codes, gu_scales, dn_codes, dn_scales)
    name = "q8_moe_megafused"
    _lib.require_cuda(name, x, weights, gu_codes, gu_scales, dn_codes, dn_scales)
    if x.dim() != 2 or gu_codes.dim() != 3:
        raise ValueError(f"{name}: x must be [N, H] and the stacks [E, K, M]")
    N, H = x.shape
    E, _, MI2 = gu_codes.shape
    MI = MI2 // 2
    _check_x(name, x, H)
    _check_packed(name, gu_codes, gu_scales, (E, H, MI2), (E, H // Q8_BLOCK, MI2))
    if MI2 % 2 or MI % Q8_BLOCK:
        raise ValueError(f"{name}: the intermediate size {MI} must be a multiple of 32")
    _check_packed(name, dn_codes, dn_scales, (E, MI, H), (E, MI // Q8_BLOCK, H))
    if weights.shape != (E, N) or weights.dtype != torch.float32:
        raise ValueError(f"{name}: weights must be [E, N] = [{E}, {N}] f32")
    if N > 32:
        raise ValueError(f"{name}: N = {N} rows; the kernel takes at most 32")
    out = torch.empty((N, H), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    partial = torch.empty((E, 2, N, H), dtype=torch.float32, device=x.device)
    err = _lib.lib().dsocr_q8_moe_megafused(
        x.data_ptr(), weights.data_ptr(), gu_codes.data_ptr(), gu_scales.data_ptr(),
        dn_codes.data_ptr(), dn_scales.data_ptr(), partial.data_ptr(), out.data_ptr(),
        N, H, MI, E, _lib.DTYPE_CODES[x.dtype], _lib.stream_ptr(x), None,
    )
    _lib.check(err, name)
    _lib.count_launch(q8_moe_megafused)
    return out


q8_moe_megafused.launches = 0


def q8_moe_megafused_occupancy(N: int, H: int, MI: int, E: int, x_dtype=torch.bfloat16):
    """(clusters the card holds at once, blocks an SM holds) of
    q8_moe_megafused's launch at these sizes, from the CUDA occupancy
    calculator; nothing runs."""
    occupancy = (ctypes.c_int * 2)()
    err = _lib.lib().dsocr_q8_moe_megafused(
        None, None, None, None, None, None, None, None, N, H, MI, E, _lib.DTYPE_CODES[x_dtype], None,
        ctypes.addressof(occupancy))
    _lib.check(err, "q8_moe_megafused_occupancy")
    return occupancy[0], occupancy[1]
