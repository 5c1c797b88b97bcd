"""Fused dequantize-matmul over packed Q4_K weights.

Four wrappers over two CUDA kernels (csrc/kquant_matmul.cu) serve the six
Q4_K Pallas functions of dsocr_tpu/ops/pallas/kquant_matmul.py that the
packed serving path reaches (a torch view of ``W[layer]`` costs no copy,
so one kernel serves a function and its ``_layered`` twin):

- ``q4k_matmul`` ← q4k_matmul (:210) and q4k_matmul_layered (:334). Row
  layout: the plain projections (qkv 1280→3840, o 1280→1280, shared
  gate+up 1280→3584, shared down 1792→1280) at N = 16 rows per decode
  step and up to 16 × 1024 rows per prefill wave, and the lm_head
  (1280→129280).
- ``q4k_gather_matmul`` ← q4k_gather_matmul (:568) and
  q4k_gather_matmul_layered (:609): ``out[n] = x[n] @ W[idx[n]]``,
  in-major; the routed experts' gate+up while N·top_k ≤ E.
- ``q4k_dense_experts`` ← q4k_dense_experts_layered (:821):
  ``out[e] = x @ W[e]`` → [E, N, M]; expert gate+up once N·top_k > E.
- ``q4k_dense_experts_perx`` ← q4k_dense_experts_perx_layered (:885):
  ``out[e] = x[e] @ W[e]``. DeepSeek's full-width down projection (in
  dim 896) is Q8_0 and never reaches it; an expert intermediate that is
  a multiple of 256 does.

Layout (dsq/serve_quant.py packs it; not the reference's plane split):
two 4-bit codes per byte, adjacent K values, the even k in the low
nibble; per 32 K values an f32 scale s = d·sc and an f32 min b = dmin·m.
Row layout codes [M, K/2] uint8, scales and mins [M, K/32]; in-major
codes [E, K/2, M], scales and mins [E, K/32, M]. 0.75 bytes per weight,
as the reference's. K is a multiple of 256 (a Q4_K super-block).

Numerics are the reference's: the weight is bf16(f32(q) · s − b), rounded
once per element (q · s is exact in f32); the activation is bf16(x)
whatever the model dtype; products accumulate in f32. A bf16 × bf16
product is exact in f32, so the kernels' sums differ from the twins only
in order.

What bounds them on the H100, and what the design does about it:
- decode (N ≤ 16) is device-memory bytes: expert gate+up of one layer is
  110 MB of codes, scales and mins, ≥ 0.033 ms at 3.35 TB/s; the lm_head
  124 MB, ≥ 0.037 ms. The expert kernel grids over (M tile of 128, group),
  keeps the group's x rows as bf16 in shared memory, dequantizes one
  32-value sub-block of the W tile into shared memory per step (a scale
  and a min per column) and prefetches the next sub-block's codes,
  scales and mins into registers while the tensor cores (WMMA bf16, f32
  accumulate) run the current one; codes come in as one 4-byte vector
  per thread and byte row, 128 contiguous bytes per warp.
- prefill (N = 16384) is tensor-core work: qkv is 161 GFLOP, ≥ 0.16 ms
  at 989 TFLOP/s. ``q4k_matmul`` tiles 64 × 64 outputs per block (16 × 64
  for N ≤ 16) and stages bf16(x) and the dequantized W tile in shared
  memory 64 K values at a time: each thread loads one whole sub-block of
  codes as a 16-byte vector, and the next step's while WMMA runs.
Neither uses wgmma or TMA yet (ROADMAP Queue 4).
"""

from __future__ import annotations

import torch

from ...dsq.quant import Q4K_SUB, QK_K
from ...dsq.serve_quant import unpack_nibbles
from . import _lib


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def dequant_q4k(codes: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Packed codes with K/2 bytes along `dim` (-1 row layout, -2
    in-major) → bf16(f32(q) · s − b) with K values along `dim`. The scales
    and mins broadcast over their 32 values instead of being repeated, and
    the product and difference run in place: one f32 weight is the peak."""
    dim %= codes.dim()
    w = unpack_nibbles(codes, dim).unflatten(dim, (-1, Q4K_SUB)).float()
    w.mul_(scales.unsqueeze(dim + 1)).sub_(mins.unsqueeze(dim + 1))
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


def _check_x(name, x, K):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if x.shape[-1] != K or K % QK_K:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match K = {K} (a multiple of {QK_K})")


def _check_packed(name, codes, scales, mins, c_shape, s_shape):
    if codes.dtype != torch.uint8 or scales.dtype != torch.float32 or mins.dtype != torch.float32:
        raise ValueError(f"{name}: codes must be uint8, scales and mins f32")
    shapes = tuple(codes.shape), tuple(scales.shape), tuple(mins.shape)
    if shapes != (c_shape, s_shape, s_shape):
        raise ValueError(f"{name}: codes / scales / mins {shapes}, expected "
                         f"{c_shape} / {s_shape} / {s_shape}")
    if codes.data_ptr() % 16 or scales.data_ptr() % 16 or mins.data_ptr() % 16:
        raise ValueError(f"{name}: codes, scales and mins must be 16-byte aligned")


def q4k_matmul(x, codes, scales, mins):
    """x [N, K] (f32 or bf16) @ dequant(W)ᵀ → [N, M] f32, with W in row
    layout: codes [M, K/2] uint8, scales and mins [M, K/32] f32. CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return q4k_matmul_plain(x, codes, scales, mins)
    name = "q4k_matmul"
    _lib.require_cuda(name, x, codes, scales, mins)
    N, K = x.shape
    M = codes.shape[0]
    _check_x(name, x, K)
    _check_packed(name, codes, scales, mins, (M, K // 2), (M, K // Q4K_SUB))
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    if N == 0 or M == 0:
        return out
    err = _lib.lib().dsocr_q4k_matmul(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), mins.data_ptr(), out.data_ptr(),
        N, K, M, _lib.DTYPE_CODES[x.dtype], _lib.stream_ptr(x),
    )
    _lib.check(err, name)
    _lib.count_launch(q4k_matmul)
    return out


q4k_matmul.launches = 0


def _expert_launch(name, wrapper, x, codes, scales, mins, idx, groups, rows, x_group_stride, out):
    """One launch of the in-major expert kernel: group g multiplies
    `rows` rows of x (from x + g * x_group_stride) by expert idx[g] (or
    expert g when idx is None) into out[g]."""
    E, K2, M = codes.shape
    K = 2 * K2
    _check_x(name, x, K)
    _check_packed(name, codes, scales, mins, (E, K2, M), (E, K // Q4K_SUB, M))
    if M % 4:
        raise ValueError(f"{name}: M = {M} must be a multiple of 4")
    if groups == 0 or rows == 0 or M == 0:
        return out
    err = _lib.lib().dsocr_q4k_expert_matmul(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), mins.data_ptr(), _lib.ptr(idx),
        out.data_ptr(), groups, rows, K, M, E, x_group_stride, _lib.DTYPE_CODES[x.dtype],
        _lib.stream_ptr(x),
    )
    _lib.check(err, name)
    _lib.count_launch(wrapper)
    return out


def q4k_gather_matmul(x, codes, scales, mins, idx):
    """out[n] = bf16(x[n]) @ dequant(W[idx[n]]) → [N, M] f32; x [N, K],
    in-major codes [E, K/2, M] uint8, scales and mins [E, K/32, M] f32,
    idx [N] int32 (an index outside [0, E) gives a zero row on the card)."""
    if x.device.type == "cpu":
        return q4k_gather_matmul_plain(x, codes, scales, mins, idx)
    name = "q4k_gather_matmul"
    _lib.require_cuda(name, x, codes, scales, mins, idx)
    N = x.shape[0]
    if x.dim() != 2 or idx.shape != (N,) or idx.dtype != torch.int32:
        raise ValueError(f"{name}: x must be [N, K] and idx [N] int32")
    out = torch.empty((N, codes.shape[-1]), dtype=torch.float32, device=x.device)
    return _expert_launch(name, q4k_gather_matmul, x, codes, scales, mins, idx, N, 1,
                          x.shape[1], out)


q4k_gather_matmul.launches = 0


def q4k_dense_experts(x, codes, scales, mins):
    """out[e] = bf16(x) @ dequant(W[e]) → [E, N, M] f32; x [N, K] shared by
    every expert, in-major codes [E, K/2, M], scales and mins [E, K/32, M]."""
    if x.device.type == "cpu":
        return q4k_dense_experts_plain(x, codes, scales, mins)
    name = "q4k_dense_experts"
    _lib.require_cuda(name, x, codes, scales, mins)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [N, K]")
    E, _, M = codes.shape
    N = x.shape[0]
    out = torch.empty((E, N, M), dtype=torch.float32, device=x.device)
    return _expert_launch(name, q4k_dense_experts, x, codes, scales, mins, None, E, N, 0, out)


q4k_dense_experts.launches = 0


def q4k_dense_experts_perx(x, codes, scales, mins):
    """out[e] = bf16(x[e]) @ dequant(W[e]) → [E, N, M] f32; x [E, N, K]."""
    if x.device.type == "cpu":
        return q4k_dense_experts_perx_plain(x, codes, scales, mins)
    name = "q4k_dense_experts_perx"
    _lib.require_cuda(name, x, codes, scales, mins)
    E, _, M = codes.shape
    if x.dim() != 3 or x.shape[0] != E:
        raise ValueError(f"{name}: x must be [E, N, K] with E = {E}")
    N, K = x.shape[1], x.shape[2]
    out = torch.empty((E, N, M), dtype=torch.float32, device=x.device)
    return _expert_launch(name, q4k_dense_experts_perx, x, codes, scales, mins, None, E, N,
                          N * K, out)


q4k_dense_experts_perx.launches = 0
