"""Linear projection over float or packed Q8_0 / Q4_K / Q6_K weights
(dsocr_tpu/ops/linear.py: the float, q8_0 and k-quant branches of ``project``).

Float weights keep the reference's [in, out] layout. A packed weight is a
holder whose buffers keep the packed layouts of dsq/serve_quant.py:
:class:`PackedQ8` (``codes``/``scales``), :class:`PackedQ4K`
(``codes``/``scales``/``mins``) or :class:`PackedQ6K`
(``codes``/``highs``/``scales``), so state_dict names read
``...qkv_proj.codes`` and ``...qkv_proj.highs``. Each holder runs its own
format's kernels (``matmul`` on the row layout; ``gather``, ``dense``,
``dense_perx`` and ``dequant`` on in-major expert stacks), so callers never
ask which format a weight has. One holder per layer: a torch tensor of
one layer costs no copy, so the reference's ``LayeredQ8`` and
``LayeredKQuant`` views have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..dsq.serve_quant import Q8_BLOCK, quantize_expert_stack, quantize_plain
from .kernels import (
    q4k_dense_experts,
    q4k_dense_experts_perx,
    q4k_gather_matmul,
    q4k_matmul,
    q6k_dense_experts,
    q6k_dense_experts_perx,
    q6k_gather_matmul,
    q6k_matmul,
    q8_dense_experts,
    q8_dense_experts_perx,
    q8_gather_matmul,
    q8_matmul,
)
from .kernels.kquant_matmul import Q4K_PARTS, Q6K_PARTS, dequant_q4k, dequant_q6k


class Packed(nn.Module):
    """A packed weight that stands for a float [.., in, out] matrix. Row
    layout (``in_major=False``, plain linears and the lm_head): each buffer
    [.., out, in/d]. In-major layout (``in_major=True``, expert stacks):
    [.., in/d, out]. Subclasses name the method, the buffers in argument
    order as ``PARTS`` (name, dtype, d: in values per element), and run
    their format's kernels:

    - ``matmul(x [N, in])`` → [N, out] f32 (row layout);
    - ``gather(x [N, in], idx [N] int32)`` → out[n] = x[n] @ W[idx[n]];
    - ``dense(x [N, in])`` → out[e] = x @ W[e], [E, N, out];
    - ``dense_perx(x [E, N, in])`` → out[e] = x[e] @ W[e];
    - ``dequant()`` → the bf16 weight [E, in, out] (in-major).
    """

    method = ""
    PARTS: tuple = ()

    def __init__(self, *buffers: torch.Tensor, in_major: bool):
        super().__init__()
        self.in_major = in_major
        for (name, _, _), t in zip(self.PARTS, buffers, strict=True):
            self.register_buffer(name, t)

    @classmethod
    def empty(cls, float_shape: Sequence[int], *, in_major: bool, device=None) -> "Packed":
        """Zeroed buffers for a float [.., in, out] weight."""
        *lead, i, o = float_shape
        shape = (lambda d: (*lead, i // d, o)) if in_major else (lambda d: (*lead, o, i // d))
        return cls(*(torch.zeros(shape(d), dtype=dtype, device=device) for _, dtype, d in cls.PARTS),
                   in_major=in_major)

    @property
    def float_shape(self):
        name, _, d = self.PARTS[0]
        *lead, a, b = getattr(self, name).shape
        return (*lead, a * d, b) if self.in_major else (*lead, b * d, a)

    @torch.no_grad()
    def pack_(self, w: torch.Tensor) -> None:
        """Quantize the float weight `w` [.., in, out] into the buffers."""
        packed = (quantize_expert_stack if self.in_major else quantize_plain)(w, self.method)
        for name, t in packed.items():
            getattr(self, name).copy_(t)


class PackedQ8(Packed):
    """Q8_0: codes int8 [.., out, in] (row) or [.., in, out] (in-major)."""

    method = "q8_0"
    PARTS = (("codes", torch.int8, 1), ("scales", torch.float32, Q8_BLOCK))

    def matmul(self, x):
        return q8_matmul(x, self.codes, self.scales)

    def gather(self, x, idx):
        return q8_gather_matmul(x, self.codes, self.scales, idx)

    def dense(self, x):
        return q8_dense_experts(x, self.codes, self.scales)

    def dense_perx(self, x):
        return q8_dense_experts_perx(x, self.codes, self.scales)

    def dequant(self) -> torch.Tensor:
        """bf16(f32(code) · scale), the prefill path's weights."""
        full = self.scales.repeat_interleave(Q8_BLOCK, dim=-2)
        return (self.codes.float() * full).to(torch.bfloat16)


class PackedQ4K(Packed):
    """Q4_K: two 4-bit codes per byte along in (the even in-index in the
    low nibble), codes uint8 [.., out, in/2] (row) or [.., in/2, out]
    (in-major); scales and mins f32 per 32 values; w = q·scale − min."""

    method = "q4_k"
    PARTS = Q4K_PARTS

    def matmul(self, x):
        return q4k_matmul(x, self.codes, self.scales, self.mins)

    def gather(self, x, idx):
        return q4k_gather_matmul(x, self.codes, self.scales, self.mins, idx)

    def dense(self, x):
        return q4k_dense_experts(x, self.codes, self.scales, self.mins)

    def dense_perx(self, x):
        return q4k_dense_experts_perx(x, self.codes, self.scales, self.mins)

    def dequant(self) -> torch.Tensor:
        """bf16(f32(q) · s − b), the prefill path's weights (the reference's
        dequant_q4k_planes)."""
        return dequant_q4k(self.codes, self.scales, self.mins, -2)


class PackedQ6K(Packed):
    """Q6_K: the low 4 bits of the 6-bit codes as Q4_K keeps its codes
    (codes uint8 [.., out, in/2] or [.., in/2, out]), the 2-bit high parts
    four per byte (highs [.., out, in/4] or [.., in/4, out]), scales f32
    per 16 values; w = (q − 32)·scale."""

    method = "q6_k"
    PARTS = Q6K_PARTS

    def matmul(self, x):
        return q6k_matmul(x, self.codes, self.highs, self.scales)

    def gather(self, x, idx):
        return q6k_gather_matmul(x, self.codes, self.highs, self.scales, idx)

    def dense(self, x):
        return q6k_dense_experts(x, self.codes, self.highs, self.scales)

    def dense_perx(self, x):
        return q6k_dense_experts_perx(x, self.codes, self.highs, self.scales)

    def dequant(self) -> torch.Tensor:
        """bf16(f32(q − 32) · s), the prefill path's weights (the
        reference's dequant_q6k_planes)."""
        return dequant_q6k(self.codes, self.highs, self.scales, -2)


HOLDERS = {"q8_0": PackedQ8, "q4_k": PackedQ4K, "q6_k": PackedQ6K}


def project(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [.., in] @ w → [.., out] in x.dtype (f32 accumulation); `w` is an
    [in, out] tensor or a row-layout packed holder (its kernel)."""
    if isinstance(w, Packed):
        lead = x.shape[:-1]
        out = w.matmul(x.reshape(-1, x.shape[-1]).contiguous())
        out = out.reshape(*lead, out.shape[-1]).to(x.dtype)
    else:
        out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = (out.float() + bias.float()).to(out.dtype)
    return out
