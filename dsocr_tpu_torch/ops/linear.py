"""Linear projection over float or packed Q8_0 / Q4_K weights
(dsocr_tpu/ops/linear.py: the float, q8_0 and q4_k branches of ``project``).

Float weights keep the reference's [in, out] layout. A packed weight is a
holder whose buffers keep the packed layouts of dsq/serve_quant.py:
:class:`PackedQ8` (``codes``/``scales``) or :class:`PackedQ4K`
(``codes``/``scales``/``mins``), so state_dict names read
``...qkv_proj.codes`` and ``...qkv_proj.mins``. Each holder runs its own
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

from ..dsq.quant import Q4K_SUB
from ..dsq.serve_quant import Q8_BLOCK, quantize_expert_stack, quantize_plain
from .kernels import (
    q4k_dense_experts,
    q4k_dense_experts_perx,
    q4k_gather_matmul,
    q4k_matmul,
    q8_dense_experts,
    q8_dense_experts_perx,
    q8_gather_matmul,
    q8_matmul,
)
from .kernels.kquant_matmul import dequant_q4k


class Packed(nn.Module):
    """A packed weight that stands for a float [.., in, out] matrix. Row
    layout (``in_major=False``, plain linears and the lm_head): scales
    [.., out, in/32]. In-major layout (``in_major=True``, expert stacks):
    scales [.., in/32, out]. Subclasses name the method and the buffers,
    and run their format's kernels:

    - ``matmul(x [N, in])`` → [N, out] f32 (row layout);
    - ``gather(x [N, in], idx [N] int32)`` → out[n] = x[n] @ W[idx[n]];
    - ``dense(x [N, in])`` → out[e] = x @ W[e], [E, N, out];
    - ``dense_perx(x [E, N, in])`` → out[e] = x[e] @ W[e];
    - ``dequant()`` → the bf16 weight [E, in, out] (in-major).
    """

    method = ""

    def __init__(self, *, in_major: bool, **buffers: torch.Tensor):
        super().__init__()
        self.in_major = in_major
        for name, t in buffers.items():
            self.register_buffer(name, t)

    @property
    def float_shape(self):
        *lead, a, b = self.scales.shape  # 32 values per scale in both formats
        return (*lead, a * 32, b) if self.in_major else (*lead, b * 32, a)

    @torch.no_grad()
    def pack_(self, w: torch.Tensor) -> None:
        """Quantize the float weight `w` [.., in, out] into the buffers."""
        packed = (quantize_expert_stack if self.in_major else quantize_plain)(w, self.method)
        for name, t in packed.items():
            getattr(self, name).copy_(t)


class PackedQ8(Packed):
    """Q8_0: codes int8 [.., out, in] (row) or [.., in, out] (in-major)."""

    method = "q8_0"

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, *, in_major: bool):
        super().__init__(in_major=in_major, codes=codes, scales=scales)

    @classmethod
    def empty(cls, float_shape: Sequence[int], *, in_major: bool, device=None) -> "PackedQ8":
        *lead, i, o = float_shape
        if in_major:
            c_shape, s_shape = (*lead, i, o), (*lead, i // Q8_BLOCK, o)
        else:
            c_shape, s_shape = (*lead, o, i), (*lead, o, i // Q8_BLOCK)
        return cls(torch.zeros(c_shape, dtype=torch.int8, device=device),
                   torch.zeros(s_shape, dtype=torch.float32, device=device), in_major=in_major)

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

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor, *,
                 in_major: bool):
        super().__init__(in_major=in_major, codes=codes, scales=scales, mins=mins)

    @classmethod
    def empty(cls, float_shape: Sequence[int], *, in_major: bool, device=None) -> "PackedQ4K":
        *lead, i, o = float_shape
        if in_major:
            c_shape, s_shape = (*lead, i // 2, o), (*lead, i // Q4K_SUB, o)
        else:
            c_shape, s_shape = (*lead, o, i // 2), (*lead, o, i // Q4K_SUB)
        return cls(torch.zeros(c_shape, dtype=torch.uint8, device=device),
                   torch.zeros(s_shape, dtype=torch.float32, device=device),
                   torch.zeros(s_shape, dtype=torch.float32, device=device), in_major=in_major)

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


HOLDERS = {"q8_0": PackedQ8, "q4_k": PackedQ4K}


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
