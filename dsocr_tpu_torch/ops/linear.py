"""Linear projection over float or packed Q8_0 weights
(dsocr_tpu/ops/linear.py: the float and q8_0 branches of ``project``).

Float weights keep the reference's [in, out] layout. A packed weight is
a :class:`PackedQ8` holder whose ``codes``/``scales`` buffers keep the
reference's packed layouts (dsq/serve_quant.py), so state_dict names read
``...qkv_proj.codes`` and ``...qkv_proj.scales``. One holder per layer:
a torch tensor of one layer costs no copy, so the reference's
``LayeredQ8`` views have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..dsq.serve_quant import Q8_BLOCK, quantize_expert_stack, quantize_plain
from .kernels import q8_matmul


class PackedQ8(nn.Module):
    """A Q8_0-packed weight that stands for a float [.., in, out] matrix.

    Row layout (``in_major=False``, plain linears and the lm_head): codes
    [.., out, in] int8, scales [.., out, in/32] f32. In-major layout
    (``in_major=True``, expert stacks): codes [.., in, out], scales
    [.., in/32, out]."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, *, in_major: bool):
        super().__init__()
        self.in_major = in_major
        self.register_buffer("codes", codes)
        self.register_buffer("scales", scales)

    @classmethod
    def empty(cls, float_shape: Sequence[int], *, in_major: bool, device=None) -> "PackedQ8":
        *lead, i, o = float_shape
        if in_major:
            c_shape, s_shape = (*lead, i, o), (*lead, i // Q8_BLOCK, o)
        else:
            c_shape, s_shape = (*lead, o, i), (*lead, o, i // Q8_BLOCK)
        return cls(torch.zeros(c_shape, dtype=torch.int8, device=device),
                   torch.zeros(s_shape, dtype=torch.float32, device=device), in_major=in_major)

    @property
    def float_shape(self):
        *lead, a, b = self.codes.shape
        return (*lead, a, b) if self.in_major else (*lead, b, a)

    @torch.no_grad()
    def pack_(self, w: torch.Tensor) -> None:
        """Quantize the float weight `w` [.., in, out] into the buffers."""
        packed = (quantize_expert_stack if self.in_major else quantize_plain)(w)
        self.codes.copy_(packed["codes"])
        self.scales.copy_(packed["scales"])


def project(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [.., in] @ w → [.., out] in x.dtype (f32 accumulation); `w` is an
    [in, out] tensor or a row-layout PackedQ8 (the q8_matmul kernel)."""
    if isinstance(w, PackedQ8):
        lead = x.shape[:-1]
        out = q8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.codes, w.scales)
        out = out.reshape(*lead, out.shape[-1]).to(x.dtype)
    else:
        out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = (out.float() + bias.float()).to(out.dtype)
    return out
