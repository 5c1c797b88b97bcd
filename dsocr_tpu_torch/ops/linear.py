"""Linear projection over float weights (dsocr_tpu/ops/linear.py,
bf16/f32 only). Weights keep the reference's [in, out] layout."""

from __future__ import annotations

from typing import Optional

import torch


def project(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [.., in] @ w [in, out] → [.., out] in x.dtype (f32 accumulation)."""
    out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = (out.float() + bias.float()).to(out.dtype)
    return out
