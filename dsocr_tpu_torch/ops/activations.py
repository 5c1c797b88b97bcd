"""Activation functions used across the model families
(dsocr_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick-gelu: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN = {
    "silu": silu,
    "gelu": gelu,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
}
