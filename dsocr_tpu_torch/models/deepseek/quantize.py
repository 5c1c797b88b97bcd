"""Runtime Q8_0 quantization of the DeepSeek decoder
(dsocr_tpu/models/deepseek/quantize.py).

Key selection is the reference's: attention q/k/v/o (fused qkv_proj),
shared experts, routed experts and the lm_head. The router, norms and
embeddings stay float, and so does the dense-prefix MLP
(gateup_proj/down_proj, intermediate 6848). A weight whose in dim misses
the 32-value block stays float too (dsq/serve_quant.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...dsq.serve_quant import METHODS, Q8_BLOCK, quantize_expert_stack, quantize_plain

PLAIN_KEYS = (
    "q_proj",
    "k_proj",
    "v_proj",
    "qkv_proj",
    "o_proj",
    "shared_gate",
    "shared_up",
    "shared_gateup",
    "shared_down",
)
EXPERT_KEYS = ("experts_gate", "experts_up", "experts_gateup", "experts_down")


def packed_kind(name: str, in_dim: int) -> Optional[str]:
    """"plain" (row layout), "experts" (in-major) or None (stays float)
    for a decoder weight ("lm_head" or a layer's key) with this in dim."""
    if in_dim % Q8_BLOCK:
        return None
    if name == "lm_head" or name in PLAIN_KEYS:
        return "plain"
    if name in EXPERT_KEYS:
        return "experts"
    return None


def quantize_decoder_params(state: Dict[str, torch.Tensor], method: str = "q8_0") -> Dict[str, torch.Tensor]:
    """A copy of a model state_dict whose eligible float decoder weights
    (``decoder.lm_head``, ``decoder.{group}.{i}.{key}``) are replaced by
    ``.codes``/``.scales`` entries; packed entries pass through."""
    if method not in METHODS:
        raise NotImplementedError(f"runtime quantization `{method}` not supported")
    out = {}
    for key, value in state.items():
        name = key.rsplit(".", 1)[-1]
        kind = None
        if key.startswith("decoder.") and value.is_floating_point() and value.dim() >= 2:
            kind = packed_kind(name, value.shape[-2])
        if kind is None:
            out[key] = value
            continue
        packed = (quantize_expert_stack if kind == "experts" else quantize_plain)(value, method)
        out[f"{key}.codes"] = packed["codes"]
        out[f"{key}.scales"] = packed["scales"]
    return out
