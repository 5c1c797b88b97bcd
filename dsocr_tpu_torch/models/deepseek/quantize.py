"""Runtime Q8_0 / Q4_K / Q6_K quantization of the DeepSeek decoder
(dsocr_tpu/models/deepseek/quantize.py).

Key selection is the reference's: attention q/k/v/o (fused qkv_proj),
shared experts, routed experts and the lm_head. The router, norms and
embeddings stay float, and so does the dense-prefix MLP
(gateup_proj/down_proj, intermediate 6848). A weight whose in dim misses
the 32-value block stays float too; under a K-quant (Q4_K, Q6_K) one
whose in dim misses the 256-value super-block packs as Q8_0
(dsq/serve_quant.py), so at full width the routed experts' down
projection (in dim 896) is Q8_0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...dsq.serve_quant import METHODS, Q8_BLOCK, effective_method, quantize_expert_stack, quantize_plain

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


def packed_kind(name: str, in_dim: int, method: str = "q8_0") -> Optional[Tuple[str, str]]:
    """(kind, method) for a decoder weight ("lm_head" or a layer's key)
    with this in dim under `method`: kind "plain" (row layout) or
    "experts" (in-major), method the one it packs with (Q8_0 where a
    K-quant misses its super-block); None where it stays float."""
    if in_dim % Q8_BLOCK:
        return None
    if name == "lm_head" or name in PLAIN_KEYS:
        return "plain", effective_method(method, in_dim)
    if name in EXPERT_KEYS:
        return "experts", effective_method(method, in_dim)
    return None


def quantize_decoder_params(state: Dict[str, torch.Tensor], method: str = "q8_0") -> Dict[str, torch.Tensor]:
    """A copy of a model state_dict whose eligible float decoder weights
    (``decoder.lm_head``, ``decoder.{group}.{i}.{key}``) are replaced by
    ``.codes``/``.scales`` entries (Q8_0, and a K-quant's Q8_0 fallbacks),
    ``.codes``/``.scales``/``.mins`` (Q4_K) or ``.codes``/``.highs``/
    ``.scales`` (Q6_K); packed entries pass through."""
    if method not in METHODS:
        raise NotImplementedError(f"runtime quantization `{method}` not supported")
    out = {}
    for key, value in state.items():
        name = key.rsplit(".", 1)[-1]
        found = None
        if key.startswith("decoder.") and value.is_floating_point() and value.dim() >= 2:
            found = packed_kind(name, value.shape[-2], method)
        if found is None:
            out[key] = value
            continue
        packed = (quantize_expert_stack if found[0] == "experts" else quantize_plain)(value, method)
        for part, t in packed.items():
            out[f"{key}.{part}"] = t
    return out
