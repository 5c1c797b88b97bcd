"""Runtime Q8_0 / Q4_K / Q6_K quantization of the shared GQA decoder
(gqa_decoder.py): PaddleOCR-VL's and DotsOCR's
(dsocr_tpu/models/paddleocr/quantize.py, dsocr_tpu/models/dots/quantize.py).

The keys are the reference's (its paddleocr-vl and dots adapters'
scope): attention q/k/v/o, the MLP's gate/up/down (fused or split) and an
untied lm_head. The towers, the projector, norms, biases and embeddings
stay float.
Packing is dsq/serve_quant.py's row layout; ``raw`` (loader.collect_raw_quant)
hands a snapshot's published payloads to it, a fused projection's only
where every part has one under one method.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..dsq.serve_quant import METHODS, Q8_BLOCK, effective_method, fused_raw, quantize_plain

PLAIN_KEYS = (
    "q_proj",
    "k_proj",
    "v_proj",
    "qkv_proj",
    "o_proj",
    "gate_proj",
    "up_proj",
    "gateup_proj",
    "down_proj",
)

FUSED_FROM = {
    "qkv_proj": ("q_proj", "k_proj", "v_proj"),
    "gateup_proj": ("gate_proj", "up_proj"),
}


def packed_kind(name: str, in_dim: int, method: str = "q8_0") -> Optional[str]:
    """The method a decoder weight ("lm_head" or a layer's key) of this in
    dim packs with, or None where it stays float."""
    if in_dim % Q8_BLOCK or (name != "lm_head" and name not in PLAIN_KEYS):
        return None
    return effective_method(method, in_dim)


def _raw_for(raw: Dict, key: str):
    """The payload entry of ``decoder.lm_head`` or
    ``decoder.layers.{i}.{name}`` for its one layer, or None."""
    parts = key.split(".")
    if parts[1:] == ["lm_head"]:
        return fused_raw(raw, "", "lm_head", FUSED_FROM)
    if len(parts) == 4:
        return fused_raw(raw, "layers", parts[3], FUSED_FROM, layers=[int(parts[2])])
    return None


def quantize_gqa_params(state: Dict[str, torch.Tensor], method: str = "q8_0",
                          raw: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """A copy of a model state_dict whose eligible float decoder weights
    are replaced by their packed parts (``.codes``/``.scales``, with
    ``.mins`` for Q4_K or ``.highs`` for Q6_K); packed entries pass
    through."""
    if method not in METHODS:
        raise NotImplementedError(f"runtime quantization `{method}` not supported")
    out = {}
    for key, value in state.items():
        name = key.rsplit(".", 1)[-1]
        found = None
        if key.startswith("decoder.") and value.is_floating_point() and value.dim() == 2:
            found = packed_kind(name, value.shape[-2], method)
        if found is None:
            out[key] = value
            continue
        for part, t in quantize_plain(value, method, raw=_raw_for(raw, key) if raw else None).items():
            out[f"{key}.{part}"] = t
    return out
