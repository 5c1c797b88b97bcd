"""Load the reference engine's parameters into the port's modules.

``params_from_jax(tree)`` takes the JAX engine's parameter tree as NumPy
arrays — ``jax.device_get(engine.params)`` — and returns a state_dict for
``engine.DeepseekOcrModel``, so both packages compute the same function.
The reference's layouts are kept: [in, out] linears, OIHW convs, each
[L, ...] decoder stack split into one entry per layer, and the decoder's
weight layout: an engine's tree is fused, a tree of the reference's
``init_deepseek_params`` or loader is split (``q_proj``, ``experts_gate``,
...), and so is one packed by its ``quantize_decoder_params`` without
fusion. The port's engine fuses a split state at init, as the
reference's does (decoder.fuse_decoder_params);
``decoder_state_from_jax`` converts a decoder tree alone for
``DeepseekDecoder.from_state``, which keeps either layout. A Q8_0 engine's
tree (``quantize="q8_0"``) holds packed ``{codes, scales}`` dicts: each
is split per layer the same way (``...qkv_proj.codes``), int8 codes stay
int8 and scales f32, and a packed lm_head becomes
``decoder.lm_head.codes``/``.scales``. A Q4_K engine's tree holds the
reference's plane dicts (``packed``, ``s_lo``, ``s_hi``, ``b_lo``,
``b_hi``: the low nibble is K-index j, the high one j + K/2, along the
last axis in row layout and the second-to-last in expert stacks); each is
turned into the port's ``codes``/``scales``/``mins`` (adjacent K values
per byte, dsq/serve_quant.py) before it is split per layer. A Q6_K
engine's tree holds quarter-plane dicts (``ql_a``, ``ql_b``, ``qh``,
``s0``..``s3``: K split into quarters Q0..Q3 along the same axis, ``ql_a``
holding Q0 in the low nibble and Q2 in the high one, ``ql_b`` Q1 and Q3,
``qh`` the 2-bit high parts of Q0..Q3 at bits 0, 2, 4 and 6, ``s_i``
quarter i's scales); each becomes the port's ``codes``/``highs``/
``scales`` the same way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...dsq.serve_quant import pack_bits
from .quantize import EXPERT_KEYS

_STACKED = ("dense_layers", "moe_layers")


def _flatten(prefix: str, node: Any, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for key, value in node.items():
            _flatten(f"{prefix}.{key}" if prefix else key, value, out)
    elif isinstance(node, (list, tuple)):
        for i, value in enumerate(node):
            _flatten(f"{prefix}.{i}", value, out)
    elif node is not None:
        out[prefix] = np.asarray(node)


def _q4k_from_planes(planes: Dict[str, Any], in_major: bool) -> Dict[str, np.ndarray]:
    """The reference's Q4_K plane dict → {codes, scales, mins} in the
    port's layout; `in_major` for expert stacks ([.., K/2, M])."""
    axis = -2 if in_major else -1
    packed = np.asarray(planes["packed"])
    codes = np.concatenate([packed & 0xF, packed >> 4], axis=axis)  # K-index order
    return {
        "codes": pack_bits(torch.from_numpy(codes), axis, 4).numpy(),
        "scales": np.concatenate([np.asarray(planes["s_lo"]), np.asarray(planes["s_hi"])], axis=axis),
        "mins": np.concatenate([np.asarray(planes["b_lo"]), np.asarray(planes["b_hi"])], axis=axis),
    }


def _q6k_from_planes(planes: Dict[str, Any], in_major: bool) -> Dict[str, np.ndarray]:
    """The reference's Q6_K quarter-plane dict → {codes, highs, scales} in
    the port's layout; `in_major` for expert stacks ([.., K/4, M])."""
    axis = -2 if in_major else -1
    a, b, h = (np.asarray(planes[key]) for key in ("ql_a", "ql_b", "qh"))
    quarters = [a & 0xF, b & 0xF, a >> 4, b >> 4]
    codes = np.concatenate([q | (((h >> (2 * i)) & 3) << 4) for i, q in enumerate(quarters)],
                           axis=axis)  # K-index order, 0..63
    codes = torch.from_numpy(codes)
    return {
        "codes": pack_bits(codes & 0xF, axis, 4).numpy(),
        "highs": pack_bits(codes >> 4, axis, 2).numpy(),
        "scales": np.concatenate([np.asarray(planes[f"s{i}"]) for i in range(4)], axis=axis),
    }


def _from_planes(node: Any, in_major: bool) -> Any:
    """A reference K-quant plane dict in the port's layout; anything else
    as it is."""
    if isinstance(node, dict) and "packed" in node:
        return _q4k_from_planes(node, in_major)
    if isinstance(node, dict) and "ql_a" in node:
        return _q6k_from_planes(node, in_major)
    return node


def _decoder_arrays(decoder: Dict[str, Any], prefix: str, flat: Dict[str, np.ndarray]) -> None:
    decoder = dict(decoder)
    if "lm_head" in decoder:
        decoder["lm_head"] = _from_planes(decoder["lm_head"], in_major=False)
    for group in _STACKED:
        for key, stack in (decoder.pop(group, None) or {}).items():
            stack = _from_planes(stack, in_major=key in EXPERT_KEYS)
            parts = stack.items() if isinstance(stack, dict) else [("", stack)]
            for part, arr in parts:
                arr = np.asarray(arr)
                suffix = f".{part}" if part else ""
                for i in range(arr.shape[0]):
                    flat[f"{prefix}{group}.{i}.{key}{suffix}"] = arr[i]
    _flatten(prefix.rstrip("."), decoder, flat)


def _tensors(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {
        key: torch.from_numpy(np.ascontiguousarray(value.astype(np.float32)))
        if value.dtype.kind == "f" or value.dtype.name == "bfloat16"
        else torch.from_numpy(np.array(value))  # a writable copy (int8 codes)
        for key, value in flat.items()
    }


def decoder_state_from_jax(decoder: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference decoder tree (NumPy, fused or split, float or packed) →
    a DeepseekDecoder state_dict in the same layout."""
    flat: Dict[str, np.ndarray] = {}
    _decoder_arrays(decoder, "", flat)
    return _tensors(flat)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"sam", "clip", "projector", "decoder"} NumPy tree → state_dict."""
    flat: Dict[str, np.ndarray] = {}
    for part in ("sam", "clip", "projector"):
        _flatten(part, tree[part], flat)
    _decoder_arrays(tree["decoder"], "decoder.", flat)
    return _tensors(flat)
