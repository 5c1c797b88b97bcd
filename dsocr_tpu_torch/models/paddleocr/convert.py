"""The reference PaddleOCR-VL engine's parameters → the port's state_dict.

``params_from_jax(tree)`` takes ``jax.device_get(engine.params)`` (or the
reference loader's tree) as NumPy arrays: ``vision`` and ``projector``
flatten by their keys (the tower's layer list by index), the decoder's
[L, ...] ``layers`` stacks split one entry per layer
(``decoder.layers.{i}.qkv_proj``), fused or split as the tree is. A
packed Q8_0 weight ({codes, scales}) splits per layer the same way
(``...qkv_proj.codes``); a packed lm_head becomes ``decoder.lm_head.codes``.
K-quant plane dicts are turned into the port's layout as the DeepSeek
converter does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..deepseek.convert import _flatten, _from_planes, _tensors


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"vision", "projector", "decoder"} NumPy tree → state_dict."""
    flat: Dict[str, np.ndarray] = {}
    _flatten("vision", tree["vision"], flat)
    _flatten("projector", tree["projector"], flat)
    decoder = dict(tree["decoder"])
    for key, stack in decoder.pop("layers").items():
        stack = _from_planes(stack, in_major=False)
        for part, arr in (stack.items() if isinstance(stack, dict) else [("", stack)]):
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                flat[f"decoder.layers.{i}.{key}" + (f".{part}" if part else "")] = arr[i]
    if isinstance(decoder.get("lm_head"), dict):
        decoder["lm_head"] = _from_planes(decoder["lm_head"], in_major=False)
    _flatten("decoder", decoder, flat)
    return _tensors(flat)
