"""The reference PaddleOCR-VL engine's parameters → the port's state_dict.

``params_from_jax(tree)`` takes ``jax.device_get(engine.params)`` (or the
reference loader's tree) as NumPy arrays: ``vision`` and ``projector``
flatten by their keys (the tower's layer list by index), the decoder's
[L, ...] ``layers`` stacks split one entry per layer
(``decoder.layers.{i}.qkv_proj``), fused or split as the tree is, and
packed weights take the port's layouts. The conversion is the shared GQA
decoder's (models/gqa_decoder.py).
"""

from ..gqa_decoder import params_from_jax

__all__ = ["params_from_jax"]
