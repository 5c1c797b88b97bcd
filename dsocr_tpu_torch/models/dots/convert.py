"""The reference DotsOCR engine's parameters → the port's state_dict.

``params_from_jax(tree)`` takes ``jax.device_get(engine.params)`` (or the
reference loader's tree) as NumPy arrays: ``vision`` flattens by its keys
(the block list by index; a linear without a bias has no ``.b``), the
decoder's [L, ...] ``layers`` stacks split one entry per layer, fused or
split as the tree is (``decoder.layers.{i}.qkv_proj``, ``.qkv_bias``),
and packed weights (Q8_0 dicts, K-quant planes, a packed lm_head) take
the port's layouts. The conversion is the shared GQA
decoder's (models/gqa_decoder.py).
"""

from ..gqa_decoder import params_from_jax

__all__ = ["params_from_jax"]
