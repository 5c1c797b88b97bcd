"""The reference GLM-OCR engine's parameters → the port's state_dict.

``params_from_jax(tree)`` takes ``jax.device_get(engine.params)`` (or the
reference loader's tree) as NumPy arrays: ``vision`` flattens by its keys
(the block list by index, the downsample conv in its OIHW layout, a
linear without a bias has no ``.b``), the decoder's [L, ...] ``layers``
stacks split one entry per layer under the reference's names
(``decoder.layers.{i}.q_proj``, ``.q_bias``, ``.gate_up_proj``), which the
engine fuses (decoder.fuse_glm_params). The conversion is the
shared GQA decoder's (models/gqa_decoder.py).
"""

from ..gqa_decoder import params_from_jax

__all__ = ["params_from_jax"]
