"""Runtime Q8_0 / Q4_K / Q6_K quantization of the Qwen2 decoder
(dsocr_tpu/models/dots/quantize.py): the shared GQA decoder's
(models/gqa_quantize.py), whose keys are the reference's dots adapter's
scope. Dots' down_proj (in 8,960 = 35 super-blocks) packs in the
K-quants; the lm_head (in 1,536) too.
"""

from __future__ import annotations

from ..gqa_quantize import FUSED_FROM, PLAIN_KEYS, packed_kind
from ..gqa_quantize import quantize_gqa_params as quantize_qwen2_params

__all__ = ["FUSED_FROM", "PLAIN_KEYS", "packed_kind", "quantize_qwen2_params"]
