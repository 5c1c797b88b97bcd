"""Runtime Q8_0 / Q4_K / Q6_K quantization of the Ernie decoder
(dsocr_tpu/models/paddleocr/quantize.py): the shared GQA decoder's
(models/gqa_quantize.py), under the reference's name.
"""

from __future__ import annotations

from ..gqa_quantize import FUSED_FROM, PLAIN_KEYS, packed_kind
from ..gqa_quantize import quantize_gqa_params as quantize_ernie_params

__all__ = ["FUSED_FROM", "PLAIN_KEYS", "packed_kind", "quantize_ernie_params"]
