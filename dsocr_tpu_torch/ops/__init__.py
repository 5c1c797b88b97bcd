"""Shared PyTorch ops of the port: f32-stable norms, RoPE, attention
with the int8 KV cache, MoE routing and expert tiers, and the
hand-written CUDA kernels (``ops.kernels``).

Matmuls run in the working dtype with f32 accumulation; softmax, norms,
gating and logits run in f32 (the reference's rules, dsocr_tpu/ops).
"""

from .activations import ACT2FN, gelu, gelu_tanh, quick_gelu, silu
from .attention import (
    attention,
    attention_kv_int8,
    causal_mask,
    paged_kv_write_attend,
    quantize_kv_int8,
    repeat_kv,
    slot_kv_write_attend,
)
from .linear import project
from .moe import MoeConfig, moe_apply_fused, moe_router
from .norms import layer_norm, rms_norm
from .rope import apply_rope, build_rope_tables, mla_interleave_regroup, partial_rope, rotate_half

__all__ = [
    "ACT2FN",
    "MoeConfig",
    "apply_rope",
    "attention",
    "attention_kv_int8",
    "build_rope_tables",
    "causal_mask",
    "gelu",
    "gelu_tanh",
    "layer_norm",
    "mla_interleave_regroup",
    "moe_apply_fused",
    "moe_router",
    "paged_kv_write_attend",
    "partial_rope",
    "project",
    "quantize_kv_int8",
    "quick_gelu",
    "repeat_kv",
    "rms_norm",
    "rotate_half",
    "silu",
    "slot_kv_write_attend",
]
