"""GLM-OCR in PyTorch: the GLM ViT with q/k norms, the stride-merge
downsample and the gated merger, the GLM decoder with sandwich norms and
the partial interleaved M-RoPE over grouped KV heads, and the greedy-only
engine with its single-request and continuous-batching surfaces."""

from .config import GlmConfig, GlmTextConfig, GlmVisionConfig, tiny_glm_config
from .convert import params_from_jax
from .engine import GlmOcrEngine, GlmOcrModel

__all__ = [
    "GlmConfig",
    "GlmOcrEngine",
    "GlmOcrModel",
    "GlmTextConfig",
    "GlmVisionConfig",
    "params_from_jax",
    "tiny_glm_config",
]
