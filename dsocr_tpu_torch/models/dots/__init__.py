"""DotsOCR in PyTorch: the DotsVision tower over packed frames, the Qwen2
decoder with grouped KV heads and q/k/v biases, and the engine's
single-request and continuous-batching surfaces."""

from .config import DotsConfig, DotsTextConfig, DotsVisionConfig, tiny_dots_config
from .convert import params_from_jax
from .engine import DotsOcrEngine, DotsOcrModel

__all__ = [
    "DotsConfig",
    "DotsOcrEngine",
    "DotsOcrModel",
    "DotsTextConfig",
    "DotsVisionConfig",
    "params_from_jax",
    "tiny_dots_config",
]
