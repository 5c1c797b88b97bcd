"""PaddleOCR-VL in PyTorch: smart-resize, the SigLIP tower, the mlp_AR
projector, the Ernie decoder with M-RoPE over grouped KV heads, and the
engine's single-request and continuous-batching surfaces."""

from .config import PaddleConfig, PaddleVisionConfig, tiny_paddle_config
from .convert import params_from_jax
from .engine import PaddleOcrEngine, PaddleOcrModel, ProjectedImage

__all__ = [
    "PaddleConfig",
    "PaddleOcrEngine",
    "PaddleOcrModel",
    "PaddleVisionConfig",
    "ProjectedImage",
    "params_from_jax",
    "tiny_paddle_config",
]
