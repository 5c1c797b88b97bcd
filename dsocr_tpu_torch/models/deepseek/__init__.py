"""DeepSeek-OCR v1 in PyTorch: SAM + CLIP towers, projector, DeepSeek-V2
MoE decoder, and the continuous-batching engine surface."""

from .config import DeepseekOcrConfig, DeepseekV2Config, tiny_deepseek_config
from .convert import params_from_jax
from .engine import DeepseekOcrEngine, DeepseekOcrModel, VisionInput

__all__ = [
    "DeepseekOcrConfig",
    "DeepseekOcrEngine",
    "DeepseekOcrModel",
    "DeepseekV2Config",
    "VisionInput",
    "params_from_jax",
    "tiny_deepseek_config",
]
