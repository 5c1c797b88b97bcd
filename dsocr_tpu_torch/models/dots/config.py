"""DotsOCR configuration: a jax-free copy of
dsocr_tpu/models/dots/config.py (the same fields and defaults, the HF
``config.json`` parsed by ``from_dict``/``from_json``, and
``tiny_dots_config``). The defaults are the published model: DotsVision
(42 layers, width 1536, 12 heads of 128, SwiGLU 4224, 2 × 2 merge) and the
Qwen2-1.5B decoder (28 layers, width 1536, 12 query heads over 2 KV heads
of 128, q/k/v biases, θ 1e6, an untied lm_head of 151,936).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class DotsVisionConfig:
    embed_dim: int = 1536
    hidden_size: int = 1536
    intermediate_size: int = 4224
    num_hidden_layers: int = 42
    num_attention_heads: int = 12
    num_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 1
    rms_norm_eps: float = 1e-5
    use_bias: bool = False
    post_norm: bool = True

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class DotsTextConfig:
    """Qwen2-1.5B decoder defaults."""

    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_position_embeddings: int = 131072
    attention_bias: bool = True  # Qwen2 q/k/v biases
    hidden_act: str = "silu"
    tie_word_embeddings: bool = False
    vocab_size: int = 151936

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def resolved_num_key_value_heads(self) -> int:
        return self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class DotsConfig:
    vision: DotsVisionConfig = dataclasses.field(default_factory=DotsVisionConfig)
    text: DotsTextConfig = dataclasses.field(default_factory=DotsTextConfig)
    image_token_id: int = 151665  # <|imgpad|>
    image_start_token_id: int = 151652  # <|img|>
    image_end_token_id: int = 151653  # <|endofimg|>
    eos_token_id: int = 151643  # <|endoftext|>

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "DotsConfig":
        vision_raw = data.get("vision_config") or {}
        vfields = {f.name for f in dataclasses.fields(DotsVisionConfig)}
        vision = DotsVisionConfig(
            **{k: v for k, v in vision_raw.items() if k in vfields}
        )
        tfields = {f.name for f in dataclasses.fields(DotsTextConfig)}
        text_raw = data.get("text_config") or data
        text = DotsTextConfig(
            **{k: v for k, v in text_raw.items() if k in tfields and v is not None}
        )
        kwargs = {}
        for key in ("image_token_id", "eos_token_id"):
            if data.get(key) is not None:
                kwargs[key] = data[key]
        return cls(vision=vision, text=text, **kwargs)

    @classmethod
    def from_json(cls, path: pathlib.Path) -> "DotsConfig":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))


def tiny_dots_config() -> DotsConfig:
    return DotsConfig(
        vision=DotsVisionConfig(
            embed_dim=32,
            hidden_size=48,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            patch_size=14,
        ),
        text=DotsTextConfig(
            hidden_size=48,
            intermediate_size=96,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            vocab_size=256,
            rope_theta=10000.0,
        ),
        image_token_id=250,
        image_start_token_id=251,
        image_end_token_id=252,
        eos_token_id=2,
    )
