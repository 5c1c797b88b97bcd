"""PaddleOCR-VL configuration: a jax-free copy of
dsocr_tpu/models/paddleocr/config.py (the same fields and defaults, the
HF ``config.json`` parsed by ``from_dict``/``from_json`` with the
``generation_config.json`` beside it filling bos/eos/pad ids the config
leaves unset, and ``tiny_paddle_config``). The defaults are the published
model: SigLIP (27 layers, width 1152, 16 heads of 72), a 2 × 2 merge
projector, and Ernie-4.5-0.3B (18 layers, width 1024, 16 query heads
over 2 KV heads of 128, M-RoPE sections 22/21/21).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PaddleVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 384
    patch_size: int = 14
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    spatial_merge_size: int = 2
    temporal_patch_size: int = 1
    tokens_per_second: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def base_grid(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class PaddleConfig:
    head_dim: int = 128
    hidden_size: int = 1024
    intermediate_size: int = 3072
    vocab_size: int = 103424
    num_attention_heads: int = 16
    num_hidden_layers: int = 18
    num_key_value_heads: Optional[int] = 2
    max_position_embeddings: int = 131072
    image_token_id: Optional[int] = 100295
    video_token_id: Optional[int] = None
    vision_start_token_id: Optional[int] = 101304
    pad_token_id: Optional[int] = 0
    bos_token_id: Optional[int] = 1
    eos_token_id: Optional[int] = 2
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    use_bias: bool = False
    use_cache: bool = True
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"
    mrope_section: Tuple[int, int, int] = (22, 21, 21)
    use_3d_rope: bool = True
    vision_config: PaddleVisionConfig = dataclasses.field(
        default_factory=PaddleVisionConfig
    )

    @property
    def resolved_num_key_value_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def attention_bias(self) -> bool:
        """Ernie's q/k/v projections have no biases (the shared decoder's
        switch)."""
        return False

    @property
    def doubled_sections(self) -> Tuple[int, int, int]:
        return tuple(s * 2 for s in self.mrope_section)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "PaddleConfig":
        vision = data.get("vision_config", {})
        vfields = {f.name for f in dataclasses.fields(PaddleVisionConfig)}
        vision_cfg = PaddleVisionConfig(
            **{k: v for k, v in vision.items() if k in vfields}
        )
        rope_scaling = data.get("rope_scaling") or {}
        section = rope_scaling.get("mrope_section")
        fields = {f.name for f in dataclasses.fields(cls)} - {
            "vision_config",
            "mrope_section",
        }
        kwargs = {k: v for k, v in data.items() if k in fields}
        if section:
            kwargs["mrope_section"] = tuple(section)
        return cls(vision_config=vision_cfg, **kwargs)

    @classmethod
    def from_json(cls, path: pathlib.Path) -> "PaddleConfig":
        data = json.loads(pathlib.Path(path).read_text())
        cfg = cls.from_dict(data)
        gen_path = pathlib.Path(path).parent / "generation_config.json"
        if gen_path.exists():
            gen = json.loads(gen_path.read_text())
            updates = {}
            for key in ("bos_token_id", "eos_token_id", "pad_token_id"):
                if getattr(cfg, key) is None and gen.get(key) is not None:
                    updates[key] = gen[key]
            if updates:
                cfg = dataclasses.replace(cfg, **updates)
        return cfg


def tiny_paddle_config() -> PaddleConfig:
    """Miniature config for shape and integration tests."""
    return PaddleConfig(
        head_dim=16,
        hidden_size=64,
        intermediate_size=128,
        vocab_size=256,
        num_attention_heads=4,
        num_hidden_layers=2,
        num_key_value_heads=2,
        image_token_id=250,
        vision_start_token_id=251,
        bos_token_id=1,
        eos_token_id=2,
        rope_theta=10000.0,
        mrope_section=(4, 2, 2),
        vision_config=PaddleVisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=2,
            image_size=28,
            patch_size=14,
        ),
    )
