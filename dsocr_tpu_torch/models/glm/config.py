"""GLM-OCR configuration: a jax-free copy of dsocr_tpu/models/glm/config.py
(the same fields and defaults, the chat scaffold's token ids, the HF
``config.json`` parsed by ``from_dict``/``from_json`` with its
``rope_parameters``, and ``preprocessor_config.json`` and
``generation_config.json`` beside it overriding the pixel budget, the
normalization and the EOS ids; ``tiny_glm_config``). The defaults are
the published model: the GLM ViT (24 layers, width 1536, 12 heads of 128,
SwiGLU 10944, two temporal frames, 2 × 2 merge to 1024) and the GLM
decoder (24 layers, width 1024, 16 query heads over 8 KV heads of 128,
rotary over half the head dim with M-RoPE sections 8/12/12, tied
embeddings of 59,392, three EOS ids).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping, Optional, Tuple

# hard-coded chat scaffold (ref model.rs:36-40)
TOKEN_GMASK = 59248
TOKEN_SOP = 59250
TOKEN_USER = 59253
TOKEN_ASSISTANT = 59254
TOKEN_NEWLINE = 10


@dataclasses.dataclass(frozen=True)
class GlmVisionConfig:
    hidden_size: int = 1536
    depth: int = 24
    num_heads: int = 12
    attention_bias: bool = False
    intermediate_size: int = 10944
    image_size: int = 336
    patch_size: int = 14
    out_hidden_size: int = 1024
    rms_norm_eps: float = 1e-5
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    in_channels: int = 3

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class GlmTextConfig:
    vocab_size: int = 59392
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.5
    mrope_section: Tuple[int, ...] = (8, 12, 12)
    max_position_embeddings: int = 32768
    attention_bias: bool = True
    hidden_act: str = "silu"
    tie_word_embeddings: bool = True
    eos_token_ids: Tuple[int, ...] = (59246, 59253, 59255)
    pad_token_id: int = 59246

    @property
    def rope_dim(self) -> int:
        return int(round(self.head_dim * self.partial_rotary_factor))

    @property
    def resolved_num_key_value_heads(self) -> int:
        return self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class GlmConfig:
    vision: GlmVisionConfig = dataclasses.field(default_factory=GlmVisionConfig)
    text: GlmTextConfig = dataclasses.field(default_factory=GlmTextConfig)
    image_token_id: int = 59257
    image_start_token_id: int = 59256
    image_end_token_id: int = 59258
    video_start_token_id: int = 59259
    video_end_token_id: int = 59260
    # preprocessor (preprocessor_config.json)
    min_pixels: int = 112 * 112
    max_pixels: int = 28 * 28 * 2 * 6144
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    @classmethod
    def from_dict(
        cls, data: Mapping[str, Any], preprocessor: Optional[Mapping[str, Any]] = None,
        generation: Optional[Mapping[str, Any]] = None,
    ) -> "GlmConfig":
        vraw = data.get("vision_config") or {}
        vfields = {f.name for f in dataclasses.fields(GlmVisionConfig)}
        vision = GlmVisionConfig(**{k: v for k, v in vraw.items() if k in vfields})

        traw = dict(data.get("text_config") or {})
        rope_params = traw.pop("rope_parameters", {}) or {}
        tfields = {f.name for f in dataclasses.fields(GlmTextConfig)} - {
            "mrope_section", "partial_rotary_factor", "rope_theta", "eos_token_ids",
        }
        tkwargs = {k: v for k, v in traw.items() if k in tfields and v is not None}
        if rope_params.get("mrope_section"):
            tkwargs["mrope_section"] = tuple(rope_params["mrope_section"])
        if rope_params.get("partial_rotary_factor") is not None:
            tkwargs["partial_rotary_factor"] = rope_params["partial_rotary_factor"]
        if rope_params.get("rope_theta") is not None:
            tkwargs["rope_theta"] = rope_params["rope_theta"]
        eos = traw.get("eos_token_id")
        if generation and generation.get("eos_token_id"):
            eos = generation["eos_token_id"]
        if eos is not None:
            tkwargs["eos_token_ids"] = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
        text = GlmTextConfig(**tkwargs)

        kwargs: dict = {}
        for key in (
            "image_token_id", "image_start_token_id", "image_end_token_id",
            "video_start_token_id", "video_end_token_id",
        ):
            if data.get(key) is not None:
                kwargs[key] = data[key]
        if preprocessor:
            size = preprocessor.get("size") or {}
            if size.get("shortest_edge"):
                kwargs["min_pixels"] = size["shortest_edge"]
            if size.get("longest_edge"):
                kwargs["max_pixels"] = size["longest_edge"]
            if preprocessor.get("image_mean"):
                kwargs["image_mean"] = tuple(preprocessor["image_mean"])
            if preprocessor.get("image_std"):
                kwargs["image_std"] = tuple(preprocessor["image_std"])
        return cls(vision=vision, text=text, **kwargs)

    @classmethod
    def from_json(cls, path: pathlib.Path) -> "GlmConfig":
        path = pathlib.Path(path)
        data = json.loads(path.read_text())
        prep = None
        gen = None
        prep_path = path.parent / "preprocessor_config.json"
        if prep_path.exists():
            prep = json.loads(prep_path.read_text())
        gen_path = path.parent / "generation_config.json"
        if gen_path.exists():
            gen = json.loads(gen_path.read_text())
        return cls.from_dict(data, prep, gen)


def tiny_glm_config() -> GlmConfig:
    return GlmConfig(
        vision=GlmVisionConfig(
            hidden_size=32,
            depth=2,
            num_heads=4,
            intermediate_size=64,
            out_hidden_size=48,
            patch_size=14,
            temporal_patch_size=2,
        ),
        text=GlmTextConfig(
            vocab_size=59392,
            hidden_size=48,
            intermediate_size=96,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            partial_rotary_factor=0.5,
            mrope_section=(2, 1, 1),
            eos_token_ids=(2,),
        ),
        min_pixels=1,
        max_pixels=28 * 56,
    )
