"""DeepSeek-OCR configuration: a jax-free copy of the dataclasses of
dsocr_tpu/models/deepseek/config.py (same fields and defaults, and
``from_dict``/``from_json`` over a published ``config.json``, which tell
OCR1 from OCR2 as the reference does) and of ``tiny_deepseek_config``. The defaults are the full-width model: SAM
ViT-B, CLIP-L/14, and a 12-layer DeepSeek-V2 decoder (hidden 1280, 10
heads of 128, one dense layer, then 64 routed experts top-6 plus 2
shared experts)."""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SamParams:
    image_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    window_size: int = 14
    neck_channels: int = 256
    out_channels: Tuple[int, int] = (512, 1024)
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    mlp_ratio: float = 4.0
    use_rel_pos: bool = True
    use_abs_pos: bool = True
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def base_grid(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class ClipParams:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layernorm_epsilon: float = 1e-5

    @property
    def ffn_hidden_size(self) -> int:
        return self.hidden_size * 4

    @property
    def seq_length(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 129280
    hidden_size: int = 1280
    intermediate_size: int = 6848
    moe_intermediate_size: Optional[int] = 896
    num_hidden_layers: int = 12
    num_attention_heads: int = 10
    num_key_value_heads: Optional[int] = None
    n_shared_experts: Optional[int] = 2
    n_routed_experts: Optional[int] = 64
    routed_scaling_factor: float = 1.0
    qk_rope_head_dim: Optional[int] = None  # None → full-dim rope
    v_head_dim: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    topk_method: str = "greedy"
    num_experts_per_tok: Optional[int] = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: Optional[int] = 1
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    hidden_act: str = "silu"
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    bos_token_id: Optional[int] = 0
    eos_token_id: Optional[int] = 100001
    pad_token_id: Optional[int] = None
    tie_word_embeddings: bool = False
    rope_theta: float = 10000.0
    attention_bias: bool = False
    use_mla: bool = True  # rope even/odd interleave regroup only

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def resolved_kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def rope_dim(self) -> int:
        d = self.qk_rope_head_dim
        return self.head_dim if (d is None or d == 0) else d

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.n_routed_experts:
            return False
        first_k = self.first_k_dense_replace or 0
        return layer_idx >= first_k and layer_idx % max(self.moe_layer_freq, 1) == 0

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "DeepseekV2Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields and v is not None})


@dataclasses.dataclass(frozen=True)
class DeepseekOcrConfig:
    language: DeepseekV2Config = dataclasses.field(default_factory=DeepseekV2Config)
    sam: SamParams = dataclasses.field(default_factory=SamParams)
    clip: Optional[ClipParams] = dataclasses.field(default_factory=ClipParams)
    projector_n_embed: int = 1280
    projector_input_dim: int = 2048
    variant: str = "ocr1"  # "ocr1" (SAM + CLIP) | "ocr2"; the port's engine serves OCR1 only

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "DeepseekOcrConfig":
        """The published config.json: the language fields at the top level
        or under ``language_config`` (which wins), the towers under
        ``vision_config.width``; a DeepEncoderV2 vision config or a
        ``qwen2-0-5b`` width makes it OCR2 (no CLIP)."""
        lang_data = dict(data)
        if isinstance(data.get("language_config"), Mapping):
            lang_data.update(data["language_config"])
        language = DeepseekV2Config.from_dict(lang_data)

        vision = data.get("vision_config") or {}
        widths = vision.get("width") or {}
        variant = "ocr1"
        if (vision.get("model_name") or "").lower() == "deepencoderv2" or "qwen2-0-5b" in widths:
            variant = "ocr2"

        sam_raw = widths.get("sam_vit_b") or {}
        sam_kwargs = {dst: sam_raw[src] for src, dst in (
            ("image_size", "image_size"), ("patch_size", "patch_size"), ("width", "embed_dim"),
            ("layers", "depth"), ("heads", "num_heads")) if sam_raw.get(src) is not None}
        if vision.get("image_size") is not None:
            sam_kwargs["image_size"] = vision["image_size"]
        if sam_raw.get("downsample_channels"):
            sam_kwargs["out_channels"] = tuple(sam_raw["downsample_channels"])
        if sam_raw.get("global_attn_indexes"):
            sam_kwargs["global_attn_indexes"] = tuple(sam_raw["global_attn_indexes"])
        sam = SamParams(**sam_kwargs)

        clip = None
        clip_raw = widths.get("clip-l-14-224")
        if clip_raw:
            clip = ClipParams(
                hidden_size=clip_raw.get("width", 1024),
                num_layers=clip_raw.get("layers", 24),
                num_heads=clip_raw.get("heads", 16),
                image_size=clip_raw.get("image_size", 224),
                patch_size=clip_raw.get("patch_size", 14),
            )
        elif variant == "ocr1":
            clip = ClipParams()

        proj = data.get("projector_config") or {}
        if proj.get("projector_type", "linear") != "linear":
            raise ValueError(f"unsupported projector_type {proj.get('projector_type')}")
        return cls(
            language=language,
            sam=sam,
            clip=clip,
            projector_n_embed=proj.get("n_embed", language.hidden_size),
            projector_input_dim=proj.get("input_dim")
            or ((clip.hidden_size if clip else 0) + sam.out_channels[1]),
            variant=variant,
        )

    @classmethod
    def from_json(cls, path) -> "DeepseekOcrConfig":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))


def tiny_deepseek_config() -> DeepseekOcrConfig:
    """Miniature config for shape/integration tests."""
    return DeepseekOcrConfig(
        language=DeepseekV2Config(
            vocab_size=128,
            hidden_size=32,
            intermediate_size=64,
            moe_intermediate_size=16,
            num_hidden_layers=3,
            num_attention_heads=4,
            n_shared_experts=1,
            n_routed_experts=4,
            num_experts_per_tok=2,
            first_k_dense_replace=1,
            qk_rope_head_dim=4,
            eos_token_id=2,
            max_position_embeddings=512,
        ),
        sam=SamParams(
            image_size=64,
            patch_size=16,
            embed_dim=8,
            depth=2,
            num_heads=2,
            window_size=2,
            neck_channels=8,
            out_channels=(8, 16),
            global_attn_indexes=(1,),
        ),
        clip=ClipParams(
            hidden_size=16, num_layers=2, num_heads=2, image_size=28, patch_size=14
        ),
        projector_n_embed=32,
        projector_input_dim=32,  # clip 16 + sam 16
    )


def vision_compute_dtype(model_dtype):
    """The dtype SAM and CLIP load and compute in (the reference's
    ``vision_compute_dtype``): the model dtype, or f32 under
    ``DSOCR_VISION_F32``, read when an engine or a loader is built; the
    projector stays in the model dtype, and OCR2's encoder is f32 either
    way. Rank processes inherit the environment, so every rank of a mesh
    builds the same towers."""
    import os

    import torch

    return torch.float32 if os.environ.get("DSOCR_VISION_F32") else model_dtype
