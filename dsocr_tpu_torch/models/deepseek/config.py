"""DeepSeek-OCR configuration: a jax-free copy of the dataclasses of
dsocr_tpu/models/deepseek/config.py (same fields and defaults) and of
``tiny_deepseek_config``. The defaults are the full-width model: SAM
ViT-B, CLIP-L/14, and a 12-layer DeepSeek-V2 decoder (hidden 1280, 10
heads of 128, one dense layer, then 64 routed experts top-6 plus 2
shared experts)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


@dataclasses.dataclass(frozen=True)
class DeepseekOcrConfig:
    language: DeepseekV2Config = dataclasses.field(default_factory=DeepseekV2Config)
    sam: SamParams = dataclasses.field(default_factory=SamParams)
    clip: Optional[ClipParams] = dataclasses.field(default_factory=ClipParams)
    projector_n_embed: int = 1280
    projector_input_dim: int = 2048
    variant: str = "ocr1"  # the port serves OCR1 (SAM + CLIP) only


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
