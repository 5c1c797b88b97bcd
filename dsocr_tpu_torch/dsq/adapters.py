"""Model adapters: the quantizable linears of a model from its config
(dsocr_tpu/dsq/adapters.py, the reference's dsq-models crate).

``ModelAdapter`` {id, supports(config), discover(config, scope) →
[LinearSpec], recommend_dtype}; ``infer_adapter`` picks one from a
config.json's contents. Specs use the HF checkpoint names, so snapshots
interoperate with the reference's. DeepSeek's lists the decoder (and with
the projector scope its projector) for OCR1 and OCR2 alike, as the
reference's does: OCR2's Qwen2 encoder stays float. PaddleOCR-VL's and
DotsOCR's list their decoders (Dots' read from the config's top level, as
the published config.json keeps its Qwen2 fields there). GLM-OCR has no
adapter, as the reference has none.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import pathlib
from typing import Any, List, Mapping, Optional


class AdapterScope(enum.Enum):
    TEXT = "text"
    TEXT_AND_PROJECTOR = "text+projector"


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    name: str  # checkpoint name WITHOUT the trailing .weight
    out_dim: int
    in_dim: int


class ModelAdapter:
    id: str = ""

    def supports(self, config: Mapping[str, Any]) -> bool:
        raise NotImplementedError

    def discover(self, config: Mapping[str, Any], scope: AdapterScope) -> List[LinearSpec]:
        raise NotImplementedError

    def recommend_dtype(self) -> str:
        return "Q6_K"


class DeepseekOcrAdapter(ModelAdapter):
    id = "deepseek-ocr"

    def supports(self, config) -> bool:
        archs = config.get("architectures") or []
        return any("DeepseekOCR" in a or "deepseek" in a.lower() for a in archs) or (
            "vision_config" in config
            and "sam_vit_b" in (config.get("vision_config", {}).get("width") or {})
        )

    def discover(self, config, scope) -> List[LinearSpec]:
        from ..models.deepseek.config import DeepseekOcrConfig

        cfg = DeepseekOcrConfig.from_dict(config)
        lang = cfg.language
        H, D, NH = lang.hidden_size, lang.head_dim, lang.num_attention_heads
        NKV, DV = lang.resolved_kv_heads, lang.resolved_v_head_dim
        specs: List[LinearSpec] = []
        for i in range(lang.num_hidden_layers):
            base = f"model.layers.{i}"
            specs += [
                LinearSpec(f"{base}.self_attn.q_proj", NH * D, H),
                LinearSpec(f"{base}.self_attn.k_proj", NKV * D, H),
                LinearSpec(f"{base}.self_attn.v_proj", NKV * DV, H),
                LinearSpec(f"{base}.self_attn.o_proj", H, NH * DV),
            ]
            if lang.is_moe_layer(i):
                mi = lang.moe_intermediate_size or lang.intermediate_size
                for e in range(lang.n_routed_experts or 0):
                    eb = f"{base}.mlp.experts.{e}"
                    specs += [LinearSpec(f"{eb}.gate_proj", mi, H), LinearSpec(f"{eb}.up_proj", mi, H),
                              LinearSpec(f"{eb}.down_proj", H, mi)]
                if lang.n_shared_experts:
                    si = mi * lang.n_shared_experts
                    sb = f"{base}.mlp.shared_experts"
                    specs += [LinearSpec(f"{sb}.gate_proj", si, H), LinearSpec(f"{sb}.up_proj", si, H),
                              LinearSpec(f"{sb}.down_proj", H, si)]
            else:
                inter = lang.intermediate_size
                specs += [LinearSpec(f"{base}.mlp.gate_proj", inter, H),
                          LinearSpec(f"{base}.mlp.up_proj", inter, H),
                          LinearSpec(f"{base}.mlp.down_proj", H, inter)]
        specs.append(LinearSpec("lm_head", lang.vocab_size, H))
        if scope is AdapterScope.TEXT_AND_PROJECTOR:
            specs.append(LinearSpec("model.projector.layers", cfg.projector_n_embed, cfg.projector_input_dim))
        return specs


class PaddleOcrAdapter(ModelAdapter):
    id = "paddleocr-vl"

    def supports(self, config) -> bool:
        archs = config.get("architectures") or []
        return any("PaddleOCR" in a or "Ernie" in a for a in archs)

    def discover(self, config, scope) -> List[LinearSpec]:
        """Ernie's q/k/v/o and gate/up/down per layer, an untied lm_head,
        and with the projector scope mlp_AR's two linears."""
        from ..models.paddleocr.config import PaddleConfig

        cfg = PaddleConfig.from_dict(config)
        H, D, NH = cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads
        NKV, inter = cfg.resolved_num_key_value_heads, cfg.intermediate_size
        specs: List[LinearSpec] = []
        for i in range(cfg.num_hidden_layers):
            base = f"model.layers.{i}"
            specs += [
                LinearSpec(f"{base}.self_attn.q_proj", NH * D, H),
                LinearSpec(f"{base}.self_attn.k_proj", NKV * D, H),
                LinearSpec(f"{base}.self_attn.v_proj", NKV * D, H),
                LinearSpec(f"{base}.self_attn.o_proj", H, NH * D),
                LinearSpec(f"{base}.mlp.gate_proj", inter, H),
                LinearSpec(f"{base}.mlp.up_proj", inter, H),
                LinearSpec(f"{base}.mlp.down_proj", H, inter),
            ]
        if not cfg.tie_word_embeddings:
            specs.append(LinearSpec("lm_head", cfg.vocab_size, H))
        if scope is AdapterScope.TEXT_AND_PROJECTOR:
            merged = cfg.vision_config.hidden_size * cfg.vision_config.spatial_merge_size ** 2
            specs += [LinearSpec("mlp_AR.linear_1", merged, merged), LinearSpec("mlp_AR.linear_2", H, merged)]
        return specs


class DotsOcrAdapter(ModelAdapter):
    id = "dots-ocr"

    def supports(self, config) -> bool:
        archs = config.get("architectures") or []
        return any("Dots" in a for a in archs)

    def discover(self, config, scope) -> List[LinearSpec]:
        """Qwen2's q/k/v/o and gate/up/down per layer and an untied
        lm_head, with the published model's values where the config
        leaves a field out."""
        H = config.get("hidden_size", 1536)
        NH = config.get("num_attention_heads", 12)
        D = config.get("head_dim", H // NH)
        NKV = config.get("num_key_value_heads", NH)
        inter = config.get("intermediate_size", 8960)
        specs: List[LinearSpec] = []
        for i in range(config.get("num_hidden_layers", 28)):
            base = f"model.layers.{i}"
            specs += [
                LinearSpec(f"{base}.self_attn.q_proj", NH * D, H),
                LinearSpec(f"{base}.self_attn.k_proj", NKV * D, H),
                LinearSpec(f"{base}.self_attn.v_proj", NKV * D, H),
                LinearSpec(f"{base}.self_attn.o_proj", H, NH * D),
                LinearSpec(f"{base}.mlp.gate_proj", inter, H),
                LinearSpec(f"{base}.mlp.up_proj", inter, H),
                LinearSpec(f"{base}.mlp.down_proj", H, inter),
            ]
        if not config.get("tie_word_embeddings", False):
            specs.append(LinearSpec("lm_head", config.get("vocab_size", 151936), H))
        return specs


ADAPTERS: List[ModelAdapter] = [DeepseekOcrAdapter(), PaddleOcrAdapter(), DotsOcrAdapter()]


def infer_adapter(config: Mapping[str, Any]) -> Optional[ModelAdapter]:
    for adapter in ADAPTERS:
        if adapter.supports(config):
            return adapter
    return None


def infer_adapter_from_path(config_path) -> Optional[ModelAdapter]:
    return infer_adapter(json.loads(pathlib.Path(config_path).read_text()))
