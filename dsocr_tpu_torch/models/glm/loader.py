"""GLM-OCR checkpoint → the port's state_dict
(dsocr_tpu/models/glm/loader.py).

The name map is the reference loader's: the tower under ``model.visual.*``
(``patch_embed.proj`` — the [H, C, T, p, p] conv as a flattened [C·T·p·p,
H] linear —, the blocks' ``attn.{qkv,proj,q_norm,k_norm}`` and
``mlp.{gate,up,down}_proj``, ``post_layernorm``, ``downsample``,
``merger.{proj,post_projection_norm,gate_proj,up_proj,down_proj}``), the
decoder under ``model.language_model.*`` with the sandwich norms, the
q/k/v biases and the fused ``mlp.gate_up_proj``, ``lm_head`` at the root
(read only when the embeddings are not tied), written as a table of
``deepseek.loader.Entry`` rows. The state_dict has the names
``convert.params_from_jax`` gives the reference loader's tree, which the
engine fuses. The tower always loads in f32 (the reference's ``vision_dtype``
default), the decoder in the model dtype, each tensor cast on ``device``
(the card unless the caller names the CPU). The reference's loader takes
a snapshot path, and so does this one: a ``.dsq`` snapshot overrides the
linears it holds (dequantized; GLM serves float only).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ...core.device import select_device
from ...dsq.runtime import WeightSource
from ..deepseek.loader import Entry, _lin, _ln, _load
from ..dots.loader import _weight
from .config import GlmConfig

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_NORMS = ("input_layernorm", "post_attention_layernorm", "post_self_attn_layernorm", "post_mlp_layernorm")


def vision_entries(cfg: GlmConfig) -> List[Entry]:
    v, root = cfg.vision, "model.visual"
    entries = [
        Entry("vision.patch_embed.w", f"{root}.patch_embed.proj.weight"),
        Entry("vision.patch_embed.b", f"{root}.patch_embed.proj.bias", zeros=v.hidden_size),
        Entry("vision.post_layernorm", f"{root}.post_layernorm.weight"),
        Entry("vision.downsample", f"{root}.downsample.weight"),
        *_weight("vision.merger.proj", f"{root}.merger.proj", False),
        *_ln("vision.merger.norm", f"{root}.merger.post_projection_norm"),
        *(e for n in ("gate", "up", "down") for e in _weight(f"vision.merger.{n}", f"{root}.merger.{n}_proj", False)),
    ]
    for i in range(v.depth):
        blk, key = f"{root}.blocks.{i}", f"vision.blocks.{i}"
        entries += [Entry(f"{key}.norm1", f"{blk}.norm1.weight"), Entry(f"{key}.norm2", f"{blk}.norm2.weight"),
                    *_weight(f"{key}.qkv", f"{blk}.attn.qkv", v.attention_bias),
                    *_weight(f"{key}.proj", f"{blk}.attn.proj", v.attention_bias),
                    Entry(f"{key}.q_norm", f"{blk}.attn.q_norm.weight"),
                    Entry(f"{key}.k_norm", f"{blk}.attn.k_norm.weight"),
                    *(e for n in ("gate_proj", "up_proj", "down_proj")
                      for e in _weight(f"{key}.{n}", f"{blk}.mlp.{n}", v.attention_bias))]
    return entries


def text_entries(cfg: GlmConfig, lm_head: bool) -> List[Entry]:
    """The decoder in the reference's split names; the q/k/v biases where
    the config has them (zeros where the checkpoint has none)."""
    t, root = cfg.text, "model.language_model"
    entries = [Entry("decoder.embed_tokens", f"{root}.embed_tokens.weight"),
               Entry("decoder.norm", f"{root}.norm.weight")]
    if lm_head:
        entries.append(Entry("decoder.lm_head", "lm_head.weight", transpose=True))
    sizes = {"q": t.num_attention_heads * t.head_dim, "k": t.num_key_value_heads * t.head_dim,
             "v": t.num_key_value_heads * t.head_dim}
    for i in range(t.num_hidden_layers):
        base, key = f"{root}.layers.{i}", f"decoder.layers.{i}"
        entries += [Entry(f"{key}.{n}", f"{base}.{n}.weight") for n in _NORMS]
        entries += [Entry(f"{key}.{p}", f"{base}.self_attn.{p}.weight", transpose=True) for p in _ATTN]
        entries += [Entry(f"{key}.{p}", f"{base}.mlp.{p}.weight", transpose=True)
                    for p in ("gate_up_proj", "down_proj")]
        if t.attention_bias:
            entries += [Entry(f"{key}.{p}_bias", f"{base}.self_attn.{p}_proj.bias", zeros=sizes[p]) for p in "qkv"]
    return entries


def checkpoint_entries(cfg: GlmConfig) -> List[Entry]:
    """Every entry of a model's state_dict (the lm_head when untied)."""
    return vision_entries(cfg) + text_entries(cfg, not cfg.text.tie_word_embeddings)


def load_glm_vision_params(reader, cfg: GlmConfig, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    out = _load(reader, vision_entries(cfg), dtype, select_device(device))
    w = out["vision.patch_embed.w"]  # the conv [H, C, T, p, p] → [C·T·p·p, H]
    out["vision.patch_embed.w"] = w.reshape(w.shape[0], -1).t().contiguous()
    return out


def load_glm_text_params(reader, cfg: GlmConfig, dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    lm_head = "lm_head.weight" in reader and not cfg.text.tie_word_embeddings
    return _load(reader, text_entries(cfg, lm_head), dtype, select_device(device))


def load_glm_params(weights_path, cfg: GlmConfig, dtype=torch.bfloat16, snapshot_path=None,
                    device=None) -> Dict[str, torch.Tensor]:
    """The state_dict of a safetensors checkpoint (a file or a shard
    index), a ``.dsq`` snapshot overriding the linears it holds."""
    device = select_device(device)
    reader = WeightSource.open(weights_path, snapshot_path, device)
    return {**load_glm_vision_params(reader, cfg, device=device),
            **load_glm_text_params(reader, cfg, dtype, device)}
