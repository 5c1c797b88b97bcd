"""PaddleOCR-VL checkpoint → the port's state_dict
(dsocr_tpu/models/paddleocr/loader.py).

The name map is the reference loader's: SigLIP under
``visual.vision_model.*`` (the patch conv [H, C, p, p] as a flattened
[C·p·p, H] linear), the projector under ``mlp_AR.*``, Ernie under
``model.*`` with ``lm_head`` at the root (read only when the embeddings
are not tied), written as a table of ``deepseek.loader.Entry`` rows. The
state_dict has the names ``convert.params_from_jax`` gives the reference
loader's tree, the decoder split (``decoder.layers.0.q_proj``), which the
engine fuses. The tower loads in f32 (the reference's ``vision_dtype``
default), the projector and decoder in the model dtype, each tensor cast
on ``device`` (the card unless the caller names the CPU). A ``.dsq``
snapshot overrides the linears it holds; with one, ``collect_raw_quant``
gathers its payloads for packing (``engine.RAW_QUANT_KEY``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ...core.device import select_device
from ...dsq.runtime import WeightSource
from ...dsq.serve_quant import collect_raw_plain
from ..deepseek.loader import Entry, _lin, _ln, _load
from .config import PaddleConfig
from .engine import RAW_QUANT_KEY

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def siglip_entries(cfg: PaddleConfig) -> List[Entry]:
    root = "visual.vision_model"
    entries = [
        Entry("vision.patch_embed.w", f"{root}.embeddings.patch_embedding.weight"),
        Entry("vision.patch_embed.b", f"{root}.embeddings.patch_embedding.bias"),
        Entry("vision.position_embedding", f"{root}.embeddings.position_embedding.weight"),
        *_ln("vision.post_layernorm", f"{root}.post_layernorm"),
    ]
    for i in range(cfg.vision_config.num_hidden_layers):
        blk, key = f"{root}.encoder.layers.{i}", f"vision.layers.{i}"
        entries += [
            *_ln(f"{key}.ln1", f"{blk}.layer_norm1"),
            *_ln(f"{key}.ln2", f"{blk}.layer_norm2"),
            *(e for n in "qkv" for e in _lin(f"{key}.{n}", f"{blk}.self_attn.{n}_proj")),
            *_lin(f"{key}.o", f"{blk}.self_attn.out_proj"),
            *_lin(f"{key}.fc1", f"{blk}.mlp.fc1"),
            *_lin(f"{key}.fc2", f"{blk}.mlp.fc2"),
        ]
    return entries


def projector_entries(cfg: PaddleConfig) -> List[Entry]:
    return [*_ln("projector.pre_norm", "mlp_AR.pre_norm"), *_lin("projector.linear_1", "mlp_AR.linear_1"),
            *_lin("projector.linear_2", "mlp_AR.linear_2")]


def ernie_entries(cfg: PaddleConfig, lm_head: bool) -> List[Entry]:
    entries = [Entry("decoder.embed_tokens", "model.embed_tokens.weight"),
               Entry("decoder.norm", "model.norm.weight")]
    if lm_head:
        entries.append(Entry("decoder.lm_head", "lm_head.weight", transpose=True))
    for i in range(cfg.num_hidden_layers):
        base, key = f"model.layers.{i}", f"decoder.layers.{i}"
        entries += [
            Entry(f"{key}.input_layernorm", f"{base}.input_layernorm.weight"),
            Entry(f"{key}.post_attention_layernorm", f"{base}.post_attention_layernorm.weight"),
            *(Entry(f"{key}.{p}", f"{base}.self_attn.{p}.weight", transpose=True) for p in _ATTN),
            *(Entry(f"{key}.{p}", f"{base}.mlp.{p}.weight", transpose=True) for p in _MLP),
        ]
    return entries


def checkpoint_entries(cfg: PaddleConfig) -> List[Entry]:
    """Every entry of a model's state_dict (the lm_head when untied)."""
    return siglip_entries(cfg) + projector_entries(cfg) + ernie_entries(cfg, not cfg.tie_word_embeddings)


def _load_siglip(reader, cfg: PaddleConfig, device) -> Dict[str, torch.Tensor]:
    out = _load(reader, siglip_entries(cfg), torch.float32, device)
    w = out["vision.patch_embed.w"]  # the conv [H, C, p, p] → [C·p·p, H]
    out["vision.patch_embed.w"] = w.reshape(w.shape[0], -1).t().contiguous()
    return out


def collect_raw_quant(reader, cfg: PaddleConfig) -> Dict:
    """The snapshot's ggml payloads of the decoder's quantizable linears,
    keyed ("layers", key) → {"method", "layers": [payload per layer]}, and
    ("", "lm_head")."""
    raw: Dict = {}
    for key, suffix in [(p, f"self_attn.{p}") for p in _ATTN] + [(p, f"mlp.{p}") for p in _MLP]:
        collect_raw_plain(reader, raw, "layers", key,
                          [f"model.layers.{i}.{suffix}" for i in range(cfg.num_hidden_layers)])
    collect_raw_plain(reader, raw, "", "lm_head", ["lm_head"])
    return raw


def load_paddle_params(weights_path, cfg: PaddleConfig, dtype=torch.bfloat16, snapshot_path=None,
                       device=None) -> Dict:
    """The state_dict of a safetensors checkpoint (a file or a shard
    index), a ``.dsq`` snapshot overriding the linears it holds; with a
    snapshot, its payloads under ``RAW_QUANT_KEY``."""
    device = select_device(device)
    reader = WeightSource.open(weights_path, snapshot_path, device)
    lm_head = "lm_head.weight" in reader and not cfg.tie_word_embeddings
    state = {
        **_load_siglip(reader, cfg, device),
        **_load(reader, projector_entries(cfg), dtype, device),
        **_load(reader, ernie_entries(cfg, lm_head), dtype, device),
    }
    if snapshot_path is not None:
        raw = collect_raw_quant(reader, cfg)
        if raw:
            state[RAW_QUANT_KEY] = raw
    return state
