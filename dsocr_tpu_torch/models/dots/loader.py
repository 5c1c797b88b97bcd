"""DotsOCR checkpoint → the port's state_dict
(dsocr_tpu/models/dots/loader.py).

The name map is the reference loader's: the tower under
``vision_tower.*`` (``patch_embed.patchifier.{proj,norm}``, the blocks'
``attn.{qkv,proj}`` and ``mlp.fc{1,2,3}``, ``post_trunk_norm``,
``merger.ln_q`` and ``merger.mlp.{0,2}``), Qwen2 under ``model.*`` with
the q/k/v biases, ``lm_head`` at the root (read when the embeddings are
not tied), written as a table of ``deepseek.loader.Entry`` rows. The
state_dict has the names ``convert.params_from_jax`` gives the
reference loader's tree, the decoder split (``decoder.layers.0.q_proj``,
``.q_bias``), which the engine fuses; the patch conv keeps its [E, C, p,
p] layout. The tower always loads in f32 (the reference's ``vision_dtype``
default), the decoder in the model dtype, each tensor cast on ``device``
(the card unless the caller names the CPU). A ``.dsq`` snapshot
overrides the linears it holds, and with one its published payloads are
gathered for packing (``engine.RAW_QUANT_KEY``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ...core.device import select_device
from ...dsq.runtime import WeightSource
from ..deepseek.engine import RAW_QUANT_KEY
from ..deepseek.loader import Entry, _lin, _ln, _load
from ..paddleocr.loader import collect_raw_quant as _collect_raw_quant
from ..paddleocr.loader import ernie_entries
from .config import DotsConfig


def _weight(key: str, name: str, bias: bool) -> List[Entry]:
    """A tower linear: [out, in] → [in, out] ``.w``, and its bias when the
    tower has them."""
    return _lin(key, name) if bias else [Entry(f"{key}.w", f"{name}.weight", transpose=True)]


def vision_entries(cfg: DotsConfig) -> List[Entry]:
    v, root = cfg.vision, "vision_tower"
    patch = f"{root}.patch_embed.patchifier"
    entries = [
        Entry("vision.patch_embed.w", f"{patch}.proj.weight"),
        Entry("vision.patch_embed.b", f"{patch}.proj.bias", zeros=v.embed_dim),
        Entry("vision.patch_embed.norm", f"{patch}.norm.weight"),
    ]
    if v.post_norm:
        entries.append(Entry("vision.post_trunk_norm", f"{root}.post_trunk_norm.weight"))
    entries += [*_ln("vision.merger.ln_q", f"{root}.merger.ln_q"),
                *_lin("vision.merger.mlp_in", f"{root}.merger.mlp.0"),
                *_lin("vision.merger.mlp_out", f"{root}.merger.mlp.2")]
    for i in range(v.num_hidden_layers):
        blk, key = f"{root}.blocks.{i}", f"vision.blocks.{i}"
        entries += [Entry(f"{key}.norm1", f"{blk}.norm1.weight"), Entry(f"{key}.norm2", f"{blk}.norm2.weight"),
                    *_weight(f"{key}.qkv", f"{blk}.attn.qkv", v.use_bias),
                    *_weight(f"{key}.proj", f"{blk}.attn.proj", v.use_bias),
                    *(e for n in ("fc1", "fc2", "fc3") for e in _weight(f"{key}.{n}", f"{blk}.mlp.{n}", v.use_bias))]
    return entries


def qwen2_entries(cfg: DotsConfig, lm_head: bool) -> List[Entry]:
    """The Ernie decoder's names (the same HF layout), with the q/k/v
    biases where the config has them (zeros where the checkpoint has
    none, which adds what the reference's absent bias adds)."""
    t = cfg.text
    entries = ernie_entries(t, lm_head)
    if t.attention_bias:
        sizes = {"q": t.num_attention_heads * t.head_dim, "k": t.num_key_value_heads * t.head_dim,
                 "v": t.num_key_value_heads * t.head_dim}
        entries += [Entry(f"decoder.layers.{i}.{p}_bias", f"model.layers.{i}.self_attn.{p}_proj.bias",
                          zeros=sizes[p])
                    for i in range(t.num_hidden_layers) for p in "qkv"]
    return entries


def checkpoint_entries(cfg: DotsConfig) -> List[Entry]:
    """Every entry of a model's state_dict (the lm_head when untied)."""
    return vision_entries(cfg) + qwen2_entries(cfg, not cfg.text.tie_word_embeddings)


def collect_raw_quant(reader, cfg: DotsConfig) -> Dict:
    """The snapshot's ggml payloads of the decoder's quantizable linears
    (the Ernie decoder's keys and names)."""
    return _collect_raw_quant(reader, cfg.text)


def load_dots_vision_params(reader, cfg: DotsConfig, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return _load(reader, vision_entries(cfg), dtype, select_device(device))


def load_qwen2_params(reader, cfg: DotsConfig, dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    lm_head = "lm_head.weight" in reader and not cfg.text.tie_word_embeddings
    return _load(reader, qwen2_entries(cfg, lm_head), dtype, select_device(device))


def load_dots_params(weights_path, cfg: DotsConfig, dtype=torch.bfloat16, snapshot_path=None,
                     device=None) -> Dict:
    """The state_dict of a safetensors checkpoint (a file or a shard
    index), a ``.dsq`` snapshot overriding the linears it holds; with a
    snapshot, its payloads under ``RAW_QUANT_KEY``."""
    device = select_device(device)
    reader = WeightSource.open(weights_path, snapshot_path, device)
    state = {**load_dots_vision_params(reader, cfg, device=device),
             **load_qwen2_params(reader, cfg, dtype, device)}
    if snapshot_path is not None:
        raw = collect_raw_quant(reader, cfg)
        if raw:
            state[RAW_QUANT_KEY] = raw
    return state
