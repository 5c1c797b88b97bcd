"""DeepSeek-OCR checkpoint → the port's state_dict
(dsocr_tpu/models/deepseek/loader.py).

The name map is the reference loader's (HF names under ``model.*``:
``sam_model``, ``vision_model``, ``projector``, ``layers.N``; ``lm_head``
at the root), written once as a table of ``Entry`` rows
(``checkpoint_entries``) that the loaders walk. The state_dict has the
names ``convert.params_from_jax`` gives the reference loader's tree:
[in, out] linears, each decoder layer its own entry in the split layout
(``decoder.moe_layers.0.q_proj``, ``...experts_gate`` [E, in, out]), so
``DeepseekOcrEngine(state=...)`` takes it unchanged and fuses it.

Each tensor is read in its stored dtype (a view of the mapped file), moved
to ``device`` (the card unless the caller names the CPU) and cast there to
the model dtype; expert stacks are built on the device one projection of
one layer at a time. SAM and CLIP load in ``vision_compute_dtype`` (the
model dtype, f32 under ``DSOCR_VISION_F32``), as the reference's do. A ``.dsq`` snapshot
overrides the linears it holds (``dsq/runtime.py: WeightSource``, records
dequantized on the device to f32, then cast), and ``collect_raw_quant``
gathers its ggml payloads, which the engine packs directly
(``engine.RAW_QUANT_KEY``). OCR2 has the Qwen2 encoder in place of CLIP
and the projector (``load_ocr2_params``: ``model.qwen2_model.model.model.*``,
``model.qwen2_model.query_{768,1024}.weight``, the shared projector name
and ``model.view_seperator``), read in f32, the dtype the encoder
computes in (ocr2.py); the reference reads it in the towers' dtype, and
the published bf16 values are the same in f32. A MoE layer's router
bias (``mlp.gate.e_score_correction_bias``) loads as ``gate_bias`` where
the checkpoint has one, in the model dtype as the reference stacks it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ...core.device import select_device
from ...dsq.runtime import WeightSource
from ...dsq.serve_quant import collect_raw_plain
from .config import DeepseekOcrConfig, vision_compute_dtype
from .decoder import split_layers
from .engine import RAW_QUANT_KEY
from .ocr2 import Qwen2EncoderParams


@dataclasses.dataclass(frozen=True)
class Entry:
    """One state_dict entry and where it lies in the checkpoint."""

    key: str  # state_dict key
    name: str  # checkpoint name; for a stack of experts a template with {e}
    transpose: bool = False  # stored [out, in], kept [in, out]
    experts: int = 0  # > 0: that many experts' [out, in] tensors → [E, in, out]
    # optional in the checkpoint: zeros of this length where absent (-1: a
    # linear's bias, as long as the out dim of its ".w" entry)
    zeros: int = 0


def _lin(key: str, name: str) -> List[Entry]:
    """A linear: [out, in] weight → [in, out] ``.w``, and its optional bias."""
    return [Entry(f"{key}.w", f"{name}.weight", transpose=True), Entry(f"{key}.b", f"{name}.bias", zeros=-1)]


def _ln(key: str, name: str) -> List[Entry]:
    return [Entry(f"{key}.w", f"{name}.weight"), Entry(f"{key}.b", f"{name}.bias")]


def sam_entries(cfg: DeepseekOcrConfig, reader=None) -> List[Entry]:
    """SAM ViT-B (model.sam_model.*); a block's MLP is ``mlp.fc1``/``fc2``,
    or ``mlp.lin1``/``lin2`` where the checkpoint names it so."""
    root = "model.sam_model"
    entries = [
        Entry("sam.patch_embed.w", f"{root}.patch_embed.proj.weight"),
        Entry("sam.patch_embed.b", f"{root}.patch_embed.proj.bias"),
        Entry("sam.pos_embed", f"{root}.pos_embed"),
        Entry("sam.neck.conv1", f"{root}.neck.0.weight"),
        *_ln("sam.neck.norm1", f"{root}.neck.1"),
        Entry("sam.neck.conv2", f"{root}.neck.2.weight"),
        *_ln("sam.neck.norm2", f"{root}.neck.3"),
        Entry("sam.net_2", f"{root}.net_2.weight"),
        Entry("sam.net_3", f"{root}.net_3.weight"),
    ]
    for i in range(cfg.sam.depth):
        blk, key = f"{root}.blocks.{i}", f"sam.blocks.{i}"
        fc = "fc" if reader is None or f"{blk}.mlp.fc1.weight" in reader else "lin"
        entries += [
            *_ln(f"{key}.norm1", f"{blk}.norm1"),
            *_ln(f"{key}.norm2", f"{blk}.norm2"),
            *_lin(f"{key}.qkv", f"{blk}.attn.qkv"),
            *_lin(f"{key}.proj", f"{blk}.attn.proj"),
            Entry(f"{key}.rel_pos_h", f"{blk}.attn.rel_pos_h"),
            Entry(f"{key}.rel_pos_w", f"{blk}.attn.rel_pos_w"),
            *_lin(f"{key}.fc1", f"{blk}.mlp.{fc}1"),
            *_lin(f"{key}.fc2", f"{blk}.mlp.{fc}2"),
        ]
    return entries


def clip_entries(cfg: DeepseekOcrConfig) -> List[Entry]:
    """CLIP-L (model.vision_model.*; ``pre_layrnorm`` sic)."""
    root = "model.vision_model"
    entries = [
        Entry("clip.class_embedding", f"{root}.embeddings.class_embedding"),
        Entry("clip.position_embedding", f"{root}.embeddings.position_embedding.weight"),
        *_ln("clip.pre_layernorm", f"{root}.pre_layrnorm"),
    ]
    for i in range(cfg.clip.num_layers):
        blk, key = f"{root}.transformer.layers.{i}", f"clip.layers.{i}"
        entries += [
            *_ln(f"{key}.ln1", f"{blk}.layer_norm1"),
            *_ln(f"{key}.ln2", f"{blk}.layer_norm2"),
            *_lin(f"{key}.qkv", f"{blk}.self_attn.qkv_proj"),
            *_lin(f"{key}.out", f"{blk}.self_attn.out_proj"),
            *_lin(f"{key}.fc1", f"{blk}.mlp.fc1"),
            *_lin(f"{key}.fc2", f"{blk}.mlp.fc2"),
        ]
    return entries


def projector_entries(cfg: DeepseekOcrConfig) -> List[Entry]:
    """The linear projector; its bias and the two learned separators are
    optional (zeros where absent; the reference serves no bias then)."""
    n = cfg.projector_n_embed
    return [
        Entry("projector.weight", "model.projector.layers.weight", transpose=True),
        Entry("projector.bias", "model.projector.layers.bias", zeros=n),
        Entry("projector.image_newline", "model.image_newline", zeros=n),
        Entry("projector.view_seperator", "model.view_seperator", zeros=n),
    ]


def ocr2_entries(p: Qwen2EncoderParams) -> List[Entry]:
    """OCR2's Qwen2 encoder (model.qwen2_model.*) and its projector; the
    projector's bias and the view separator are optional (zeros)."""
    root = "model.qwen2_model"
    entries = [
        Entry("ocr2.norm", f"{root}.model.model.norm.weight"),
        Entry("ocr2.query_768", f"{root}.query_768.weight"),
        Entry("ocr2.query_1024", f"{root}.query_1024.weight"),
        Entry("ocr2.projector.w", "model.projector.layers.weight", transpose=True),
        Entry("ocr2.projector.b", "model.projector.layers.bias", zeros=p.projector_out),
        Entry("ocr2.view_seperator", "model.view_seperator", zeros=p.projector_out),
    ]
    for i in range(p.num_layers):
        base, key = f"{root}.model.model.layers.{i}", f"ocr2.layers.{i}"
        entries += [
            Entry(f"{key}.input_layernorm", f"{base}.input_layernorm.weight"),
            Entry(f"{key}.post_attention_layernorm", f"{base}.post_attention_layernorm.weight"),
            *(Entry(f"{key}.{n}_proj", f"{base}.self_attn.{n}_proj.weight", transpose=True)
              for n in ("q", "k", "v", "o")),
            *(Entry(f"{key}.{n}_bias", f"{base}.self_attn.{n}_proj.bias") for n in ("q", "k", "v")),
            *(Entry(f"{key}.{n}", f"{base}.mlp.{n}.weight", transpose=True)
              for n in ("gate_proj", "up_proj", "down_proj")),
        ]
    return entries


def decoder_entries(cfg: DeepseekOcrConfig, shared: bool = True, gate_bias: bool = False) -> List[Entry]:
    """The DeepSeek-V2 decoder: embeddings, final norm and lm_head, then
    per layer of each group (``dense_layers``, ``moe_layers``, numbered
    from 0 within the group) the norms and q/k/v/o, the dense MLP or the
    router (with `gate_bias` its score-correction bias), the routed
    experts and (with `shared`) the shared experts."""
    lang = cfg.language
    num_dense, num_moe = split_layers(lang)
    entries = [
        Entry("decoder.embed_tokens", "model.embed_tokens.weight"),
        Entry("decoder.norm", "model.norm.weight"),
        Entry("decoder.lm_head", "lm_head.weight", transpose=True),
    ]
    for i in range(num_dense + num_moe):
        base = f"model.layers.{i}"
        key = f"decoder.dense_layers.{i}" if i < num_dense else f"decoder.moe_layers.{i - num_dense}"
        entries += [
            Entry(f"{key}.input_layernorm", f"{base}.input_layernorm.weight"),
            Entry(f"{key}.post_attention_layernorm", f"{base}.post_attention_layernorm.weight"),
            *(Entry(f"{key}.{p}", f"{base}.self_attn.{p}.weight", transpose=True)
              for p in ("q_proj", "k_proj", "v_proj", "o_proj")),
        ]
        if i < num_dense:
            entries += [Entry(f"{key}.{p}", f"{base}.mlp.{p}.weight", transpose=True)
                        for p in ("gate_proj", "up_proj", "down_proj")]
            continue
        entries.append(Entry(f"{key}.gate_weight", f"{base}.mlp.gate.weight"))
        if gate_bias:
            entries.append(Entry(f"{key}.gate_bias", f"{base}.mlp.gate.e_score_correction_bias"))
        entries += [Entry(f"{key}.experts_{p}", f"{base}.mlp.experts.{{e}}.{p}_proj.weight",
                          experts=lang.n_routed_experts) for p in ("gate", "up", "down")]
        if shared:
            entries += [Entry(f"{key}.shared_{p}", f"{base}.mlp.shared_experts.{p}_proj.weight", transpose=True)
                        for p in ("gate", "up", "down")]
    return entries


def checkpoint_entries(cfg: DeepseekOcrConfig, reader=None, ocr2: Optional[Qwen2EncoderParams] = None,
                       gate_bias: bool = False) -> List[Entry]:
    """Every entry of a model's state_dict (OCR2: the encoder of `ocr2`,
    the published widths by default)."""
    towers = (ocr2_entries(ocr2 or Qwen2EncoderParams()) if cfg.variant == "ocr2"
              else clip_entries(cfg) + projector_entries(cfg))
    return (sam_entries(cfg, reader) + towers
            + decoder_entries(cfg, shared=bool(cfg.language.n_shared_experts), gate_bias=gate_bias))


def _get(reader, name: str, dtype, device) -> torch.Tensor:
    """A checkpoint tensor in its stored dtype (or a snapshot record
    dequantized to f32) → `device`, then cast to `dtype` there."""
    return reader.get(name).to(device).to(dtype)


def _load(reader, entries: List[Entry], dtype, device) -> Dict[str, torch.Tensor]:
    out = {}
    for e in entries:
        if e.experts:
            first = _get(reader, e.name.format(e=0), dtype, device)
            stack = torch.empty((e.experts, *first.shape[::-1]), dtype=dtype, device=device)
            stack[0] = first.t()
            for j in range(1, e.experts):
                stack[j] = _get(reader, e.name.format(e=j), dtype, device).t()
            out[e.key] = stack
        elif e.zeros and e.name not in reader:
            size = e.zeros if e.zeros > 0 else out[e.key[: -len(".b")] + ".w"].shape[-1]
            out[e.key] = torch.zeros(size, dtype=dtype, device=device)
        else:
            t = _get(reader, e.name, dtype, device)
            out[e.key] = t.t().contiguous() if e.transpose else t
    return out


def load_sam_params(reader, cfg: DeepseekOcrConfig, dtype=torch.bfloat16, device=None):
    return _load(reader, sam_entries(cfg, reader), dtype, select_device(device))


def load_clip_params(reader, cfg: DeepseekOcrConfig, dtype=torch.bfloat16, device=None):
    return _load(reader, clip_entries(cfg), dtype, select_device(device))


def load_projector_params(reader, cfg: DeepseekOcrConfig, dtype=torch.bfloat16, device=None):
    return _load(reader, projector_entries(cfg), dtype, select_device(device))


def load_ocr2_params(reader, p: Optional[Qwen2EncoderParams] = None, device=None):
    """OCR2's encoder and projector in f32 (the module docstring)."""
    return _load(reader, ocr2_entries(p or Qwen2EncoderParams()), torch.float32, select_device(device))


def load_decoder_params(reader, cfg: DeepseekOcrConfig, dtype=torch.bfloat16, device=None):
    """The decoder in the split layout, with the MoE layers' router biases
    where the checkpoint has them (the first MoE layer's decides)."""
    lang = cfg.language
    num_dense, num_moe = split_layers(lang)
    gate_bias = bool(num_moe) and f"model.layers.{num_dense}.mlp.gate.e_score_correction_bias" in reader
    shared = f"model.layers.{num_dense}.mlp.shared_experts.gate_proj.weight" in reader
    return _load(reader, decoder_entries(cfg, shared=shared, gate_bias=gate_bias), dtype,
                 select_device(device))


def collect_raw_quant(reader, cfg: DeepseekOcrConfig) -> Dict:
    """The snapshot's ggml payloads of the decoder's quantizable linears,
    keyed (group, key) → {"method", "layers": [payload per layer]} (per
    expert for expert stacks: [[payload per expert] per layer]; group ""
    for the lm_head), where every layer has one under one method. Packing
    these serves the snapshot's published codes: the reference's QMatMul
    reads the same bytes, and a K-quant's dequantize → requantize round
    trip is not exact."""
    lang = cfg.language
    num_dense, num_moe = split_layers(lang)
    raw: Dict = {}
    for group, indices in (("dense_layers", range(num_dense)),
                           ("moe_layers", range(num_dense, num_dense + num_moe))):
        if not indices:
            continue
        plain = [(p, f"self_attn.{p}") for p in ("q_proj", "k_proj", "v_proj", "o_proj")]
        if group == "moe_layers":
            plain += [(f"shared_{p}", f"mlp.shared_experts.{p}_proj") for p in ("gate", "up", "down")]
        for key, suffix in plain:
            collect_raw_plain(reader, raw, group, key, [f"model.layers.{i}.{suffix}" for i in indices])
        if group != "moe_layers":
            continue
        for proj in ("gate", "up", "down"):
            layers, dtypes = [], set()
            for i in indices:
                hits = [reader.raw_quant(f"model.layers.{i}.mlp.experts.{e}.{proj}_proj.weight")
                        for e in range(lang.n_routed_experts)]
                if any(h is None for h in hits):
                    break
                dtypes.update(h[1] for h in hits)
                layers.append([h[0] for h in hits])
            else:
                if len(dtypes) == 1:
                    raw[(group, f"experts_{proj}")] = {"method": dtypes.pop().lower(), "layers": layers}
    head = reader.raw_quant("lm_head.weight")
    if head is not None:
        raw[("", "lm_head")] = {"method": head[1].lower(), "layers": [head[0]]}
    return raw


def load_deepseek_params(weights_path, cfg: DeepseekOcrConfig, dtype=torch.bfloat16, snapshot_path=None,
                         device=None, ocr2: Optional[Qwen2EncoderParams] = None) -> Dict:
    """The state_dict of a safetensors checkpoint (a file or a shard
    index), a ``.dsq`` snapshot overriding the linears it holds; with a
    snapshot, its payloads under ``RAW_QUANT_KEY`` for quantized serving.
    OCR2 reads the encoder of `ocr2` (the published widths by default, as
    the reference always does)."""
    device = select_device(device)
    vdtype = vision_compute_dtype(dtype)
    reader = WeightSource.open(weights_path, snapshot_path, device)
    state = {
        **load_sam_params(reader, cfg, vdtype, device),
        **load_decoder_params(reader, cfg, dtype, device),
    }
    if cfg.variant == "ocr2":
        state.update(load_ocr2_params(reader, ocr2, device))
    else:
        state.update(load_clip_params(reader, cfg, vdtype, device))
        state.update(load_projector_params(reader, cfg, dtype, device))
    if snapshot_path is not None:
        raw = collect_raw_quant(reader, cfg)
        if raw:
            state[RAW_QUANT_KEY] = raw
    return state
