"""DotsOCR engine (dsocr_tpu/models/dots/engine.py): smart-resize →
DotsVision over every image of a call packed into one sequence → prompt
with <|img|>, one <|imgpad|> per merged patch and <|endofimg|> → Qwen2
prefill → decode.

Surfaces, as the reference's:

- ``decode``: one request, prefill into a contiguous KVCache, then
  runtime.generate's Generator (EOS 151643 appended, then stop);
- the slot surface for ``ContinuousScheduler``: ``slot_step_fn``,
  ``new_slot_cache`` (int8 KV or the model dtype), ``make_slot_runner``
  (``emit_eos=True``), ``prefill_for_slot`` and ``prefill_for_slots``.
  Positions are plain token indices, so a row's ``pos`` is its length.

``mesh="dp=N,mp=M"`` serves the slot surface over dp × mp rank processes
by the reference's rules (models/gqa_mesh.py): params replicated (float
or packed), slot rows over dp (the packed row matmuls on each rank's
rows), Qwen2's KV heads over mp, the towers and ``decode`` on rank 0
alone.

``prefill_for_slots`` groups a wave's requests by VisionSettings: the
images of a group go through the tower in one packed pass, then each group
of rows sharing a 128-token bucket prefills in one batched pass,
right-padded, through ``flash_prefill_attention``. Patches travel to the
device as uint8 and are normalized there through the per-channel table
(smart_resize.norm_table, bit-exact with normalizing on the host).
``quantize`` ("q8_0", "q4_k", "q6_k"; None reads ``DSOCR_QUANT``) packs
the decoder's linears and the lm_head. The reference's jitted
padded-bucket tower and the power-of-two batch padding of its compiled
prefill are not carried over.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.benchmark import Timer
from ...core.device import select_device
from ...core.params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text
from ...image.smart_resize import SmartResizeConfig, norm_table, preprocess_patches_raw
from ...runtime.generate import GenerateParams, Generator, clamp_new_tokens
from ...runtime.kv_cache import KVCache, bump_length, init_kv_cache
from ...runtime.slots import SlotRunner
from ..deepseek.engine import RAW_QUANT_KEY, round_up
from ..gqa_decoder import embed_row
from ..gqa_mesh import MeshServing, dense_mesh
from .config import DotsConfig
from .decoder import Qwen2Decoder, fuse_qwen2_params
from .quantize import quantize_qwen2_params
from .vision import DotsVisionTower, SequenceLayout


class DotsOcrModel(nn.Module):
    """All weights of one DotsOCR model; state_dict names follow the
    reference's parameter tree (convert.params_from_jax)."""

    def __init__(self, cfg: DotsConfig, dtype, device, quantize: Optional[str] = None):
        super().__init__()
        self.vision = DotsVisionTower(cfg.vision, torch.float32, device)
        self.decoder = Qwen2Decoder(cfg.text, dtype, device, quantize)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        self.vision.reset_(gen)
        self.decoder.reset_(gen)


class DotsOcrEngine(MeshServing):
    def __init__(
        self,
        cfg: DotsConfig,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        max_seq_len: int = 16384,
        seed: int = 0,
        kv_quant: Optional[str] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        quantize: Optional[str] = None,
        mesh=None,
        ranks=None,
        state_fn=None,
    ):
        """Random weights from `seed` on the device (the tower in f32, as
        the reference's init), or `state` (params_from_jax of a reference
        engine, or loader.load_dots_params; a split decoder is fused here,
        and the tower holds f32 either way). `device` None means the CUDA
        card. `mesh`, `ranks` and `state_fn` as PaddleOcrEngine's."""
        if quantize is None:
            quantize = os.environ.get("DSOCR_QUANT") or None
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        if quantize not in (None, "q8_0", "q4_k", "q6_k"):
            raise ValueError(f"unsupported quantize {quantize!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = select_device(device)
        ranks = self._start_mesh(dense_mesh(mesh, "DotsOCR"), ranks, dict(
            cfg=cfg, dtype=dtype, max_seq_len=max_seq_len, seed=seed, kv_quant=kv_quant, state=state,
            quantize=quantize, state_fn=state_fn))
        if state_fn is not None:
            state = state_fn(self.device)
        self.kv_quant = kv_quant
        self.quantize = quantize
        self.max_seq_len = max_seq_len
        if state is not None:
            state = dict(state)
            raw = state.pop(RAW_QUANT_KEY, None)
            state = fuse_qwen2_params(state)
            if quantize:
                state = quantize_qwen2_params(state, quantize, raw=raw)
        self.model = DotsOcrModel(cfg, dtype, self.device, quantize)
        if state is None:
            self.model.reset_(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(state)
        self.model.eval()
        self.params = self.model.decoder  # what SlotRunner hands to slot_step_fn
        if self.mesh is not None:
            self._attach_mesh(ranks)

    # -- vision -----------------------------------------------------------------

    def _prep(self, vision: VisionSettings) -> SmartResizeConfig:
        v = self.cfg.vision
        return SmartResizeConfig(patch_size=v.patch_size,
                                 merge_size=v.spatial_merge_size).with_max_image_size(vision.image_size)

    @torch.no_grad()
    def encode_images(self, images: Sequence[np.ndarray],
                      vision: VisionSettings) -> Tuple[List[torch.Tensor], List[Tuple[int, int, int]]]:
        """Every image through one tower pass → (merged tokens [n_i, hidden]
        per image, grids)."""
        if not images:
            return [], []
        prep = self._prep(vision)
        prepared = [preprocess_patches_raw(np.asarray(image), prep) for image in images]
        grids = [p.grid_thw for p in prepared]
        merge = self.cfg.vision.spatial_merge_size
        layout = SequenceLayout.from_grid(grids, merge)
        table = torch.from_numpy(norm_table(prep)).to(self.device)
        u8 = torch.from_numpy(np.concatenate([p.patches for p in prepared])).to(self.device).long()
        patches = table.reshape(-1)[u8 + torch.arange(3, device=self.device)[:, None, None] * 256]
        merged = self.model.vision(patches.to(self.dtype), layout)
        counts = [t * h * w // merge ** 2 for t, h, w in grids]
        return list(torch.split(merged, counts)), grids

    # -- prompt -------------------------------------------------------------------

    def build_prompt_tokens(self, tokenizer, prompt: str,
                            grids: Sequence[Tuple[int, int, int]]) -> Tuple[List[int], List[int]]:
        """Token ids and image mask: the text segments around each
        <image>, an image as <|img|>, one <|imgpad|> per merged patch and
        <|endofimg|>."""
        cfg = self.cfg
        merge_area = cfg.vision.spatial_merge_size ** 2
        segments = prompt.split("<image>")
        if len(segments) - 1 != len(grids):
            raise ValueError(f"prompt/image mismatch: {len(segments) - 1} slots vs {len(grids)} grids")
        tokens: List[int] = []
        mask: List[int] = []
        for idx, segment in enumerate(segments):
            if segment:
                ids = tokenizer.encode(segment)
                tokens.extend(ids)
                mask.extend([0] * len(ids))
            if idx < len(grids):
                t, h, w = grids[idx]
                count = t * h * w // merge_area
                tokens += [cfg.image_start_token_id] + [cfg.image_token_id] * count + [cfg.image_end_token_id]
                mask += [0] + [1] * count + [0]
        return tokens, mask

    # -- prefill ------------------------------------------------------------------

    def new_kv_cache(self, batch: int, max_len: int) -> KVCache:
        t = self.cfg.text
        return init_kv_cache(t.num_hidden_layers, batch, t.num_key_value_heads, max_len, t.head_dim, t.head_dim,
                             self.dtype, self.device)

    @staticmethod
    def _images(embeddings: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        return torch.cat(list(embeddings)) if embeddings else None

    @torch.no_grad()
    def _prefill_rows(self, rows) -> List[dict]:
        """rows = [(tokens, image_mask, embeddings)] sharing one s_pad bucket
        → one join packet per row, from one batched prefill (on every rank
        under a mesh)."""
        s_pad = round_up(len(rows[0][0]), 128)
        positions = np.tile(np.arange(s_pad, dtype=np.int64), (len(rows), 1))
        packets = self._prefill_packets([t for t, _, _ in rows], [m for _, m, _ in rows],
                                        [self._images(e) for _, _, e in rows], positions, s_pad)
        for pkt, (tokens, _, _) in zip(packets, rows):
            pkt["pos0"] = len(tokens)
        return packets

    def prefill_for_slot(self, tokenizer, prompt, images, vision) -> dict:
        """Vision + prompt + one-row prefill → a join packet."""
        return self.prefill_for_slots(tokenizer, [(prompt, images, vision)])[0]

    def prefill_for_slots(self, tokenizer, requests) -> List[dict]:
        """Join packets for [(prompt, images, vision), ...]: one tower pass
        per VisionSettings, then one batched prefill per group of rows
        sharing a 128-token bucket."""
        tower_t = Timer("slot.vision_towers")
        groups: Dict[VisionSettings, List[int]] = {}
        for i, (_, _, vision) in enumerate(requests):
            groups.setdefault(vision, []).append(i)
        rows: List[Optional[tuple]] = [None] * len(requests)
        for vision, idxs in groups.items():
            embeddings, grids = self.encode_images([img for i in idxs for img in requests[i][1]], vision)
            at = 0
            for i in idxs:
                n = len(requests[i][1])
                tokens, mask = self.build_prompt_tokens(tokenizer, requests[i][0], grids[at : at + n])
                rows[i] = (tokens, mask, embeddings[at : at + n])
                at += n
        tower_t.finish(images=sum(len(r[1]) for r in requests))
        prefill_t = Timer("slot.prefill_rows")
        buckets: Dict[int, List[int]] = {}
        for i, (tokens, _, _) in enumerate(rows):
            buckets.setdefault(round_up(len(tokens), 128), []).append(i)
        out: List[Optional[dict]] = [None] * len(rows)
        for idxs in buckets.values():
            for i, pkt in zip(idxs, self._prefill_rows([rows[i] for i in idxs])):
                out[i] = pkt
        prefill_t.finish(rows=len(out), waves=len(buckets))
        return out

    # -- continuous-batching (slot) surface -----------------------------------------

    @staticmethod
    def step_positions(pos: torch.Tensor) -> torch.Tensor:
        """A step's positions [B] → [B, 1]."""
        return pos[:, None]

    def make_slot_runner(self) -> SlotRunner:
        return self._slot_runner((self.cfg.eos_token_id,), emit_eos=True)

    # -- single-request decode ----------------------------------------------------

    def _step_fn(self, decoder, token_ids, cache: KVCache, pos_state):
        """One token per row at position cache.length → (logits, cache
        bumped by one, pos_state)."""
        embeds = decoder.embed_tokens[token_ids][:, None, :].to(self.dtype)
        positions = torch.full((token_ids.shape[0], 1), cache.length, device=token_ids.device)
        logits, cache = decoder(embeds, positions, cache)
        return logits, bump_length(cache, 1), pos_state

    @torch.no_grad()
    def decode(self, tokenizer, prompt: str, images: Sequence[np.ndarray], vision: VisionSettings,
               params: DecodeParameters, stream=None) -> DecodeOutcome:
        """One request: vision, prompt, prefill to s_pad = round_up(len,
        128) into a cache of the clamped budget, then greedy or sampled
        generation; EOS is appended, then generation stops. Under a mesh
        it runs on rank 0 alone (the module docstring)."""
        if not params.use_cache:
            raise ValueError("DotsOCR decoder requires use_cache=true")
        vtimer = Timer("vision.compute_embeddings")
        embeddings, grids = self.encode_images(images, vision)
        vtimer.finish(images=len(images))
        tokens, image_mask = self.build_prompt_tokens(tokenizer, prompt, grids)
        prompt_len = len(tokens)
        s_pad = round_up(prompt_len, 128)
        max_new = clamp_new_tokens(s_pad, params.max_new_tokens, self.max_seq_len)
        max_len = min(self.max_seq_len, round_up(s_pad + max_new + 8, 128))
        embeds = embed_row(self.model.decoder, tokens, image_mask, self._images(embeddings), s_pad, self.dtype)
        pf_timer = Timer("decode.prefill")
        logits, cache = self.model.decoder(
            embeds[None], torch.arange(s_pad, device=self.device)[None], self.new_kv_cache(1, max_len),
            last_index=torch.tensor([prompt_len - 1], device=self.device), flash_prefill=True)
        cache = bump_length(cache, prompt_len)
        pf_timer.finish(prompt_tokens=prompt_len)
        gen_params = GenerateParams(
            max_new_tokens=max_new, do_sample=params.do_sample, temperature=params.temperature,
            top_p=params.top_p, top_k=params.top_k, repetition_penalty=params.repetition_penalty,
            no_repeat_ngram_size=params.no_repeat_ngram_size, eos_ids=(self.cfg.eos_token_id,), emit_eos=True,
            chunk_size=16 if stream is not None else 64,
        )
        gtimer = Timer("decode.generate")
        result = Generator(self._step_fn, gen_params).generate(
            self.model.decoder, logits, cache, None, [tokens],
            generator=torch.Generator(device=self.device).manual_seed(params.seed or 0),
            stream_callback=stream,
        )
        generated = result.tokens[0]
        gtimer.finish(generated=len(generated))
        return DecodeOutcome(
            text=normalize_text(tokenizer.decode(generated, skip_special_tokens=True)),
            prompt_tokens=prompt_len, response_tokens=len(generated), generated_tokens=generated,
            truncated=max_new < params.max_new_tokens,
        )
