"""GLM-OCR engine (dsocr_tpu/models/glm/engine.py): GLM's smart-resize and
CLIP-statistics normalization, patches in merge-window order with the
frame duplicated over the temporal axis → the GLM tower → the fixed chat
scaffold ``[gMASK]<sop><|user|>\\n … <|assistant|>\\n`` → token-type 3-axis
positions → the GLM decoder, greedy only, stopping at any of its EOS ids.

Surfaces, as the reference's:

- ``decode``: one request, prefill into a contiguous KVCache, then
  runtime.generate's Generator (an EOS is never emitted); sampling raises;
- the slot surface for ``ContinuousScheduler``: ``validate_slot_params``
  (refusing sampling, which the scheduler asks before a request joins),
  ``slot_step_fn``, ``new_slot_cache``, ``make_slot_runner``
  (``emit_eos=False``), ``prefill_for_slot`` and ``prefill_for_slots``. A
  row's position base travels as the runner's per-row ``pos`` (the join
  packet's ``pos0`` is the next base after the prompt, not its length),
  advanced by one a step.

``mesh="dp=N,mp=M"`` serves the slot surface over dp × mp rank processes
by the reference's rules (models/gqa_mesh.py): params replicated, slot
rows over dp, GLM's KV heads over mp (q/k/v still one f32 product of
every head, rounded once, then sliced), the towers and ``decode`` on
rank 0 alone.

``prefill_for_slots`` runs the images of a wave through the tower in
passes of at most ``VISION_POOL`` patches (32,768, the reference's
default; a page reaches 24,576), in request order, which bounds the
tower's f32 activations; then each group of rows sharing a
128-token bucket prefills in one batched pass, right-padded, through
``flash_prefill_attention``. Patches travel to the device as uint8 and are
normalized there through the per-channel table (``glm_norm_table``,
bit-exact with the reference's normalization), then duplicated over the
temporal axis. The engine takes no ``quantize``, as the reference takes
none. Its jitted padded-bucket tower and its power-of-two batch padding
are not carried over.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.benchmark import Timer
from ...core.device import select_device
from ...core.params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text
from ...image.resample import resize_bicubic
from ...runtime.generate import GenerateParams, Generator, clamp_new_tokens
from ...runtime.kv_cache import KVCache, bump_length, init_kv_cache
from ...runtime.slots import SlotRunner
from ..deepseek.engine import round_up
from ..gqa_decoder import embed_row
from ..gqa_mesh import MeshServing, dense_mesh
from .config import TOKEN_ASSISTANT, TOKEN_GMASK, TOKEN_NEWLINE, TOKEN_SOP, TOKEN_USER, GlmConfig
from .decoder import GlmDecoder, compute_glm_position_ids, fuse_glm_params
from .vision import GlmVisionTower

VISION_POOL = 32768  # patches a tower pass may take


def glm_smart_resize(height: int, width: int, factor: int, temporal: int, min_pixels: int,
                     max_pixels: int) -> Tuple[int, int]:
    """GLM's smart resize: a round-half initial snap to multiples of
    `factor`, the temporal frames weighting the pixel budget."""
    h, w = max(height, 1), max(width, 1)
    if h < factor or w < factor:
        scale = max(factor / h, factor / w)
        h, w = int(h * scale), int(w * scale)
    aspect = max(h, w) / min(h, w)
    if aspect > 200.0:
        raise ValueError(f"aspect ratio must be <= 200, got {aspect}")

    def round_mult(v):
        return max(int(round(v / factor)) * factor, factor)

    h_bar, w_bar = round_mult(h), round_mult(w)
    t_bar = max(int(round(temporal / temporal)) * temporal, temporal)
    if t_bar * h_bar * w_bar > max_pixels:
        beta = ((temporal * h * w) / max_pixels) ** 0.5
        h_bar = max(factor, (int(h / beta) // factor) * factor)
        w_bar = max(factor, (int(w / beta) // factor) * factor)
    elif t_bar * h_bar * w_bar < min_pixels:
        beta = (min_pixels / (temporal * h * w)) ** 0.5
        h_bar = -(-int(np.ceil(h * beta)) // factor) * factor
        w_bar = -(-int(np.ceil(w * beta)) // factor) * factor
    return max(h_bar, factor), max(w_bar, factor)


def glm_norm_table(cfg: GlmConfig) -> np.ndarray:
    """[3, 256] f32: entry [c, v] is ((v / 255 in f64, rounded to f32) −
    mean[c]) / std[c], the reference's per-value normalization."""
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    v = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
    return (v[None, :] - mean[:, None]) / std[:, None]


def preprocess_glm_image_raw(image: np.ndarray, cfg: GlmConfig) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """RGB uint8 → ([N, 3, p, p] uint8 patches in merge-window order,
    before normalization and the temporal duplication; grid (1, gh, gw))."""
    v = cfg.vision
    ps, merge = v.patch_size, v.spatial_merge_size
    h, w = image.shape[:2]
    rh, rw = glm_smart_resize(h, w, ps * merge, v.temporal_patch_size, cfg.min_pixels, cfg.max_pixels)
    if (rh, rw) != (h, w):
        image = resize_bicubic(image, rw, rh)
    gh, gw = rh // ps, rw // ps
    x = image.reshape(gh // merge, merge, ps, gw // merge, merge, ps, 3)
    x = x.transpose(0, 3, 1, 4, 6, 2, 5)  # [GH, GW, mh, mw, C, ps, ps]
    return x.reshape(gh * gw, 3, ps, ps), (1, gh, gw)


class GlmOcrModel(nn.Module):
    """All weights of one GLM-OCR model; state_dict names follow the
    reference's parameter tree (convert.params_from_jax), the decoder
    fused (fuse_glm_params)."""

    def __init__(self, cfg: GlmConfig, dtype, device):
        super().__init__()
        self.vision = GlmVisionTower(cfg.vision, torch.float32, device)
        self.decoder = GlmDecoder(cfg.text, dtype, device)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        self.vision.reset_(gen)
        self.decoder.reset_(gen)


class GlmOcrEngine(MeshServing):
    def __init__(
        self,
        cfg: GlmConfig,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        max_seq_len: int = 16384,
        seed: int = 0,
        kv_quant: Optional[str] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        mesh=None,
        ranks=None,
        state_fn=None,
    ):
        """Random weights from `seed` on the device (the tower in f32, as
        the reference's init), or `state` (params_from_jax of a reference
        engine, or loader.load_glm_params; fused here, the tower in f32
        either way). `device` None means the CUDA card. `mesh`, `ranks`
        and `state_fn` as PaddleOcrEngine's."""
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = select_device(device)
        ranks = self._start_mesh(dense_mesh(mesh, "GLM-OCR"), ranks, dict(
            cfg=cfg, dtype=dtype, max_seq_len=max_seq_len, seed=seed, kv_quant=kv_quant, state=state,
            state_fn=state_fn))
        if state_fn is not None:
            state = state_fn(self.device)
        self.kv_quant = kv_quant
        self.quantize = None
        self.max_seq_len = max_seq_len
        if state is not None:
            state = fuse_glm_params(state)
        self.model = GlmOcrModel(cfg, dtype, self.device)
        if state is None:
            self.model.reset_(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(state)
        self.model.eval()
        self.params = self.model.decoder  # what SlotRunner hands to slot_step_fn
        self._table = torch.from_numpy(glm_norm_table(cfg)).to(self.device)
        if self.mesh is not None:
            self._attach_mesh(ranks)

    # -- vision -----------------------------------------------------------------

    @torch.no_grad()
    def _vision_forward(self, u8_patches: np.ndarray, grids) -> torch.Tensor:
        """Packed uint8 patches [N, 3, p, p] of `grids` → merged tokens [N /
        merge², out_hidden]: normalized through the table and repeated over
        T on the device, then one tower pass."""
        n = u8_patches.shape[0]
        u8 = torch.from_numpy(u8_patches.reshape(n, 3, -1)).to(self.device).long()
        vals = self._table.reshape(-1)[u8 + torch.arange(3, device=self.device)[:, None] * 256]
        T = self.cfg.vision.temporal_patch_size
        patches = vals[:, :, None].expand(-1, -1, T, -1).reshape(n, -1).to(self.dtype)
        return self.model.vision(patches, grids)

    def encode_images(self, images: Sequence[np.ndarray]) -> Tuple[Optional[torch.Tensor], List[Tuple[int, int, int]]]:
        """Every image through tower passes of at most VISION_POOL
        patches, in order → (merged tokens of all images concatenated, or
        None without images; grids)."""
        prepared = [preprocess_glm_image_raw(np.asarray(image), self.cfg) for image in images]
        grids = [g for _, g in prepared]
        if not prepared:
            return None, grids
        parts, lo, rows = [], 0, 0
        for i, (patches, _) in enumerate(prepared):
            if rows and rows + patches.shape[0] > VISION_POOL:
                parts.append(self._vision_forward(np.concatenate([p for p, _ in prepared[lo:i]]), grids[lo:i]))
                lo, rows = i, 0
            rows += patches.shape[0]
        parts.append(self._vision_forward(np.concatenate([p for p, _ in prepared[lo:]]), grids[lo:]))
        return torch.cat(parts) if len(parts) > 1 else parts[0], grids

    # -- prompt -------------------------------------------------------------------

    def build_prompt_tokens(self, tokenizer, prompt: str,
                            grids: Sequence[Tuple[int, int, int]]) -> Tuple[List[int], List[int]]:
        """Token ids and image mask: the scaffold around the text segments,
        an image as its start id, one image token per merged patch and its
        end id."""
        cfg = self.cfg
        merge = cfg.vision.spatial_merge_size
        slots = prompt.count("<image>")
        if slots != len(grids):
            raise ValueError(f"prompt includes {slots} <image> placeholders but {len(grids)} images were provided")
        tokens = [TOKEN_GMASK, TOKEN_SOP, TOKEN_USER, TOKEN_NEWLINE]
        mask = [0, 0, 0, 0]
        for idx, segment in enumerate(prompt.split("<image>")):
            if segment:
                ids = tokenizer.encode(segment)
                tokens.extend(ids)
                mask.extend([0] * len(ids))
            if idx < len(grids):
                t, h, w = grids[idx]
                count = t * h * w // (merge * merge)
                tokens += [cfg.image_start_token_id] + [cfg.image_token_id] * count + [cfg.image_end_token_id]
                mask += [0] + [1] * count + [0]
        tokens += [TOKEN_ASSISTANT, TOKEN_NEWLINE]
        mask += [0, 0]
        return tokens, mask

    def position_ids(self, tokens, grids) -> Tuple[np.ndarray, int]:
        cfg = self.cfg
        return compute_glm_position_ids(cfg.image_token_id, cfg.video_start_token_id, cfg.video_end_token_id,
                                        tokens, grids, cfg.vision.spatial_merge_size)

    # -- prefill ------------------------------------------------------------------

    def new_kv_cache(self, batch: int, max_len: int) -> KVCache:
        t = self.cfg.text
        return init_kv_cache(t.num_hidden_layers, batch, t.num_key_value_heads, max_len, t.head_dim, t.head_dim,
                             self.dtype, self.device)

    def _row_positions(self, tokens, grids, s_pad: int):
        """One row right-padded to s_pad → (positions [3, s_pad] (padding
        at 1, as the reference's), next position base)."""
        pos_ids, next_base = self.position_ids(tokens, grids)
        positions = np.ones((3, s_pad), np.int64)
        positions[:, : len(tokens)] = pos_ids
        return positions, next_base

    @torch.no_grad()
    def _prefill_rows(self, rows) -> List[dict]:
        """rows = [(tokens, image_mask, grids, embeddings)] sharing one s_pad
        bucket → one join packet per row, from one batched prefill (on
        every rank under a mesh)."""
        s_pad = round_up(len(rows[0][0]), 128)
        inputs = [self._row_positions(t, g, s_pad) for t, _, g, _ in rows]
        packets = self._prefill_packets([r[0] for r in rows], [r[1] for r in rows], [r[3] for r in rows],
                                        np.stack([p for p, _ in inputs], axis=1), s_pad)  # [3, B, s_pad]
        for pkt, (_, base) in zip(packets, inputs):
            pkt["pos0"] = base
        return packets

    def prefill_for_slot(self, tokenizer, prompt, images, vision=None) -> dict:
        """Vision + scaffold prompt + one-row prefill → a join packet (pos0:
        the next position base)."""
        return self.prefill_for_slots(tokenizer, [(prompt, images, vision)])[0]

    def prefill_for_slots(self, tokenizer, requests) -> List[dict]:
        """Join packets for [(prompt, images, vision), ...]: every image of
        the wave through the tower (GLM's pixel budget is the config's, so
        requests never split by VisionSettings), then one batched prefill
        per group of rows sharing a 128-token bucket."""
        tower_t = Timer("slot.vision_towers")
        embeddings, grids = self.encode_images([img for _, images, _ in requests for img in images])
        tower_t.finish(images=len(grids))
        prefill_t = Timer("slot.prefill_rows")
        merge2 = self.cfg.vision.spatial_merge_size ** 2
        rows, at, cursor = [], 0, 0
        for prompt, images, _ in requests:
            mine = grids[at : at + len(images)]
            at += len(images)
            count = sum(t * h * w // merge2 for t, h, w in mine)
            emb = embeddings[cursor : cursor + count] if mine else None
            cursor += count
            tokens, mask = self.build_prompt_tokens(tokenizer, prompt, mine)
            rows.append((tokens, mask, mine, emb))
        buckets: Dict[int, List[int]] = {}
        for i, (tokens, _, _, _) in enumerate(rows):
            buckets.setdefault(round_up(len(tokens), 128), []).append(i)
        out: List[Optional[dict]] = [None] * len(rows)
        for idxs in buckets.values():
            for i, pkt in zip(idxs, self._prefill_rows([rows[i] for i in idxs])):
                out[i] = pkt
        prefill_t.finish(rows=len(out), waves=len(buckets))
        return out

    # -- continuous-batching (slot) surface -----------------------------------------

    def validate_slot_params(self, params: DecodeParameters) -> None:
        if params.do_sample or params.temperature != 0.0:
            raise ValueError("GLM backend requires greedy decoding (do_sample=false)")

    @staticmethod
    def step_positions(pos: torch.Tensor) -> torch.Tensor:
        """A step's position bases [B] → [3, B, 1]: all three axes advance
        together."""
        return pos[None, :, None].expand(3, -1, 1)

    def make_slot_runner(self) -> SlotRunner:
        return self._slot_runner(tuple(self.cfg.text.eos_token_ids), emit_eos=False)

    # -- single-request decode ----------------------------------------------------

    def _step_fn(self, decoder, token_ids, cache: KVCache, pos_state):
        """One token per row at cache.length, position base pos_state [B] →
        (logits, cache bumped by one, pos_state + 1)."""
        embeds = decoder.embed_tokens[token_ids][:, None, :].to(self.dtype)
        logits, cache = decoder(embeds, pos_state[None, :, None].expand(3, -1, 1), cache)
        return logits, bump_length(cache, 1), pos_state + 1

    @torch.no_grad()
    def decode(self, tokenizer, prompt: str, images: Sequence[np.ndarray], vision: VisionSettings,
               params: DecodeParameters, stream=None) -> DecodeOutcome:
        """One request, greedy: vision, the scaffold prompt, prefill to
        s_pad = round_up(len, 128) into a cache of the clamped budget, then
        generation until an EOS id is selected (never emitted). Under a
        mesh it runs on rank 0 alone (the module docstring)."""
        self.validate_slot_params(params)
        vtimer = Timer("vision.compute_embeddings")
        embeddings, grids = self.encode_images(images)
        vtimer.finish(images=len(images))
        tokens, image_mask = self.build_prompt_tokens(tokenizer, prompt, grids)
        prompt_len = len(tokens)
        s_pad = round_up(prompt_len, 128)
        max_new = clamp_new_tokens(s_pad, params.max_new_tokens, self.max_seq_len)
        max_len = min(self.max_seq_len, round_up(s_pad + max_new + 8, 128))
        positions, next_base = self._row_positions(tokens, grids, s_pad)
        embeds = embed_row(self.model.decoder, tokens, image_mask, embeddings, s_pad, self.dtype)
        pf_timer = Timer("decode.prefill")
        logits, cache = self.model.decoder(
            embeds[None], torch.from_numpy(positions).to(self.device)[:, None], self.new_kv_cache(1, max_len),
            last_index=torch.tensor([prompt_len - 1], device=self.device), flash_prefill=True)
        cache = bump_length(cache, prompt_len)
        pf_timer.finish(prompt_tokens=prompt_len)
        gen_params = GenerateParams(
            max_new_tokens=max_new, do_sample=False, temperature=0.0, top_p=params.top_p, top_k=params.top_k,
            repetition_penalty=params.repetition_penalty, no_repeat_ngram_size=params.no_repeat_ngram_size,
            eos_ids=tuple(self.cfg.text.eos_token_ids), emit_eos=False, chunk_size=16 if stream is not None else 64,
        )
        gtimer = Timer("decode.generate")
        result = Generator(self._step_fn, gen_params).generate(
            self.model.decoder, logits, cache, torch.tensor([next_base], device=self.device), [tokens],
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
