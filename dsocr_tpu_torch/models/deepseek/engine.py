"""DeepSeek-OCR engine (dsocr_tpu/models/deepseek/engine.py):
global-view letterbox + crop tiles → SAM → CLIP-on-SAM → projector with
newline/separator assembly → placeholder prompt (BOS = 0) → prefill →
decode.

Two surfaces are ported:

- single-request decode, ``decode`` (the reference's CLI path): prefill of
  the prompt into a contiguous KVCache, then runtime.generate's Generator
  over ``_step_fn``; ``use_cache=False`` recomputes the prefix every step
  (``_decode_without_cache``);
- continuous batching: prepare_vision_input, compute_image_embedding,
  build_prompt_tokens, slot_step_fn, new_slot_cache, make_slot_runner,
  the paged pair slot_step_fn_paged and make_paged_slot_runner (a shared
  KV page pool; no mesh branch), prefill_for_slot (with the continuation
  prefill, ``extra_tokens``) and prefill_for_slots, whose stages the
  bench recorder times under the reference's names (slot.prepare_inputs,
  slot.vision_towers, slot.prefill_rows).

The engine serves the decoder's fused layout: a split state (the
reference's init or loader layout) is fused at init, as the reference's
engine does without a mesh. ``quantize="q8_0"``, ``"q4_k"`` or
``"q6_k"`` serves packed decoder weights (models/deepseek/quantize.py),
packed on the device. Prefill attends through flash_prefill_attention
unless DSOCR_FLASH_PREFILL=0, the reference's switch. Views are batched
through the towers (4 global views or 16 tiles per call) the way the
reference batches them; the reference's host-link tricks (sparse or
content-only upload, a transfer pool, streamed prep), decode_batch and
the mesh path are not carried over.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.benchmark import Timer, get_recorder
from ...core.device import select_device
from ...core.params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text
from ...core.sampling import select_token_id_host
from ...image import PreprocessParams, build_global_view_with_box, dynamic_preprocess
from ...ops.rope import build_rope_tables
from ...runtime.generate import GenerateParams, Generator, clamp_new_tokens
from ...runtime.kv_cache import KVCache, bump_length, init_kv_cache
from ...runtime.paged import PageAllocator, PagedSlotCache, PagedSlotRunner, new_page_pool
from ...runtime.slots import SlotCache, SlotRunner, alloc_slot_cache
from .clip import ClipEncoder
from .config import DeepseekOcrConfig
from .decoder import DeepseekDecoder, fuse_decoder_params
from .fusion import (
    Projector,
    assemble_image_tokens,
    build_clip_sam_tokens,
    build_image_placeholders,
    format_global_tokens,
    format_local_tokens,
)
from .quantize import quantize_decoder_params
from .sam import SamEncoder


# views per tower call: 1024 global views (4096 SAM tokens) keep large
# activations, so few at a time; 640 tiles (1600 tokens) in larger chunks
GLOBAL_VIEWS_PER_CALL = 4
TILES_PER_CALL = 16


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class VisionInput:
    global_pixels: np.ndarray  # [1, 3, G, G] uint8
    patches: Optional[np.ndarray]  # [T, 3, I, I] uint8 or None
    crop_shape: Optional[Tuple[int, int]]  # (width_crops, height_crops)


class DeepseekOcrModel(nn.Module):
    """All weights of one DeepSeek-OCR v1 model; state_dict names follow
    the reference's parameter tree (see convert.params_from_jax)."""

    def __init__(self, cfg: DeepseekOcrConfig, dtype, device, quantize: Optional[str] = None):
        super().__init__()
        self.sam = SamEncoder(cfg.sam, dtype, device)
        self.clip = ClipEncoder(cfg.clip, dtype, device)
        self.projector = Projector(cfg, dtype, device)
        self.decoder = DeepseekDecoder(cfg.language, dtype, device, quantize)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        for part in (self.sam, self.clip, self.projector, self.decoder):
            part.reset_(gen)


class DeepseekOcrEngine:
    def __init__(
        self,
        cfg: DeepseekOcrConfig,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        max_seq_len: int = 8192,
        seed: int = 0,
        kv_quant: Optional[str] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        quantize: Optional[str] = None,
    ):
        """Random weights from `seed` on the device, or `state` (a
        state_dict, e.g. convert.params_from_jax of a reference engine or
        of a split decoder tree, which is fused here).

        quantize="q8_0", "q4_k" or "q6_k" packs the decoder's eligible
        weights (under a K-quant, those whose in dim misses 256 as Q8_0):
        random init
        draws each float weight on the device from the float model's
        seed and packs it there (one float weight alive at a time, so peak
        memory is not float plus packed); a `state` may hold packed
        entries (``.codes``/``.scales``, ``.mins`` for Q4_K, ``.highs``
        for Q6_K) or float ones, which are packed on load. `device` None means the CUDA card; the CPU
        runs only when asked for by name."""
        if cfg.variant != "ocr1" or cfg.clip is None:
            raise NotImplementedError("the port serves DeepSeek-OCR v1 (SAM + CLIP) only")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        if quantize not in (None, "q8_0", "q4_k", "q6_k"):
            raise ValueError(f"unsupported quantize {quantize!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = select_device(device)
        self.kv_quant = kv_quant
        self.quantize = quantize
        self.max_seq_len = max_seq_len
        self.model = DeepseekOcrModel(cfg, dtype, self.device, quantize)
        if state is None:
            self.model.reset_(torch.Generator(device=self.device).manual_seed(seed))
        else:
            state = fuse_decoder_params(state)
            if quantize:
                state = quantize_decoder_params(state, quantize)
            self.model.load_state_dict(state)
        self.model.eval()
        self.params = self.model.decoder  # what SlotRunner hands to slot_step_fn
        lang = cfg.language
        self._rope = build_rope_tables(max_seq_len, lang.rope_dim, lang.rope_theta, self.device)
        self._flash_prefill = os.environ.get("DSOCR_FLASH_PREFILL", "1") != "0"
        # seconds of each stage of the last decode() (the reference's Timer names)
        self.decode_stages: Dict[str, float] = {}

    # -- vision -----------------------------------------------------------------

    def prepare_vision_input(self, image: np.ndarray, vision) -> VisionInput:
        """Global letterboxed view (+ crop tiles in crop mode), uint8 CHW."""
        global_size = vision.base_size if vision.crop_mode else vision.image_size
        global_view, _ = build_global_view_with_box(image, global_size)
        patches, crop_shape = None, None
        if vision.crop_mode:
            result = dynamic_preprocess(image, PreprocessParams.ocr1(vision.base_size, vision.image_size))
            crop_shape = result.ratio
            if result.tiles:
                patches = np.stack([np.transpose(t, (2, 0, 1)) for t in result.tiles])
        return VisionInput(np.transpose(global_view, (2, 0, 1))[None], patches, crop_shape)

    @torch.no_grad()
    def _tower(self, pixels_u8: np.ndarray) -> torch.Tensor:
        """uint8 views [B, 3, S, S] → projected tokens [B, n, n_embed] f32."""
        u8 = torch.from_numpy(np.ascontiguousarray(pixels_u8)).to(self.device)
        pixels = (u8.float() / 255.0 - 0.5) / 0.5
        sam_out = self.model.sam(pixels)
        clip_out = self.model.clip(sam_out)
        return self.model.projector(build_clip_sam_tokens(clip_out, sam_out))

    def _towers_chunked(self, views: np.ndarray, chunk: int) -> torch.Tensor:
        return torch.cat([self._tower(views[i : i + chunk]) for i in range(0, len(views), chunk)])

    def _assemble(self, global_proj, local_proj, crop_shape) -> torch.Tensor:
        proj = self.model.projector
        global_tokens = format_global_tokens(global_proj.to(self.dtype), proj.image_newline)
        local_tokens = None
        if local_proj is not None:
            local_tokens = format_local_tokens(local_proj.to(self.dtype), crop_shape, proj.image_newline)
        return assemble_image_tokens(proj, global_tokens, local_tokens)

    @torch.no_grad()
    def compute_image_embedding(self, vin: VisionInput) -> torch.Tensor:
        """[n_tokens, n_embed] fused image tokens for one image."""
        return self._compute_image_embeddings_batched([vin])[0]

    @torch.no_grad()
    def _compute_image_embeddings_batched(self, vins: Sequence[VisionInput]) -> List[torch.Tensor]:
        """One embedding per image, the views of all images pooled through
        the towers in chunks."""
        if not vins:
            return []
        global_proj = self._towers_chunked(
            np.concatenate([v.global_pixels for v in vins]), GLOBAL_VIEWS_PER_CALL
        )
        tiles = [v.patches for v in vins if v.patches is not None]
        local_proj = (
            self._towers_chunked(np.concatenate(tiles), TILES_PER_CALL) if tiles else None
        )
        out, offset = [], 0
        for i, v in enumerate(vins):
            local = None
            if v.patches is not None:
                local = local_proj[offset : offset + len(v.patches)]
                offset += len(v.patches)
            out.append(self._assemble(global_proj[i : i + 1], local, v.crop_shape))
        return out

    # -- prompt -------------------------------------------------------------------

    def build_prompt_tokens(self, tokenizer, prompt: str, vision_inputs, embeddings, vision):
        """BOS = 0, text segments, one placeholder grid per image."""
        image_token_id = tokenizer.token_to_id("<image>")
        if image_token_id is None:
            raise ValueError("tokenizer missing <image> token")
        segments = prompt.split("<image>")
        if len(segments) - 1 != len(embeddings):
            raise ValueError(
                f"prompt/image embedding mismatch: {len(segments) - 1} slots "
                f"vs {len(embeddings)} embeddings"
            )
        tokens: List[int] = [0]
        mask: List[int] = [0]
        for idx, segment in enumerate(segments):
            ids = tokenizer.encode(segment)
            tokens.extend(ids)
            mask.extend([0] * len(ids))
            if idx < len(embeddings):
                placeholders = build_image_placeholders(
                    image_token_id, vision_inputs[idx].crop_shape, vision.base_size,
                    vision.image_size, vision.crop_mode,
                )
                if len(placeholders) != embeddings[idx].shape[0]:
                    raise ValueError(
                        f"placeholder count {len(placeholders)} does not match "
                        f"vision tokens {embeddings[idx].shape[0]}"
                    )
                tokens.extend(placeholders)
                mask.extend([1] * len(placeholders))
        return tokens, mask

    # -- continuous-batching (slot) surface -----------------------------------------

    def slot_step_fn(self, decoder, token_ids, cache: SlotCache, pos):
        """Row r's token is written at cache.lengths[r] and attends
        [0, lengths[r]]; its RoPE position is pos[r]."""
        embeds = decoder.embed_tokens[token_ids][:, None, :].to(self.dtype)
        return decoder.slot_step(embeds, pos[:, None], self._rope, cache)

    def new_slot_cache(self, n_slots: int, max_len: int) -> SlotCache:
        lang = self.cfg.language
        return alloc_slot_cache(
            lang.num_hidden_layers, n_slots, lang.resolved_kv_heads, max_len,
            lang.head_dim, lang.resolved_v_head_dim, self.dtype, self.kv_quant, self.device,
        )

    def make_slot_runner(self) -> SlotRunner:
        eos = self.cfg.language.eos_token_id
        return SlotRunner(self.slot_step_fn, eos_ids=(eos,) if eos is not None else ())

    # -- paged slot surface (a shared page pool instead of per-slot rows) -------

    # the decoder's slot step branches on the cache type, so the paged step
    # is the same function
    slot_step_fn_paged = slot_step_fn

    def make_paged_slot_runner(self, n_slots: int, max_len: int, page_size: Optional[int] = None,
                               n_pages: Optional[int] = None
                               ) -> Tuple[PagedSlotRunner, PagedSlotCache]:
        """(runner, cache) for paged continuous batching. The page size
        defaults to DSOCR_PAGE_SIZE (128), the pool to DSOCR_POOL_PAGES
        (n_slots × ceil(max_len / page), the worst case); a smaller pool
        holds fewer rows at once, and the allocator refuses a join that
        would not fit (MemoryError)."""
        lang = self.cfg.language
        page_size = page_size or int(os.environ.get("DSOCR_PAGE_SIZE", "128"))
        p_max = -(-max_len // page_size)
        n_pages = n_pages or int(os.environ.get("DSOCR_POOL_PAGES", str(n_slots * p_max)))
        cache = new_page_pool(
            lang.num_hidden_layers, n_pages, lang.resolved_kv_heads, lang.head_dim,
            lang.resolved_v_head_dim, page_size, n_slots, p_max, self.dtype, self.kv_quant,
            self.device,
        )
        eos = lang.eos_token_id
        runner = PagedSlotRunner(self.slot_step_fn_paged, eos_ids=(eos,) if eos is not None else (),
                                 allocator=PageAllocator(n_pages))
        return runner, cache

    def prefill_for_slot(self, tokenizer, prompt, images, vision, extra_tokens=None) -> dict:
        """Vision + prompt + one-row prefill → a join packet.

        ``extra_tokens`` (a continuation): tokens already generated for the
        request, appended after the prompt (image mask False), so that a
        request whose row was lost to a device fault can rejoin from its
        host-side record; the packet's logits then select the token after
        them (server/scheduler.py, _recover_device_failure)."""
        return self._prefill_wave(tokenizer, [(prompt, images, vision)], [extra_tokens])[0]

    def prefill_for_slots(self, tokenizer, requests) -> List[dict]:
        """Join packets for [(prompt, images, vision), ...]: host prep on a
        thread pool, towers batched across every image of the wave, then one
        batched prefill per group of rows sharing a 128-token bucket."""
        return self._prefill_wave(tokenizer, requests, [None] * len(requests))

    def _timed_sync(self, out: Optional[torch.Tensor]) -> None:
        """Wait for the device work behind `out` while a bench recorder is
        installed, so that the stage timer around it reads its end."""
        if out is not None and get_recorder() is not None:
            out.reshape(-1)[:1].cpu()

    def _prefill_wave(self, tokenizer, requests, extras) -> List[dict]:
        flat = [(ri, np.asarray(img)) for ri, (_, images, _) in enumerate(requests) for img in images]
        prep_t = Timer("slot.prepare_inputs")
        if len(flat) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(flat))) as pool:
                prepared = list(pool.map(
                    lambda item: self.prepare_vision_input(item[1], requests[item[0]][2]), flat
                ))
        else:
            prepared = [self.prepare_vision_input(img, requests[ri][2]) for ri, img in flat]
        prep_t.finish(images=len(flat))
        tower_t = Timer("slot.vision_towers")
        embeddings = self._compute_image_embeddings_batched(prepared)
        self._timed_sync(embeddings[-1] if embeddings else None)
        tower_t.finish(images=len(flat))
        per_req: List[Tuple[list, list]] = [([], []) for _ in requests]
        for (ri, _), vin, emb in zip(flat, prepared, embeddings):
            per_req[ri][0].append(vin)
            per_req[ri][1].append(emb)
        prefill_t = Timer("slot.prefill_rows")
        rows = []
        for ri, ((prompt, _, vision), extra) in enumerate(zip(requests, extras)):
            vins, embs = per_req[ri]
            tokens, mask = self.build_prompt_tokens(tokenizer, prompt, vins, embs, vision)
            if extra:
                tokens, mask = tokens + list(extra), mask + [0] * len(extra)
            rows.append((tokens, mask, embs))
        groups: Dict[int, List[int]] = {}
        for i, (tokens, _, _) in enumerate(rows):
            groups.setdefault(round_up(len(tokens), 128), []).append(i)
        out: List[Optional[dict]] = [None] * len(rows)
        for idxs in groups.values():
            for i, pkt in zip(idxs, self._prefill_rows([rows[i] for i in idxs])):
                out[i] = pkt
        self._timed_sync(out[-1]["logits"] if out else None)
        prefill_t.finish(rows=len(out), waves=len(groups))
        return out

    def _prefill_rows(self, rows) -> List[dict]:
        """rows = [(tokens, image_mask, embeddings)] sharing one s_pad
        bucket; right-padded to it (pad keys are causally unreachable from
        real queries, and decode overwrites their KV)."""
        s_pad = round_up(len(rows[0][0]), 128)
        embeds = torch.stack([self._row_embeds(t, m, e, s_pad) for t, m, e in rows])
        return self._prefill_packets([t for t, _, _ in rows], embeds)

    # -- single-request decode ----------------------------------------------------

    def new_kv_cache(self, batch: int, max_len: int) -> KVCache:
        lang = self.cfg.language
        return init_kv_cache(lang.num_hidden_layers, batch, lang.resolved_kv_heads, max_len,
                             lang.head_dim, lang.resolved_v_head_dim, self.dtype, self.device)

    @torch.no_grad()
    def _row_embeds(self, tokens, image_mask, embeddings, s_pad: int) -> torch.Tensor:
        """[s_pad, H]: the tokens' embeddings, zero-token padded, with the
        image embeddings at the mask's positions (a context longer than
        the mask is text past it)."""
        padded = np.zeros(s_pad, np.int64)
        padded[: len(tokens)] = tokens
        out = self.model.decoder.embed_tokens[torch.from_numpy(padded).to(self.device)].to(self.dtype)
        if embeddings:
            idx = np.nonzero(np.asarray(image_mask, bool))[0]
            out[torch.from_numpy(idx).to(self.device)] = torch.cat(embeddings).to(self.dtype)
        return out

    @torch.no_grad()
    def _prefill(self, embeds: torch.Tensor, cache: KVCache, true_lens: torch.Tensor):
        """Rows [B, s_pad, H] from position 0 into `cache` → (logits [B, V]
        at each row's last true token, cache; its length not bumped)."""
        B, s_pad, _ = embeds.shape
        positions = torch.arange(s_pad, device=self.device)[None].expand(B, s_pad)
        return self.model.decoder(embeds, positions, cache, self._rope, last_index=true_lens - 1,
                                  flash_prefill=self._flash_prefill)

    def _prefill_packets(self, token_lists, embeds: torch.Tensor) -> List[dict]:
        """One join packet per row of embeds [B, s_pad, H]: a prefill into a
        fresh cache of s_pad positions."""
        B, s_pad, _ = embeds.shape
        lens = torch.tensor([len(t) for t in token_lists], device=self.device)
        logits, cache = self._prefill(embeds, self.new_kv_cache(B, s_pad), lens)
        return [
            dict(prompt_ids=list(toks), row_k=cache.k[:, i : i + 1], row_v=cache.v[:, i : i + 1],
                 logits=logits[i], pos0=len(toks))
            for i, toks in enumerate(token_lists)
        ]

    def _prefill_single(self, tokens, embeds: torch.Tensor) -> dict:
        """The join packet of one row, embeds [s_pad, H]."""
        return self._prefill_packets([tokens], embeds[None])[0]

    def _step_fn(self, decoder, token_ids, cache: KVCache, pos_state):
        """One token per row at position cache.length → (logits, cache
        bumped by one, pos_state)."""
        embeds = decoder.embed_tokens[token_ids][:, None, :].to(self.dtype)
        positions = torch.full((token_ids.shape[0], 1), cache.length, device=token_ids.device)
        logits, cache = decoder(embeds, positions, cache, self._rope)
        return logits, bump_length(cache, 1), pos_state

    def _stage(self, name: str, t0: float, sync: Optional[torch.Tensor] = None) -> float:
        """Record the seconds since t0 under `name` (after reading `sync`
        back, so the device work is done); → now."""
        if sync is not None:
            sync.reshape(-1)[:1].cpu()
        now = time.perf_counter()
        self.decode_stages[name] = now - t0
        return now

    @torch.no_grad()
    def decode(self, tokenizer, prompt: str, images: Sequence[np.ndarray], vision: VisionSettings,
               params: DecodeParameters, stream=None) -> DecodeOutcome:
        """One request: vision, prompt, prefill to s_pad = round_up(len,
        128) into a cache of the clamped budget, then greedy or sampled
        generation (EOS never emitted). ``stream(steps, tokens)`` gets the
        tokens after every 16-step chunk. ``decode_stages`` keeps the
        seconds of each stage."""
        self.decode_stages = {}
        t0 = time.perf_counter()
        vision_inputs = [self.prepare_vision_input(np.asarray(img), vision) for img in images]
        t0 = self._stage("vision.prepare_inputs", t0)
        embeddings = self._compute_image_embeddings_batched(vision_inputs)
        t0 = self._stage("vision.compute_embeddings", t0, embeddings[0] if embeddings else None)
        tokens, image_mask = self.build_prompt_tokens(tokenizer, prompt, vision_inputs, embeddings,
                                                      vision)
        prompt_len = len(tokens)

        def build_embeds(context, s_pad):
            return self._row_embeds(context, image_mask, embeddings, s_pad)

        if not params.use_cache:
            return self._decode_without_cache(tokenizer, tokens, build_embeds, params, stream)
        s_pad = round_up(prompt_len, 128)
        max_new = clamp_new_tokens(s_pad, params.max_new_tokens, self.max_seq_len)
        max_len = min(self.max_seq_len, round_up(s_pad + max_new + 8, 128))
        t0 = time.perf_counter()
        logits, cache = self._prefill(build_embeds(tokens, s_pad)[None], self.new_kv_cache(1, max_len),
                                      torch.tensor([prompt_len], device=self.device))
        cache = bump_length(cache, prompt_len)
        t0 = self._stage("decode.prefill", t0, logits)
        eos = self.cfg.language.eos_token_id
        gen_params = GenerateParams(
            max_new_tokens=max_new, do_sample=params.do_sample, temperature=params.temperature,
            top_p=params.top_p, top_k=params.top_k, repetition_penalty=params.repetition_penalty,
            no_repeat_ngram_size=params.no_repeat_ngram_size,
            eos_ids=(eos,) if eos is not None else (), emit_eos=False,
            chunk_size=16 if stream is not None else 64,
        )
        result = Generator(self._step_fn, gen_params).generate(
            self.model.decoder, logits, cache, None, [tokens],
            generator=torch.Generator(device=self.device).manual_seed(params.seed or 0),
            stream_callback=stream,
        )
        self._stage("decode.generate", t0)
        self.decode_stages["decode.steps"] = result.steps
        generated = result.tokens[0]
        return DecodeOutcome(
            text=normalize_text(tokenizer.decode(generated, skip_special_tokens=True)),
            prompt_tokens=prompt_len, response_tokens=len(generated), generated_tokens=generated,
            truncated=max_new < params.max_new_tokens,
        )

    def _decode_without_cache(self, tokenizer, tokens, embeds_fn, params: DecodeParameters,
                              stream) -> DecodeOutcome:
        """The debug path: recompute the whole prefix every step, the
        selection on the host (the reference's generate_without_cache)."""
        context = list(tokens)
        generated: List[int] = []
        rng = np.random.default_rng(params.seed or 0)
        eos = self.cfg.language.eos_token_id
        for _ in range(params.max_new_tokens):
            pre = self._prefill_single(context, embeds_fn(context, round_up(len(context), 128)))
            current = select_token_id_host(pre["logits"].float().cpu().numpy(), params, context, rng)
            if eos is not None and current == eos:
                break
            context.append(current)
            generated.append(current)
            if stream is not None:
                stream(len(generated), generated)
        return DecodeOutcome(
            text=normalize_text(tokenizer.decode(generated, skip_special_tokens=True)),
            prompt_tokens=len(tokens), response_tokens=len(generated), generated_tokens=generated,
        )
