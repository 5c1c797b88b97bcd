"""DeepSeek-OCR engine, serving slice (dsocr_tpu/models/deepseek/engine.py):
global-view letterbox + crop tiles → SAM → CLIP-on-SAM → projector with
newline/separator assembly → placeholder prompt (BOS = 0) → prefill of
the prompt rows → slot decode under runtime.slots.SlotRunner.

Only the continuous-batching surface is ported: prepare_vision_input,
compute_image_embedding, build_prompt_tokens, slot_step_fn,
new_slot_cache, make_slot_runner, the paged pair slot_step_fn_paged and
make_paged_slot_runner (a shared KV page pool; no mesh branch),
prefill_for_slot and prefill_for_slots. ``quantize="q8_0"``, ``"q4_k"`` or ``"q6_k"`` serves
packed decoder weights (models/deepseek/quantize.py), packed on the device. Views are
batched through the towers (4 global views or 16 tiles per call) the way
the reference batches them; the reference's host-link tricks (sparse or
content-only upload, a transfer pool, streamed prep) are not carried
over.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.device import select_device
from ...image import PreprocessParams, build_global_view_with_box, dynamic_preprocess
from ...ops.rope import build_rope_tables
from ...runtime.paged import PageAllocator, PagedSlotCache, PagedSlotRunner, new_page_pool
from ...runtime.slots import SlotCache, SlotRunner, alloc_slot_cache
from .clip import ClipEncoder
from .config import DeepseekOcrConfig
from .decoder import DeepseekDecoder
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
        state_dict, e.g. convert.params_from_jax of a reference engine).

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
            if quantize:
                state = quantize_decoder_params(state, quantize)
            self.model.load_state_dict(state)
        self.model.eval()
        self.params = self.model.decoder  # what SlotRunner hands to slot_step_fn
        lang = cfg.language
        self._rope = build_rope_tables(max_seq_len, lang.rope_dim, lang.rope_theta, self.device)

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

    def prefill_for_slot(self, tokenizer, prompt, images, vision) -> dict:
        """Vision + prompt + one-row prefill → a join packet."""
        return self.prefill_for_slots(tokenizer, [(prompt, images, vision)])[0]

    def prefill_for_slots(self, tokenizer, requests) -> List[dict]:
        """Join packets for [(prompt, images, vision), ...]: host prep on a
        thread pool, towers batched across every image of the wave, then one
        batched prefill per group of rows sharing a 128-token bucket."""
        flat = [(ri, np.asarray(img)) for ri, (_, images, _) in enumerate(requests) for img in images]
        if len(flat) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(flat))) as pool:
                prepared = list(pool.map(
                    lambda item: self.prepare_vision_input(item[1], requests[item[0]][2]), flat
                ))
        else:
            prepared = [self.prepare_vision_input(img, requests[ri][2]) for ri, img in flat]
        embeddings = self._compute_image_embeddings_batched(prepared)
        per_req: List[Tuple[list, list]] = [([], []) for _ in requests]
        for (ri, _), vin, emb in zip(flat, prepared, embeddings):
            per_req[ri][0].append(vin)
            per_req[ri][1].append(emb)
        rows = []
        for ri, (prompt, _, vision) in enumerate(requests):
            vins, embs = per_req[ri]
            tokens, mask = self.build_prompt_tokens(tokenizer, prompt, vins, embs, vision)
            rows.append((tokens, mask, embs))
        groups: Dict[int, List[int]] = {}
        for i, (tokens, _, _) in enumerate(rows):
            groups.setdefault(round_up(len(tokens), 128), []).append(i)
        out: List[Optional[dict]] = [None] * len(rows)
        for idxs in groups.values():
            for i, pkt in zip(idxs, self._prefill_rows([rows[i] for i in idxs])):
                out[i] = pkt
        return out

    @torch.no_grad()
    def _prefill_rows(self, rows) -> List[dict]:
        """rows = [(tokens, image_mask, embeddings)] sharing one s_pad
        bucket; right-padded to it (pad keys are causally unreachable from
        real queries, and decode overwrites their KV)."""
        s_pad = round_up(len(rows[0][0]), 128)
        B = len(rows)
        tokens = np.zeros((B, s_pad), np.int64)
        for r, (toks, _, _) in enumerate(rows):
            tokens[r, : len(toks)] = toks
        decoder = self.model.decoder
        embeds = decoder.embed_tokens[torch.from_numpy(tokens).to(self.device)].to(self.dtype)
        for r, (_, mask, embs) in enumerate(rows):
            if embs:
                idx = torch.from_numpy(np.nonzero(np.asarray(mask, bool))[0]).to(self.device)
                embeds[r, idx] = torch.cat(embs).to(self.dtype)
        positions = torch.arange(s_pad, device=self.device)[None].expand(B, s_pad)
        true_lens = torch.tensor([len(t) for t, _, _ in rows], device=self.device)
        logits, k, v = decoder.prefill(embeds, positions, self._rope, last_index=true_lens - 1)
        return [
            dict(prompt_ids=list(toks), row_k=k[:, i : i + 1], row_v=v[:, i : i + 1],
                 logits=logits[i], pos0=len(toks))
            for i, (toks, _, _) in enumerate(rows)
        ]
