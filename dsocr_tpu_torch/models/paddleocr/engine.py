"""PaddleOCR-VL engine (dsocr_tpu/models/paddleocr/engine.py): smart-resize
→ SigLIP → mlp_AR projector → prompt with placeholders → Ernie prefill
→ decode.

Surfaces, as the reference's:

- ``decode``: one request, prefill into a contiguous KVCache, then
  runtime.generate's Generator (EOS appended, then stop);
- the slot surface for ``ContinuousScheduler``: ``slot_step_fn``,
  ``new_slot_cache``, ``make_slot_runner`` (``emit_eos=True``),
  ``prefill_for_slot`` and ``prefill_for_slots``. A row's M-RoPE position
  base travels as the runner's per-row ``pos`` (the join packet's
  ``pos0`` = prompt length + the image's delta), advanced by one a step.
  There is no paged runner, as the reference has none for this family.

``mesh="dp=N,mp=M"`` serves the slot surface over dp × mp rank processes
by the reference's rules (models/gqa_mesh.py): params replicated, slot
rows over dp (the packed row matmuls on each rank's rows), Ernie's KV
heads over mp, the towers and ``decode`` on rank 0 alone.

``prefill_for_slots`` pools a wave's pages by smart-resize grid: every
page of one grid goes through the tower in one batch (SiglipTower's
blocked attention bounds its scores), then each group of rows sharing a
128-token bucket prefills in one batched pass, right-padded, through
``flash_prefill_attention``. Patches travel to the device as uint8 and
are normalized there through the per-channel table (smart_resize.norm_table,
bit-exact with normalizing on the host). The power-of-two batch padding
of the reference's compiled passes and decode without the cache (which
it refuses too) are not carried over.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core.benchmark import Timer
from ...core.device import select_device
from ...core.params import DecodeOutcome, DecodeParameters, VisionSettings, normalize_text
from ...image.smart_resize import ImagePatches, SmartResizeConfig, norm_table, preprocess_patches_raw
from ...runtime.generate import GenerateParams, Generator, clamp_new_tokens
from ...runtime.kv_cache import KVCache, bump_length, init_kv_cache
from ...runtime.slots import SlotRunner
from ..deepseek.engine import RAW_QUANT_KEY, round_up
from ..gqa_decoder import embed_row, fuse_gqa_params
from ..gqa_mesh import MeshServing, dense_mesh
from .config import PaddleConfig
from .decoder import ErnieDecoder, compute_position_ids
from .projector import PaddleProjector
from .quantize import quantize_ernie_params
from .vision import SiglipTower


@dataclasses.dataclass
class ProjectedImage:
    embeddings: torch.Tensor  # [n_tokens, hidden]
    original_grid: Tuple[int, int, int]
    merged_grid: Tuple[int, int, int]

    @property
    def token_count(self) -> int:
        return int(np.prod(self.merged_grid))


class PaddleOcrModel(nn.Module):
    """All weights of one PaddleOCR-VL model; state_dict names follow the
    reference's parameter tree (convert.params_from_jax)."""

    def __init__(self, cfg: PaddleConfig, dtype, device, quantize: Optional[str] = None, vision_dtype=None):
        super().__init__()
        self.vision = SiglipTower(cfg.vision_config, vision_dtype or dtype, device)
        self.projector = PaddleProjector(cfg, dtype, device)
        self.decoder = ErnieDecoder(cfg, dtype, device, quantize)

    @torch.no_grad()
    def reset_(self, gen: torch.Generator) -> None:
        for part in (self.vision, self.projector, self.decoder):
            part.reset_(gen)


class PaddleOcrEngine(MeshServing):
    def __init__(
        self,
        cfg: PaddleConfig,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        max_seq_len: int = 4096,
        seed: int = 0,
        kv_quant: Optional[str] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        quantize: Optional[str] = None,
        mesh=None,
        ranks=None,
        state_fn=None,
    ):
        """Random weights from `seed` on the device, or `state`
        (params_from_jax of a reference engine, or loader.load_paddle_params;
        a split decoder is fused here). The tower holds the model dtype at
        random init (the reference's init) and the state's dtype otherwise
        (f32 from the loader, as the reference loads it). quantize "q8_0", "q4_k" or "q6_k" packs the decoder's
        linears (quantize.py). `device` None means the CUDA card.

        `mesh` (a spec "dp=N,mp=M" or a parallel.mesh.Mesh) serves over
        rank processes (the module docstring); `ranks` are running ranks
        (parallel.launch.start), else this engine starts and owns its own
        (``close`` stops them); `state_fn(device)` makes the state on
        each rank instead of `state`."""
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        if quantize not in (None, "q8_0", "q4_k", "q6_k"):
            raise ValueError(f"unsupported quantize {quantize!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = select_device(device)
        ranks = self._start_mesh(dense_mesh(mesh, "PaddleOCR-VL"), ranks, dict(
            cfg=cfg, dtype=dtype, max_seq_len=max_seq_len, seed=seed, kv_quant=kv_quant, state=state,
            quantize=quantize, state_fn=state_fn))
        if state_fn is not None:
            state = state_fn(self.device)
        self.kv_quant = kv_quant
        self.quantize = quantize
        self.max_seq_len = max_seq_len
        self._flash_prefill = os.environ.get("DSOCR_FLASH_PREFILL", "1") != "0"
        vision_dtype = None
        if state is not None:
            state = dict(state)
            raw = state.pop(RAW_QUANT_KEY, None)
            vision_dtype = state["vision.patch_embed.w"].dtype
            state = fuse_gqa_params(state)
            if quantize:
                state = quantize_ernie_params(state, quantize, raw=raw)
        self.model = PaddleOcrModel(cfg, dtype, self.device, quantize, vision_dtype)
        if state is None:
            self.model.reset_(torch.Generator(device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(state)
        self.model.eval()
        self.params = self.model.decoder  # what SlotRunner hands to slot_step_fn
        self._table = torch.from_numpy(norm_table(SmartResizeConfig())).to(self.device)
        if self.mesh is not None:
            self._attach_mesh(ranks)

    # -- vision -----------------------------------------------------------------

    def _prep(self, vision: VisionSettings) -> SmartResizeConfig:
        v = self.cfg.vision_config
        return SmartResizeConfig(patch_size=v.patch_size,
                                 merge_size=v.spatial_merge_size).with_max_image_size(vision.image_size)

    def preprocess(self, image: np.ndarray, vision: VisionSettings) -> ImagePatches:
        """Smart-resized raw uint8 patches and their ids (host)."""
        return preprocess_patches_raw(np.asarray(image), self._prep(vision))

    @torch.no_grad()
    def _encode_group(self, group: Sequence[ImagePatches]) -> torch.Tensor:
        """Pages of one grid → projected tokens [B, n, hidden]: uint8
        patches normalized on the device through the table, then the tower
        and the projector in one batch."""
        grid = group[0].grid_thw
        u8 = torch.from_numpy(np.stack([p.patches for p in group])).to(self.device).long()
        channel = torch.arange(3, device=self.device)[:, None, None] * 256
        patches = self._table.reshape(-1)[u8 + channel].to(self.dtype)
        ids = [torch.from_numpy(getattr(group[0], name)).to(self.device) for name in ("height_ids", "width_ids")]
        feats = self.model.vision(patches, grid, *ids, use_rope=self.cfg.use_3d_rope)
        return self.model.projector(feats, grid)

    def _projected(self, patches: ImagePatches, embeddings: torch.Tensor) -> ProjectedImage:
        t, gh, gw = patches.grid_thw
        merge = self.cfg.vision_config.spatial_merge_size
        return ProjectedImage(embeddings, (t, gh, gw), (t, gh // merge, gw // merge))

    def encode_image(self, image: np.ndarray, vision: VisionSettings) -> ProjectedImage:
        patches = self.preprocess(image, vision)
        return self._projected(patches, self._encode_group([patches])[0])

    def encode_images(self, prepared: Sequence[ImagePatches]) -> List[ProjectedImage]:
        """Every page, pooled by grid into one tower batch a grid."""
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        for i, p in enumerate(prepared):
            groups.setdefault(p.grid_thw, []).append(i)
        out: List[Optional[ProjectedImage]] = [None] * len(prepared)
        for idxs in groups.values():
            embeds = self._encode_group([prepared[i] for i in idxs])
            for b, i in enumerate(idxs):
                out[i] = self._projected(prepared[i], embeds[b])
        return out

    # -- prompt -------------------------------------------------------------------

    def build_prompt_tokens(self, tokenizer, prompt: str,
                            grids: Sequence[Tuple[int, int, int]]) -> Tuple[List[int], List[int]]:
        """Token ids and image mask: BOS, the text segments, and per image
        <vision_start>, one image token per merged patch and
        <|IMAGE_END|> where the tokenizer has it."""
        cfg = self.cfg
        merge = cfg.vision_config.spatial_merge_size
        vision_end_id = tokenizer.token_to_id("<|IMAGE_END|>")
        segments = prompt.split("<image>")
        if len(segments) - 1 != len(grids):
            raise ValueError(f"prompt/image mismatch: {len(segments) - 1} slots vs {len(grids)} grids")
        tokens: List[int] = []
        mask: List[int] = []
        if cfg.bos_token_id is not None:
            tokens.append(cfg.bos_token_id)
            mask.append(0)
        for idx, segment in enumerate(segments):
            if segment:
                ids = tokenizer.encode(segment)
                tokens.extend(ids)
                mask.extend([0] * len(ids))
            if idx < len(grids):
                t, h, w = grids[idx]
                n = t * (h // merge) * (w // merge)
                tokens += [cfg.vision_start_token_id] + [cfg.image_token_id] * n
                mask += [0] + [1] * n
                if vision_end_id is not None:
                    tokens.append(vision_end_id)
                    mask.append(0)
        return tokens, mask

    # -- prefill ------------------------------------------------------------------

    def new_kv_cache(self, batch: int, max_len: int) -> KVCache:
        cfg = self.cfg
        return init_kv_cache(cfg.num_hidden_layers, batch, cfg.resolved_num_key_value_heads, max_len,
                             cfg.head_dim, cfg.head_dim, self.dtype, self.device)

    def _row_positions(self, tokens, projected: Sequence[ProjectedImage], s_pad: int):
        """One row right-padded to s_pad → (positions [3, s_pad] (padding
        at 1, as the reference's), delta)."""
        pos_ids, delta = compute_position_ids(self.cfg, tokens, [p.original_grid for p in projected])
        positions = np.ones((3, s_pad), np.int64)
        positions[:, : len(tokens)] = pos_ids
        return positions, delta

    @staticmethod
    def _images(projected: Sequence[ProjectedImage]) -> Optional[torch.Tensor]:
        return torch.cat([p.embeddings for p in projected]) if projected else None

    @torch.no_grad()
    def _prefill_rows(self, rows) -> List[dict]:
        """rows = [(tokens, image_mask, projected)] sharing one s_pad
        bucket → one join packet per row, from one batched prefill (on
        every rank under a mesh)."""
        s_pad = round_up(len(rows[0][0]), 128)
        inputs = [self._row_positions(t, p, s_pad) for t, _, p in rows]
        packets = self._prefill_packets([t for t, _, _ in rows], [m for _, m, _ in rows],
                                        [self._images(p) for _, _, p in rows],
                                        np.stack([p for p, _ in inputs], axis=1), s_pad)  # [3, B, s_pad]
        for pkt, (tokens, _, _), (_, delta) in zip(packets, rows, inputs):
            pkt["pos0"] = len(tokens) + delta
        return packets

    def prefill_for_slot(self, tokenizer, prompt, images, vision) -> dict:
        """Vision + prompt + one-row prefill → a join packet (pos0: the
        next M-RoPE position base)."""
        return self.prefill_for_slots(tokenizer, [(prompt, images, vision)])[0]

    def prefill_for_slots(self, tokenizer, requests) -> List[dict]:
        """Join packets for [(prompt, images, vision), ...]: pages pooled by
        grid through the tower, then one batched prefill per group of rows
        sharing a 128-token bucket."""
        prep_t = Timer("slot.prepare_inputs")
        prepared = [[self.preprocess(img, vision) for img in images] for _, images, vision in requests]
        prep_t.finish(images=sum(map(len, prepared)))
        tower_t = Timer("slot.vision_towers")
        flat = self.encode_images([p for plist in prepared for p in plist])
        tower_t.finish(images=len(flat))
        prefill_t = Timer("slot.prefill_rows")
        rows, at = [], 0
        for (prompt, images, _), plist in zip(requests, prepared):
            projected = flat[at : at + len(plist)]
            at += len(plist)
            tokens, mask = self.build_prompt_tokens(tokenizer, prompt, [p.original_grid for p in projected])
            rows.append((tokens, mask, projected))
        groups: Dict[int, List[int]] = {}
        for i, (tokens, _, _) in enumerate(rows):
            groups.setdefault(round_up(len(tokens), 128), []).append(i)
        out: List[Optional[dict]] = [None] * len(rows)
        for idxs in groups.values():
            for i, pkt in zip(idxs, self._prefill_rows([rows[i] for i in idxs])):
                out[i] = pkt
        prefill_t.finish(rows=len(out), waves=len(groups))
        return out

    # -- continuous-batching (slot) surface -----------------------------------------

    @staticmethod
    def step_positions(pos: torch.Tensor) -> torch.Tensor:
        """A step's M-RoPE bases [B] → positions [3, B, 1]: all three axes
        advance together."""
        return pos[None, :, None].expand(3, -1, 1)

    def make_slot_runner(self) -> SlotRunner:
        eos = self.cfg.eos_token_id
        return self._slot_runner((eos,) if eos is not None else (), emit_eos=True)

    # -- single-request decode ----------------------------------------------------

    def _step_fn(self, decoder, token_ids, cache: KVCache, pos_state):
        """One token per row at cache.length, M-RoPE base pos_state [B] →
        (logits, cache bumped by one, pos_state + 1)."""
        embeds = decoder.embed_tokens[token_ids][:, None, :].to(self.dtype)
        positions = pos_state[None, :, None].expand(3, -1, 1)
        logits, cache = decoder(embeds, positions, cache)
        return logits, bump_length(cache, 1), pos_state + 1

    @torch.no_grad()
    def decode(self, tokenizer, prompt: str, images: Sequence[np.ndarray], vision: VisionSettings,
               params: DecodeParameters, stream=None) -> DecodeOutcome:
        """One request: vision, prompt, prefill to s_pad = round_up(len,
        128) into a cache of the clamped budget, then greedy or sampled
        generation; EOS is appended, then generation stops. Under a mesh
        it runs on rank 0 alone (the module docstring)."""
        if not params.use_cache:
            raise ValueError("PaddleOCR decoder requires use_cache=true")
        vtimer = Timer("vision.compute_embeddings")
        projected = self.encode_images([self.preprocess(img, vision) for img in images])
        vtimer.finish(images=len(images))
        tokens, image_mask = self.build_prompt_tokens(tokenizer, prompt, [p.original_grid for p in projected])
        if sum(image_mask) != sum(p.token_count for p in projected):
            raise ValueError("image placeholder span mismatches projector outputs")
        prompt_len = len(tokens)
        s_pad = round_up(prompt_len, 128)
        max_new = clamp_new_tokens(s_pad, params.max_new_tokens, self.max_seq_len)
        max_len = round_up(min(self.max_seq_len, s_pad + max_new + 8), 128)
        positions, delta = self._row_positions(tokens, projected, s_pad)
        embeds = embed_row(self.model.decoder, tokens, image_mask, self._images(projected), s_pad, self.dtype)
        pf_timer = Timer("decode.prefill")
        logits, cache = self.model.decoder(
            embeds[None], torch.from_numpy(positions).to(self.device)[:, None], self.new_kv_cache(1, max_len),
            last_index=torch.tensor([prompt_len - 1], device=self.device), flash_prefill=self._flash_prefill)
        cache = bump_length(cache, prompt_len)
        pf_timer.finish(prompt_tokens=prompt_len)
        eos = self.cfg.eos_token_id
        gen_params = GenerateParams(
            max_new_tokens=max_new, do_sample=params.do_sample, temperature=params.temperature,
            top_p=params.top_p, top_k=params.top_k, repetition_penalty=params.repetition_penalty,
            no_repeat_ngram_size=params.no_repeat_ngram_size,
            eos_ids=(eos,) if eos is not None else (), emit_eos=True,
            chunk_size=16 if stream is not None else 64,
        )
        gtimer = Timer("decode.generate")
        result = Generator(self._step_fn, gen_params).generate(
            self.model.decoder, logits, cache,
            torch.tensor([prompt_len + delta], device=self.device), [tokens],
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
