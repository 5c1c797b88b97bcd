"""PaddleOCR-VL's, DotsOCR's and GLM-OCR's operations under a mesh (the
mesh branches of dsocr_tpu/models/{paddleocr,dots,glm}/engine.py, and
dsocr_tpu/ops/linear.py:26-66's row-sharded packed matmuls).

The reference's rules for the dense decoders:

- params replicate: every rank builds the whole model, float or packed,
  from the same seed, ``state`` or ``state_fn``; no weight is split;
- dp: the slot cache's rows split over dp where dp divides the slot
  count (else they replicate, with parallel.mesh's one warning), and each
  rank steps only its rows, so its projections and packed row matmuls
  run on its share of the rows: the counterpart of ``quant_partition``'s
  row shard, with no global (the rank's rows are the shard). Rank 0
  gathers the logits;
- mp: the KV heads split over mp where mp divides them (else they
  replicate, with the warning). Each rank runs the replicated q/k/v
  projection, keeps its block of KV heads and the query heads that read
  them (``HeadShare``), writes and attends only those, and the attention
  outputs are gathered over its mp group before the replicated o_proj
  (models/gqa_decoder.py). Nothing is reduced, so each head's arithmetic
  is the single process's.

The operations (each ``op_*`` runs on every rank, parallel/runtime.py):

- ``alloc_slots`` (EngineMesh's): the slot cache by the rule above;
- ``prefill_packets``: the towers ran on rank 0 alone (the reference
  replicates them and shards nothing there); rank 0 broadcasts the
  wave's image embeddings, sends the rows' tokens and positions, and
  every rank prefills every row (rows replicate over dp, as in
  DeepSeek's mesh) on its heads, keeping its heads of each row's K/V
  under the packet's id for the join;
- ``slot_step``: the step's ids, M-RoPE bases (or positions) and lengths
  in one int64 tensor from rank 0; each rank steps its rows on its heads.

``engine.decode`` (one request) runs on rank 0 alone, with the whole
model it holds and the followers idle: the reference leaves that cache
unsharded (only its ``new_slot_cache`` places shardings). ``ep`` means
nothing to a family without routed experts: the reference ignores it,
and so does ``dense_mesh``, saying so once in the log.

``MeshServing`` is the engines' side: parallel/runtime.py's MeshHost
(rank processes started or joined, followers built through
``ranks.build``, ``alive``, ``close``) and the slot surface's mesh
branches.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import Mesh, parse_mesh_spec
from ..parallel.runtime import EngineMesh, MeshHost, MeshSlotRunner
from ..runtime.slots import SlotCache, SlotRunner, alloc_slot_cache
from .gqa_decoder import HeadShare, prefill_rows

logger = logging.getLogger("dsocr.mesh")
_warned_ep: set = set()


def dense_mesh(mesh, family: str) -> Optional[Mesh]:
    """The Mesh a dense family serves under: `mesh` (a spec, a Mesh or
    None) with ``ep`` dropped, as the reference ignores it, and said once."""
    mesh = parse_mesh_spec(mesh)
    if mesh is not None and mesh.ep:
        if family not in _warned_ep:
            _warned_ep.add(family)
            logger.warning("%s has no routed experts: ep is ignored (its mesh is dp=%d,mp=%d)",
                           family, mesh.dp, mesh.mp)
        mesh = dataclasses.replace(mesh, ep=False)
    return mesh


def head_share(mesh: Mesh, comm, num_heads: int, num_kv_heads: int) -> Optional[HeadShare]:
    """This rank's heads under `mesh`: KV heads over mp where mp divides
    them, with the query heads that read them; None where the heads
    replicate (mp 1, or an mp that does not divide them)."""
    if mesh.mp == 1 or num_kv_heads % mesh.mp:
        return None
    nkv = num_kv_heads // mesh.mp
    nq = nkv * (num_heads // num_kv_heads)
    return HeadShare(kv0=comm.m * nkv, nkv=nkv, q0=comm.m * nq, nq=nq, gather=comm.all_gather)


class GqaMesh(EngineMesh):
    """A dense engine's runtime under a mesh (the module docstring)."""

    def __init__(self, engine, ranks, comm):
        super().__init__(engine, ranks, comm)
        cfg = self.decoder.cfg
        self.share = head_share(comm.mesh, comm, cfg.num_attention_heads, self.decoder.n_kv)

    @property
    def decoder(self):
        return self.engine.model.decoder

    @property
    def hidden(self) -> int:
        return self.decoder.cfg.hidden_size

    def slot_layout(self):
        cfg, nkv = self.decoder.cfg, self.decoder.n_kv
        local = nkv if self.share is None else self.share.nkv
        return cfg.num_hidden_layers, nkv, local, cfg.head_dim, cfg.head_dim

    # -- prefill -------------------------------------------------------------------

    def prefill_packets(self, tokens: Sequence[Sequence[int]], masks: Sequence[Sequence[int]],
                        images: Sequence[Optional[torch.Tensor]], positions: np.ndarray, s_pad: int) -> List[dict]:
        """Join packets (prompt_ids, row_k, row_v of rank 0's heads, logits,
        mesh_id) of rows sharing one s_pad bucket: tokens, image masks,
        image embeddings [n, H] or None, positions in the decoder's
        layout."""
        mids = [self.new_id() for _ in tokens]
        kwargs = dict(mids=mids, tokens=[list(t) for t in tokens], masks=[list(m) for m in masks],
                      n_img=[0 if e is None else int(e.shape[0]) for e in images], positions=positions,
                      s_pad=s_pad)
        packets = self.call("prefill", kwargs, local=dict(images=self.images_of(images)))
        for pkt, mid in zip(packets, mids):
            self.track(pkt["row_k"], mid)
        return packets

    def op_prefill(self, mids, tokens, masks, n_img, positions, s_pad, images=None):
        imgs = self.recv_images(images, n_img)
        logits, k, v = prefill_rows(self.decoder, self.engine.dtype, tokens, masks, imgs, positions, s_pad,
                                    self.share)
        logits = self.gather_logits(logits, rows_split=False)
        out = []
        for i, (mid, toks) in enumerate(zip(mids, tokens)):
            row_k, row_v = k[:, i : i + 1], v[:, i : i + 1]
            if self.rank != 0:
                self.objects[mid] = (row_k, row_v)
            else:
                out.append(dict(prompt_ids=list(toks), row_k=row_k, row_v=row_v, logits=logits[i], mesh_id=mid))
        return out

    # -- decode steps ----------------------------------------------------------------

    def slot_step(self, token_ids: torch.Tensor, cache, pos: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot row → rank 0's logits [B, V]."""
        return self.step_call("slot_step", cache, token_ids, pos)

    def op_slot_step(self, cache, B: int, P: int, packed=None):
        cache = self.obj(cache)
        ids, pos, lengths, _ = self.recv_step(B, P, packed)
        rows = self.rows_of(cache)
        view = SlotCache(cache.k, cache.v, lengths[rows].contiguous(), cache.k_scale, cache.v_scale)
        logits = self.engine.local_slot_step(self.decoder, ids[rows], view, pos[rows], self.share)
        return self.gather_logits(logits, rows_split=cache.rows_split)


class MeshServing(MeshHost):
    """What PaddleOcrEngine, DotsOcrEngine and GlmOcrEngine share: the
    mesh's rank processes (MeshHost) and the slot surface, in one process
    or over the ranks. An engine gives ``step_positions`` (a step's per-row
    bases → the decoder's position ids) and calls ``_start_mesh`` before
    building its model and ``_attach_mesh`` after."""

    def _attach_mesh(self, ranks) -> None:
        from ..parallel.comm import Comm

        self.mesh_runtime = GqaMesh(self, ranks, Comm(self.mesh, ranks.rank))

    # -- the slot surface --------------------------------------------------------

    def new_slot_cache(self, n_slots: int, max_len: int) -> SlotCache:
        if self.mesh_runtime is not None:
            return self.mesh_runtime.alloc_slots(n_slots, max_len)
        dec = self.model.decoder
        cfg = dec.cfg
        return alloc_slot_cache(cfg.num_hidden_layers, n_slots, dec.n_kv, max_len, cfg.head_dim, cfg.head_dim,
                                self.dtype, self.kv_quant, self.device)

    def _slot_runner(self, eos_ids, emit_eos: bool) -> SlotRunner:
        if self.mesh_runtime is not None:
            return MeshSlotRunner(self.slot_step_fn, eos_ids=eos_ids, emit_eos=emit_eos, mesh=self.mesh_runtime)
        return SlotRunner(self.slot_step_fn, eos_ids=eos_ids, emit_eos=emit_eos)

    def slot_step_fn(self, decoder, token_ids, cache: SlotCache, pos):
        """Row r's token is written at cache.lengths[r] and attends [0,
        lengths[r]]; its position base is pos[r] (step_positions)."""
        if self.mesh_runtime is not None:
            return self.mesh_runtime.slot_step(token_ids, cache, pos)
        return self.local_slot_step(decoder, token_ids, cache, pos)

    def local_slot_step(self, decoder, token_ids, cache: SlotCache, pos, share: Optional[HeadShare] = None):
        """slot_step_fn on this process's rows and `share`'s heads."""
        embeds = decoder.embed_tokens[token_ids][:, None, :].to(self.dtype)
        return decoder.slot_step(embeds, self.step_positions(pos), cache, share=share)

    def _prefill_packets(self, tokens, masks, images, positions: np.ndarray, s_pad: int) -> List[dict]:
        """Join packets of one s_pad bucket's rows (GqaMesh.prefill_packets;
        in one process, one batched prefill here)."""
        if self.mesh_runtime is not None:
            return self.mesh_runtime.prefill_packets(tokens, masks, images, positions, s_pad)
        logits, k, v = prefill_rows(self.model.decoder, self.dtype, tokens, masks, images, positions, s_pad)
        return [dict(prompt_ids=list(t), row_k=k[:, i : i + 1], row_v=v[:, i : i + 1], logits=logits[i])
                for i, t in enumerate(tokens)]
