"""DeepSeek-OCR's operations under a mesh (dsocr_tpu/models/deepseek/engine.py
:637-700, :1132-1180, :1245-1270, :1472-1485).

Each ``op_*`` runs on every rank (parallel/runtime.py): rank 0's engine
calls the public methods here, which send the call on and run it.

- ``towers``: a chunk of views padded to a multiple of the world size,
  each rank's share through the replicated SAM/CLIP/projector (or the
  OCR2 encoder), the outputs gathered to rank 0;
- ``alloc_slots`` / ``alloc_pool``: the slot cache (rows over dp where dp
  divides the slot count, heads over mp where the decoder's attention
  splits) or the page pool (heads only);
- ``prefill_packets``: rank 0 broadcasts the wave's image embeddings;
  each rank embeds the tokens (a vocab shard's masked lookup and sum),
  prefills every row (rows replicate over dp, as a row packet does in
  the reference) and keeps its heads of each row's K/V under the
  packet's id; the logits are gathered to rank 0;
- ``slot_step``: rank 0 broadcasts the step's token ids, positions,
  lengths and page tables in one int64 tensor; each rank steps its rows
  (its dp share when the cache splits rows) and the logits are gathered
  to rank 0, where the runner samples;
- ``prefill_kv`` / ``kv_step``: single-request decode over a contiguous
  KVCache sharded by heads (rows replicate: one row), the length a host
  int sent with each step.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...parallel.runtime import EngineMesh, ShardedPagedCache
from ...runtime.kv_cache import KVCache
from ...runtime.paged import new_page_pool
from ...runtime.slots import SlotCache


class DeepseekMesh(EngineMesh):
    @property
    def decoder(self):
        return self.engine.model.decoder

    @property
    def vocab_split(self) -> bool:
        return self.decoder.shard.vocab_split

    @property
    def hidden(self) -> int:
        return self.engine.cfg.language.hidden_size

    def slot_layout(self):
        lang = self.engine.cfg.language
        return (lang.num_hidden_layers, lang.resolved_kv_heads, self.decoder.n_kv_heads, lang.head_dim,
                lang.resolved_v_head_dim)

    # -- towers ------------------------------------------------------------------

    def towers(self, fn: str, views: np.ndarray) -> torch.Tensor:
        """uint8 views [n, 3, S, S] through engine.`fn` split over every
        rank → rank 0's [n, ...] outputs."""
        n, world = len(views), self.mesh.size
        per = -(-n // world)
        padded = np.zeros((per * world, *views.shape[1:]), views.dtype)
        padded[:n] = views
        shares = {r: dict(views=padded[r * per : (r + 1) * per]) for r in range(1, world)}
        out = self.call("towers", dict(fn=fn), local=dict(views=padded[:per]), per_rank=shares)
        return out[:n]

    def op_towers(self, fn: str, views: np.ndarray):
        pieces = self.comm.gather(getattr(self.engine, fn)(views))
        return None if pieces is None else torch.cat(pieces)

    # -- page pools -----------------------------------------------------------------

    def alloc_pool(self, n_pages: int, page_size: int, n_slots: int, p_max: int) -> ShardedPagedCache:
        mid = self.new_id()
        cache = self.call("alloc_pool", dict(mid=mid, n_pages=n_pages, page_size=page_size,
                                             n_slots=n_slots, p_max=p_max))
        self.track(cache, mid)
        return cache

    def op_alloc_pool(self, mid: int, n_pages: int, page_size: int, n_slots: int, p_max: int):
        lang = self.engine.cfg.language
        pool = new_page_pool(
            lang.num_hidden_layers, n_pages, self.decoder.n_kv_heads, lang.head_dim,
            lang.resolved_v_head_dim, page_size, n_slots, p_max, self.engine.dtype, self.engine.kv_quant,
            self.engine.device,
        )
        cache = ShardedPagedCache(pool.k, pool.v, pool.tables, pool.lengths, pool.k_scale, pool.v_scale,
                                  mesh_id=mid)
        if self.rank != 0:
            self.objects[mid] = cache
        return cache

    # -- prefill -------------------------------------------------------------------

    def _images(self, rows) -> Optional[torch.Tensor]:
        return self.images_of([e for _, _, row_embs in rows for e in row_embs])

    def _rows(self, tokens, masks, n_img, images):
        """(tokens, mask, [image embeddings]) rows from the broadcast
        images, split by each row's image-token count."""
        return [(t, m, [] if img is None else [img])
                for t, m, img in zip(tokens, masks, self.recv_images(images, n_img))]

    def prefill_packets(self, rows) -> List[dict]:
        """Join packets of rows [(tokens, mask, embeddings)] sharing one
        s_pad bucket (engine._prefill_rows)."""
        mids = [self.new_id() for _ in rows]
        kwargs = dict(mids=mids, tokens=[list(t) for t, _, _ in rows], masks=[list(m) for _, m, _ in rows],
                      n_img=[sum(e.shape[0] for e in embs) for _, _, embs in rows],
                      s_pad=-(-len(rows[0][0]) // 128) * 128)
        packets = self.call("prefill", kwargs, local=dict(images=self._images(rows)))
        for pkt, mid in zip(packets, mids):
            self.track(pkt["row_k"], mid)
        return packets

    def op_prefill(self, mids, tokens, masks, n_img, s_pad, images=None):
        eng = self.engine
        rows = self._rows(tokens, masks, n_img, images)
        embeds = eng._embeds_rows(rows, s_pad)
        B = embeds.shape[0]
        lens = torch.tensor([len(t) for t in tokens], device=eng.device)
        logits, cache = eng._prefill(embeds, eng.new_kv_cache(B, s_pad), lens)
        logits = self.gather_logits(logits, rows_split=False)
        out = []
        for i, (mid, toks) in enumerate(zip(mids, tokens)):
            row_k, row_v = cache.k[:, i : i + 1], cache.v[:, i : i + 1]
            if self.rank != 0:
                self.objects[mid] = (row_k, row_v)
            else:
                out.append(dict(prompt_ids=list(toks), row_k=row_k, row_v=row_v, logits=logits[i],
                                pos0=len(toks), mesh_id=mid))
        return out

    def prefill_kv(self, tokens, mask, embeddings, s_pad: int, max_len: int):
        """One request's prefill into a fresh sharded KVCache of max_len →
        (logits [1, V], rank 0's cache; its length not bumped)."""
        mid = self.new_id()
        rows = [(tokens, mask, embeddings)]
        kwargs = dict(mid=mid, tokens=list(tokens), mask=list(mask),
                      n_img=sum(e.shape[0] for e in embeddings), s_pad=s_pad, max_len=max_len)
        logits, cache = self.call("prefill_kv", kwargs, local=dict(images=self._images(rows)))
        self.track(cache.k, mid)
        return logits, cache._replace(mesh_id=mid)

    def op_prefill_kv(self, mid, tokens, mask, n_img, s_pad, max_len, images=None):
        eng = self.engine
        rows = self._rows([tokens], [mask], [n_img], images)
        logits, cache = eng._prefill(eng._embeds_rows(rows, s_pad), eng.new_kv_cache(1, max_len),
                                     torch.tensor([len(tokens)], device=eng.device))
        if self.rank != 0:
            self.objects[mid] = cache
        return self.gather_logits(logits, rows_split=False), cache

    # -- decode steps ----------------------------------------------------------------

    def slot_step(self, token_ids: torch.Tensor, cache, pos: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot row → rank 0's logits [B, V]."""
        paged = isinstance(cache, ShardedPagedCache)
        return self.step_call("slot_step", cache, token_ids, pos, cache.tables if paged else None)

    def op_slot_step(self, cache, B: int, P: int, packed=None):
        eng = self.engine
        cache = self.obj(cache)
        ids, pos, lengths, tables = self.recv_step(B, P, packed)
        if P:
            view = ShardedPagedCache(cache.k, cache.v, tables, lengths, cache.k_scale, cache.v_scale)
            rows = slice(0, B)
        else:
            rows = self.rows_of(cache)
            view = SlotCache(cache.k, cache.v, lengths[rows].contiguous(), cache.k_scale, cache.v_scale)
        embeds = self.decoder.embed(ids[rows])[:, None, :].to(eng.dtype)
        logits = self.decoder.slot_step(embeds, pos[rows][:, None], eng._rope, view)
        return self.gather_logits(logits, rows_split=not P and cache.rows_split)

    def kv_step(self, token_ids: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One token per row at position cache.length → rank 0's logits."""
        return self.call("kv_step", dict(cache=cache.mesh_id, length=cache.length, B=token_ids.shape[0]),
                         local=dict(cache=cache, ids=token_ids.to(torch.int64)))

    def op_kv_step(self, cache, length: int, B: int, ids=None):
        eng = self.engine
        cache = self.obj(cache)._replace(length=length)
        ids = self._recv(ids, (B,), torch.int64)
        embeds = self.decoder.embed(ids)[:, None, :].to(eng.dtype)
        positions = torch.full((B, 1), length, device=ids.device)
        logits, _ = self.decoder(embeds, positions, cache, eng._rope)
        return self.gather_logits(logits, rows_split=False)

