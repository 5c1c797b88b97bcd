"""Paged slot KV: a shared page pool behind the continuous-batching runtime
(dsocr_tpu/runtime/paged.py).

The contiguous SlotCache reserves a worst-case [S_max] row per slot; the
paged cache draws fixed-size pages from one pool ([L, P, H_kv, page, D]),
so a row holds pages only for its prompt and generation budget, and the
paged decode kernels (ops/kernels/paged_attention.py) read and write
through per-row page tables.

Allocation is on the host (PageAllocator, a refcounted LIFO free list):
rows join and leave between decode chunks, which is when pages are
granted and returned. A table entry of NO_PAGE (-1) is no page: a row
holds none until it joins and again from its release, and the decode step
writes nothing for such a row. (The reference leaves a released row's
table in place, so every idle row writes token 0 into page tables[r][0],
which a live row may own.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from .slots import SlotRunner, SlotState

NO_PAGE = -1


@dataclasses.dataclass
class PagedSlotCache:
    """Page pool, per-row page tables and logical lengths. With
    k_scale/v_scale set, k/v hold int8 codes and the scales one f32 per
    (layer, page, head, offset)."""

    k: torch.Tensor  # [L, P, H_kv, page, Dk] (model dtype, or int8 codes)
    v: torch.Tensor  # [L, P, H_kv, page, Dv]
    tables: torch.Tensor  # [B, P_max] int32 pool page ids, NO_PAGE where none
    lengths: torch.Tensor  # [B] int32
    k_scale: Optional[torch.Tensor] = None  # [L, P, H_kv, page] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_slots(self) -> int:
        return self.tables.shape[0]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        """A row's logical capacity: table capacity × page size."""
        return self.tables.shape[1] * self.k.shape[3]


class PageAllocator:
    """Host-side refcounted LIFO free list over pool page ids."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {n}, have {len(self._free)} of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: List[int]) -> List[int]:
        """Map the same physical pages into another table (refcount + 1)."""
        for p in pages:
            self._refs[p] += 1
        return pages

    def release(self, pages: List[int]) -> None:
        for p in pages:
            refs = self._refs.get(p, 0) - 1
            if refs <= 0:
                self._refs.pop(p, None)
                self._free.append(p)
            else:
                self._refs[p] = refs


def new_page_pool(n_layers: int, n_pages: int, n_kv_heads: int, head_dim: int, v_head_dim: int,
                  page_size: int, n_slots: int, table_capacity: int, dtype,
                  kv_quant: Optional[str], device) -> PagedSlotCache:
    """Zeroed pool, empty tables; kv_quant "int8" → int8 codes + f32 scale
    planes."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    quant = kv_quant == "int8"
    shape = (n_layers, n_pages, n_kv_heads, page_size)
    pool_dtype = torch.int8 if quant else dtype
    k = torch.zeros((*shape, head_dim), dtype=pool_dtype, device=device)
    v = torch.zeros((*shape, v_head_dim), dtype=pool_dtype, device=device)
    ks = vs = None
    if quant:
        ks = torch.zeros(shape, dtype=torch.float32, device=device)
        vs = torch.zeros(shape, dtype=torch.float32, device=device)
    tables = torch.full((n_slots, table_capacity), NO_PAGE, dtype=torch.int32, device=device)
    lengths = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return PagedSlotCache(k, v, tables, lengths, ks, vs)


class PagedSlotRunner(SlotRunner):
    """SlotRunner whose KV lives in a shared page pool.

    join() allocates ceil(max(s_pad, n + max_new) / page) pages, copies the
    prefilled row into them (quantized first for an int8 pool) and installs
    the row's table; join() and join_many() allocate every row's pages
    before they touch the state, so a pool that cannot hold them all raises
    MemoryError with the state and the free list unchanged, and any later
    failure gives the pages back and the rows as they were; release()
    returns the row's pages and leaves it holding none. The decode chunk is
    inherited: the decoder's slot step reads and writes through the tables.
    Not thread-safe, like SlotRunner."""

    def __init__(self, step_fn, *, eos_ids, allocator: PageAllocator):
        super().__init__(step_fn, eos_ids=eos_ids)
        self.allocator = allocator
        self._row_pages: Dict[int, List[int]] = {}

    def init_state(self, cache: PagedSlotCache, context_len: int) -> SlotState:
        cache.tables.fill_(NO_PAGE)
        return super().init_state(cache, context_len)

    def pages_needed(self, state: SlotState, pre: dict, max_new: int) -> int:
        """Pages for a packet's prompt block and generation budget."""
        cache = state.cache
        n, s_pad = len(pre["prompt_ids"]), pre["row_k"].shape[3]
        need = -(-max(s_pad, n + max(max_new, 0)) // cache.page_size)
        if need > cache.tables.shape[1]:
            raise ValueError(f"a row needs {need} pages but tables hold {cache.tables.shape[1]}")
        return need

    def _grant(self, state: SlotState, rows: Sequence[int], packets: Sequence[dict],
               max_news: Sequence[int]) -> None:
        """Allocate every row's pages, or none: on MemoryError the pages
        already taken go back in reverse, which restores the free list."""
        for row in rows:
            if row in self._row_pages:
                raise ValueError(f"slot {row} still holds pages: release it first")
        needs = [self.pages_needed(state, pre, m) for pre, m in zip(packets, max_news)]
        granted: List[List[int]] = []
        try:
            for need in needs:
                granted.append(self.allocator.alloc(need))
        except MemoryError:
            self._give_back(granted)
            raise
        self._row_pages.update(zip(rows, granted))

    def _give_back(self, granted: List[List[int]]) -> None:
        for pages in reversed(granted):
            self.allocator.release(pages[::-1])

    def _kv_blocks(self, cache: PagedSlotCache, row_k: torch.Tensor, row_v: torch.Tensor):
        """The prefilled row in the pool's page layout: [(pool, blocks [L,
        n_blk, H, page, ...])], zero past s_pad."""
        page = cache.page_size
        L, H, s_pad = row_k.shape[:3]
        n_blk = -(-s_pad // page)
        out = []
        for pool, x in super()._kv_blocks(cache, row_k, row_v):
            blocks = torch.zeros((L, H, n_blk * page, *x.shape[3:]), dtype=pool.dtype,
                                 device=pool.device)
            blocks[:, :, :s_pad] = x
            out.append((pool, blocks.reshape(L, H, n_blk, page, *x.shape[3:]).transpose(1, 2)))
        return out

    def _prepare(self, state: SlotState, row: int, pre: dict, params) -> dict:
        """The slot runner's inputs, and the row's page ids and table."""
        prep = super()._prepare(state, row, pre, params)
        cache = state.cache
        pages = self._row_pages[row]
        table = torch.full((cache.tables.shape[1],), NO_PAGE, dtype=torch.int32)
        table[: len(pages)] = torch.tensor(pages, dtype=torch.int32)
        n_blk = prep["kv"][0][1].shape[1]
        prep.update(ids=torch.tensor(pages[:n_blk], dtype=torch.long, device=cache.k.device),
                    table=table.to(cache.tables.device))
        return prep

    def _write_row_kv(self, cache: PagedSlotCache, row: int, prep: dict) -> None:
        for pool, blocks in prep["kv"]:
            pool[:, prep["ids"]] = blocks
        cache.tables[row] = prep["table"]

    def _row_tensors(self, state: SlotState) -> List[torch.Tensor]:
        return [*super()._row_tensors(state), state.cache.tables]

    def _free_row(self, state: SlotState, row: int) -> None:
        pages = self._row_pages.pop(row, None)
        if pages:
            self.allocator.release(pages)
        state.cache.tables[row] = NO_PAGE

    def _join_rows(self, state: SlotState, rows: Sequence[int], packets: Sequence[dict],
                   params_list: Sequence, max_news: Sequence[int],
                   firsts: Sequence[Optional[int]]):
        """Every row's pages first, or none; then the slot runner's all or
        nothing join, whose failure gives the pages back in reverse (the
        free list as it was). A row that finishes at once returns its
        pages."""
        for pre in packets:
            self._check_packet(state, pre)
        self._grant(state, rows, packets, max_news)
        try:
            state, finished, firsts_out = super()._join_rows(state, rows, packets, params_list,
                                                             max_news, firsts)
        except BaseException:
            self._give_back([self._row_pages.pop(row) for row in rows])
            raise
        for row, fin in zip(rows, finished):
            if fin:
                self._free_row(state, row)
        return state, finished, firsts_out

    def release_all_rows(self) -> None:
        """Return every row's pages to the pool. Device-fault recovery
        calls it: the rows that were live when a chunk failed never ran
        release(), and the state they were in is rebuilt (init_state
        empties the tables)."""
        for row in list(self._row_pages):
            self.allocator.release(self._row_pages.pop(row))

    @torch.no_grad()
    def release(self, state: SlotState, row: int) -> SlotState:
        self._free_row(state, row)
        return super().release(state, row)
