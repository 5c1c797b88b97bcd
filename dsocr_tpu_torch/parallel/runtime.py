"""SPMD runtime of a sharded engine: rank 0 calls, followers mirror.

Rank 0 runs the engine's whole serving path (scheduler, runner,
sampling, host preparation). Each operation on sharded device state is a
method ``op_<name>`` of the engine's runtime, a subclass of MeshRuntime:
rank 0's ``call(name, kwargs, local=..., per_rank=...)`` sends the name
and the keyword arguments (host values) to every follower, then runs the
same method itself with ``local`` (its own objects and device tensors)
merged in. Device tensors reach the followers inside the method, through
the collectives of parallel/comm.py. Objects that outlive a call — a slot
cache, a page pool, a prefilled row's K/V — are kept by the followers
under an id that rank 0 assigns (``new_id``); when rank 0's own object is
garbage-collected, the id is freed on every follower with the next call.

Calls are serialized on rank 0 (the scheduler prefills on one thread
while it decodes on another), so every rank sees them in one order. A
failure in a call tears every rank down (launch.Ranks.fail): a mesh
whose ranks disagree about what ran cannot go on, and every later call
raises MeshError (a server then loads the model anew: server/state.py).

The slot runners of a mesh (``MeshSlotRunner``, ``MeshPagedSlotRunner``)
differ from runtime/slots.py's and runtime/paged.py's only in how a join
writes a row's K/V: every rank writes its own shard of the row (rank 0's
packet names the followers' copies). Their public surface is the same,
and the scheduler cannot tell them apart. Lengths and page tables live
on rank 0 and reach the followers with each decode step.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch

from ..runtime.paged import PagedSlotCache, PagedSlotRunner
from .launch import MeshError
from ..runtime.slots import SlotCache, SlotRunner


@dataclasses.dataclass
class ShardedSlotCache(SlotCache):
    """Rank 0's slot cache under a mesh: k/v (and scales) hold this
    rank's heads and rows; ``lengths`` covers every slot, as the runner
    reads it."""

    mesh_id: int = -1
    slots: int = 0
    rows_split: bool = False

    @property
    def n_slots(self) -> int:
        return self.slots


@dataclasses.dataclass
class ShardedPagedCache(PagedSlotCache):
    """Rank 0's page pool under a mesh: this rank's heads of every page;
    tables and lengths whole."""

    mesh_id: int = -1


class _MeshJoin:
    """A join's K/V write goes to every rank (MeshRuntime.join)."""

    def __init__(self, *args, mesh: "MeshRuntime", **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh

    def _prepare(self, state, row, pre, params):
        prep = super()._prepare(state, row, pre, params)
        prep["mesh_id"] = pre["mesh_id"]
        return prep

    def _write_row_kv(self, cache, row, prep) -> None:
        self.mesh.join(cache, row, prep, lambda local_row: super(_MeshJoin, self)._write_row_kv(
            cache, local_row, prep))


class MeshSlotRunner(_MeshJoin, SlotRunner):
    pass


class MeshPagedSlotRunner(_MeshJoin, PagedSlotRunner):
    pass


class MeshRuntime:
    """The call/serve machinery; subclasses add the ``op_*`` methods."""

    def __init__(self, ranks, comm):
        self.ranks = ranks
        self.comm = comm
        self.rank = ranks.rank
        self.objects: Dict[int, Any] = {}  # followers: id → what rank 0's object stands for
        self._next_id = 0
        self._frees: List[int] = []
        self._lock = threading.Lock()
        # the scheduler prefills on one thread while another decodes: one
        # call at a time, so every rank sees the calls in one order
        self._call_lock = threading.RLock()

    # -- rank 0 ------------------------------------------------------------------

    def new_id(self, owner: Optional[object] = None) -> int:
        """A fresh object id; freed on the followers once `owner` (rank
        0's own object) is collected."""
        with self._lock:
            mid = self._next_id
            self._next_id += 1
        if owner is not None:
            self.track(owner, mid)
        return mid

    def track(self, owner: object, mid: int) -> None:
        weakref.finalize(owner, self._frees.append, mid)

    def call(self, op: str, kwargs: dict, local: Optional[dict] = None,
             per_rank: Optional[Dict[int, dict]] = None):
        """Run op_<op> on every rank (the module docstring) → rank 0's
        result."""
        with self._call_lock:
            if self.ranks.closed:
                raise MeshError("the mesh's ranks are down (an earlier failure or close)")
            frees = []
            while self._frees:  # pop is atomic: a finalizer may append meanwhile
                frees.append(self._frees.pop())
            try:
                self.ranks.send(("call", op, kwargs, frees), per_rank)
                return getattr(self, "op_" + op)(**{**kwargs, **(local or {})})
            except BaseException as err:
                self.ranks.fail(err)

    # -- followers ---------------------------------------------------------------

    def serve(self, op: str, kwargs: dict, frees) -> None:
        for mid in frees:
            self.objects.pop(mid, None)
        getattr(self, "op_" + op)(**kwargs)

    def obj(self, ref):
        """An op's object argument: rank 0 passes the object, followers
        its id."""
        return self.objects[ref] if isinstance(ref, int) else ref

    # -- what each rank counted ------------------------------------------------------

    STAT_KEYS = ("all_reduce", "broadcast", "gather")

    def stats(self, reset: bool = False) -> List[dict]:
        """Every rank's kernel launches (the wrappers' counters), device
        index, peak device MiB and collectives since the last reset, in
        rank order; `reset` zeroes them after reading."""
        return self.call("stats", dict(reset=reset))

    def op_stats(self, reset: bool):
        from ..ops.kernels import KERNELS, launch_counts, reset_launches

        names = [fn.__name__ for fn, _, _ in KERNELS]
        counts = launch_counts()
        dev = self.ranks.device
        cuda = dev.type == "cuda"
        row = ([counts[n] for n in names] + [dev.index if cuda else -1]
               + [torch.cuda.max_memory_allocated(dev) if cuda else 0]
               + [self.comm.calls.get(k, 0) for k in self.STAT_KEYS])
        pieces = self.comm.gather(torch.tensor(row, dtype=torch.int64, device=dev))
        if reset:
            reset_launches()
            self.comm.calls.clear()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
        if pieces is None:
            return None
        out = []
        for piece in pieces:
            vals = piece.tolist()
            n = len(names)
            out.append(dict(launches=dict(zip(names, vals[:n])), device_index=vals[n],
                            peak_mib=vals[n + 1] / 2 ** 20,
                            collectives=dict(zip(self.STAT_KEYS, vals[n + 2:]))))
        return out

    # -- the join ----------------------------------------------------------------

    def join(self, cache, row: int, prep: dict, write_local) -> None:
        """Write a joining row's K/V on every rank: rank 0 through the
        runner's own write (`write_local(local_row)`), followers from
        their copy of the packet."""
        pages = prep["ids"].tolist() if "ids" in prep else None
        self.call("join", dict(cache=cache.mesh_id, row=row, packet=prep["mesh_id"], pages=pages),
                  local=dict(cache=cache, write=write_local))

    def rows_of(self, cache) -> slice:
        """The slot rows this rank holds."""
        n = cache.tables.shape[0] if isinstance(cache, PagedSlotCache) else cache.slots
        if not getattr(cache, "rows_split", False):
            return slice(0, n)
        size = n // self.comm.mesh.dp
        return slice(self.comm.d * size, (self.comm.d + 1) * size)

    def op_join(self, cache, row: int, packet: int, pages, write=None) -> None:
        cache = self.obj(cache)
        rows = self.rows_of(cache)
        if not rows.start <= row < rows.stop:
            return
        if write is not None:
            write(row - rows.start)
            return
        row_k, row_v = self.objects[packet]
        paged = isinstance(cache, PagedSlotCache)
        helper = PagedSlotRunner(None, eos_ids=(), allocator=None) if paged else SlotRunner(None, eos_ids=())
        blocks = helper._kv_blocks(cache, row_k[:, 0], row_v[:, 0])
        if paged:
            ids = torch.tensor(pages[: blocks[0][1].shape[1]], dtype=torch.long, device=cache.k.device)
            for pool, block in blocks:
                pool[:, ids] = block
        else:
            for plane, block in blocks:
                plane[:, row - rows.start, :, : block.shape[2]] = block
