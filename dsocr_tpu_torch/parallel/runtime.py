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

``EngineMesh`` holds what every family's runtime shares: the slot cache
allocated by the sharding rule (rows over dp, KV heads over mp), the
decode step's one int64 tensor of ids, positions, lengths (and page
tables) broadcast from rank 0, the logits gathered back to rank 0, and
the image embeddings of a prefill wave broadcast from rank 0 (whose
towers made them) and split by row. models/deepseek/mesh.py and
models/gqa_mesh.py add each family's operations.

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
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..runtime.paged import PagedSlotCache, PagedSlotRunner
from ..runtime.slots import SlotCache, SlotRunner, alloc_slot_cache
from .comm import join_gathered
from .launch import MeshError
from .mesh import slot_cache_sharding


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

    STAT_KEYS = ("all_reduce", "all_gather", "broadcast", "gather")

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


class EngineMesh(MeshRuntime):
    """The runtime of one engine under a mesh (the module docstring):
    what every family shares. A subclass names the decoder's slot-cache
    layout (``slot_layout``), whether its logits split the vocabulary
    (``vocab_split``) and adds its ``op_*`` methods."""

    def __init__(self, engine, ranks, comm):
        super().__init__(ranks, comm)
        self.engine = engine

    @property
    def mesh(self):
        return self.comm.mesh

    @property
    def vocab_split(self) -> bool:
        return False

    @property
    def hidden(self) -> int:
        """The width of an image embedding row."""
        raise NotImplementedError

    def slot_layout(self) -> Tuple[int, int, int, int, int]:
        """(layers, KV heads of the whole model, KV heads this rank holds,
        K head dim, V head dim)."""
        raise NotImplementedError

    def _recv(self, t: Optional[torch.Tensor], shape, dtype) -> torch.Tensor:
        """Rank 0's `t`, broadcast; followers pass None."""
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=self.engine.device)
        return self.comm.broadcast(t)

    def gather_logits(self, logits: torch.Tensor, rows_split: bool) -> Optional[torch.Tensor]:
        """Each rank's logits [rows, vocab shard] → the whole [B, V] on rank
        0 (None elsewhere); no collective where rank 0 holds them whole."""
        if not self.vocab_split and not (rows_split and self.mesh.dp > 1):
            return logits if self.rank == 0 else None
        pieces = self.comm.gather(logits.float())
        if pieces is None:
            return None
        return join_gathered(pieces, self.mesh, rows_split and self.mesh.dp > 1, self.vocab_split)

    # -- slot caches -----------------------------------------------------------------

    def alloc_slots(self, n_slots: int, max_len: int) -> ShardedSlotCache:
        mid = self.new_id()
        cache = self.call("alloc_slots", dict(mid=mid, n_slots=n_slots, max_len=max_len))
        self.track(cache, mid)
        return cache

    def op_alloc_slots(self, mid: int, n_slots: int, max_len: int):
        eng = self.engine
        layers, whole, local, dk, dv = self.slot_layout()
        spec = slot_cache_sharding(self.mesh, whole, n_slots)
        rows_split = spec[1] == "dp" and self.mesh.dp > 1
        own = alloc_slot_cache(layers, n_slots // self.mesh.dp if rows_split else n_slots, local, max_len,
                               dk, dv, eng.dtype, eng.kv_quant, eng.device)
        lengths = torch.zeros((n_slots,), dtype=torch.int32, device=eng.device)
        cache = ShardedSlotCache(own.k, own.v, lengths, own.k_scale, own.v_scale, mesh_id=mid,
                                 slots=n_slots, rows_split=rows_split)
        if self.rank != 0:
            self.objects[mid] = cache
        return cache

    def cache_shapes(self, cache) -> List[dict]:
        """Every rank's k/v (and scale) plane shapes of `cache`, in rank
        order: the share each holds."""
        return self.call("cache_shapes", dict(cache=cache.mesh_id), local=dict(cache=cache))

    def op_cache_shapes(self, cache):
        cache = self.obj(cache)
        planes = {"k": cache.k, "v": cache.v, "k_scale": cache.k_scale, "v_scale": cache.v_scale}
        planes = {n: p for n, p in planes.items() if p is not None}
        dims = [list(p.shape) + [0] * (5 - p.dim()) for p in planes.values()]
        pieces = self.comm.gather(torch.tensor(dims, dtype=torch.int64, device=self.engine.device))
        if pieces is None:
            return None
        return [{n: tuple(d[: p.dim()]) for (n, p), d in zip(planes.items(), piece.tolist())} for piece in pieces]

    # -- what rank 0 sends with each step and prefill ---------------------------------

    def step_call(self, op: str, cache, token_ids: torch.Tensor, pos: torch.Tensor,
                  tables: Optional[torch.Tensor] = None):
        """Run op_<op>(cache, B, P, packed) on every rank: the step's token
        ids, positions, lengths (and page tables) in one int64 tensor."""
        parts = [token_ids, pos, cache.lengths] + ([tables.reshape(-1)] if tables is not None else [])
        packed = torch.cat([p.to(torch.int64) for p in parts])
        P = tables.shape[1] if tables is not None else 0
        return self.call(op, dict(cache=cache.mesh_id, B=token_ids.shape[0], P=P),
                         local=dict(cache=cache, packed=packed))

    def recv_step(self, B: int, P: int, packed: Optional[torch.Tensor]):
        """step_call's tensor on every rank → (ids, pos, lengths int32,
        tables int32 or None)."""
        buf = self._recv(packed, (3 * B + B * P,), torch.int64)
        ids, pos, lengths = buf[:B], buf[B : 2 * B], buf[2 * B : 3 * B].to(torch.int32)
        tables = buf[3 * B :].reshape(B, P).to(torch.int32) if P else None
        return ids, pos, lengths, tables

    def images_of(self, embeddings: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        """Rank 0: every row's image embeddings [n_i, hidden] (or None) as
        one tensor in the model dtype, to broadcast."""
        embs = [e for e in embeddings if e is not None and e.shape[0]]
        return torch.cat(embs).to(self.engine.dtype) if embs else None

    def recv_images(self, images: Optional[torch.Tensor], counts: Sequence[int]) -> List[Optional[torch.Tensor]]:
        """images_of's tensor on every rank, split into rows of `counts`
        image tokens (None for a row without)."""
        total = sum(counts)
        img = self._recv(images, (total, self.hidden), self.engine.dtype) if total else None
        rows, off = [], 0
        for n in counts:
            rows.append(img[off : off + n] if n else None)
            off += n
        return rows


class MeshHost:
    """The engine's side of a mesh: the rank processes started (and owned)
    or joined, the followers told to build the same engine, ``alive`` and
    ``close``. An engine calls ``_start_mesh`` before building its model
    and sets ``mesh_runtime`` once it has."""

    mesh = None
    mesh_runtime: Optional[MeshRuntime] = None
    _owned_ranks = None

    def _start_mesh(self, mesh, ranks, build: dict):
        """The running ranks of `mesh` (started here and owned when `ranks`
        is None; None without a mesh); rank 0 tells the followers to build
        ``type(self)(**build, mesh=mesh)``, any ``state`` in it as CPU
        tensors (a snapshot's payloads included)."""
        self.mesh = mesh
        if mesh is None:
            return None
        if ranks is None:
            from . import launch

            ranks = self._owned_ranks = launch.start(mesh.size, self.device)
            weakref.finalize(self, ranks.kill)  # an engine dropped unclosed, or failing below
        if ranks.world != mesh.size:
            raise ValueError(f"mesh {mesh.dp}x{mesh.mp} needs {mesh.size} ranks, not {ranks.world}")
        if ranks.is_leader:
            ranks.build(type(self), dict(build, state=host_state(build.get("state")), mesh=mesh))
        return ranks

    @property
    def alive(self) -> bool:
        """False once a mesh engine's ranks are down (a failed call, a
        hung rank, close): it cannot serve again, and a server loads the
        model anew (server/state.py)."""
        return self.mesh_runtime is None or not self.mesh_runtime.ranks.closed

    def close(self) -> None:
        """Stop the rank processes this engine started (a mesh engine)."""
        if self._owned_ranks is not None:
            ranks, self._owned_ranks = self._owned_ranks, None
            ranks.close()


def host_state(state):
    """`state` with every tensor on the CPU, nested dicts and lists (a
    snapshot's payloads) included: what a follower is sent."""
    if torch.is_tensor(state):
        return state.cpu()
    if isinstance(state, dict):
        return {k: host_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(host_state(v) for v in state)
    return state
