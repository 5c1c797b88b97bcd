"""Rank processes: rank 0 is the calling process, followers are spawned.

``start(world, device)`` spawns world − 1 follower processes with the
``spawn`` start method (a fresh interpreter: never a fork of a process
that has CUDA or another runtime started), joins them into one
torch.distributed process group over a free local port, and returns the
leader's ``Ranks``. Follower r takes ``cuda:(r % device_count)`` (or the
CPU); one that finds no GPU when the leader runs on one raises. The
backend is chosen by topology (comm.choose_backend) and logged.

Rank 0 talks to each follower over a duplex pipe: ``build`` (a factory
and its keyword arguments: the follower builds its object, an engine,
with ``ranks=`` its own ``Ranks``, in place of the one before),
``call`` (a method of that object's ``mesh_runtime``, with keyword
arguments) and ``stop``. A
follower that raises sends its traceback back and exits; rank 0's next
collective then fails, and ``Ranks.fail`` tears every rank down and
raises ``MeshError`` naming the rank. Idle followers wait on their pipe,
not in a collective, so the process group's timeout (comm.TIMEOUT_S)
bounds only collectives.

``deadline`` (seconds; ``Ranks.set_deadline`` re-arms it) bounds the
ranks' life: past it a watchdog kills every follower still alive, which
fails rank 0's pending collective, and the error names the ranks that
hung. ``close`` stops the
followers, joins each with a timeout, kills the ones that do not exit
and raises naming them.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import multiprocessing as mp
import os
import socket
import sys
import threading
import time
import traceback
import types
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from . import comm

logger = logging.getLogger("dsocr.mesh")

# seconds a follower gets to reach the process group or to exit
JOIN_TIMEOUT_S = 60.0


class MeshError(RuntimeError):
    """A rank of the mesh failed or hung; the mesh is torn down."""


@contextlib.contextmanager
def _main_hidden():
    """Keep spawn from re-running the caller's __main__ in each follower
    (a script without a ``__name__`` guard would start its own ranks
    there): the follower's target and factories live in this package."""
    main = sys.modules.get("__main__")
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """One rank's view of the rank processes: ``rank``, ``world``,
    ``device``, ``backend``; on rank 0 the followers' pipes and
    processes."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        self.procs: List[Any] = []
        self.conns: List[Any] = []
        self.closed = False
        self._hung: List[int] = []
        self._watchdog: Optional[threading.Timer] = None

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    # -- leader ------------------------------------------------------------------

    def send(self, message, per_rank: Optional[Dict[int, dict]] = None) -> None:
        """The same message to every follower; `per_rank` {rank: extra
        kwargs} merged into a call's kwargs for that rank."""
        for r, conn in enumerate(self.conns, start=1):
            msg = message
            if per_rank and r in per_rank:
                kind, op, kwargs, frees = message
                msg = (kind, op, {**kwargs, **per_rank[r]}, frees)
            conn.send(msg)

    def build(self, factory: Callable, kwargs: dict) -> None:
        self.send(("build", factory, kwargs, ()))

    def _follower_errors(self, wait_s: float = 2.0) -> List[str]:
        errors = []
        deadline = time.monotonic() + wait_s
        for r, conn in enumerate(self.conns, start=1):
            try:
                while conn.poll(max(0.0, deadline - time.monotonic())):
                    msg = conn.recv()
                    if msg[0] == "error":
                        errors.append(f"rank {msg[1]} raised:\n{msg[2]}")
                        break
            except (EOFError, OSError):
                pass
        return errors

    def fail(self, err: BaseException):
        """Tear every rank down after `err` on rank 0 and raise MeshError
        with what the followers reported (or the ranks that hung)."""
        if isinstance(err, MeshError):
            raise err
        errors = self._follower_errors()
        hung = list(self._hung)
        self.kill()
        if hung:
            raise MeshError(f"the mesh's deadline passed; rank(s) {hung} hung") from err
        if errors:
            raise MeshError("\n".join(errors)) from err
        raise MeshError(f"rank 0 raised {type(err).__name__}: {err}; every rank torn down") from err

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)
        self._finish()

    def _finish(self) -> None:
        if self._watchdog is not None:
            self._watchdog.cancel()
        if self.closed:
            return
        self.closed = True
        if dist.is_initialized():
            dist.destroy_process_group()
        for conn in self.conns:
            conn.close()

    def set_deadline(self, seconds: Optional[float]) -> None:
        """(Re)arm the watchdog `seconds` from now; None disarms it."""
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None
        if seconds is not None and not self.closed:
            self._watchdog = threading.Timer(seconds, self._expire)
            self._watchdog.daemon = True
            self._watchdog.start()

    def _expire(self) -> None:
        self._hung = [r for r, p in enumerate(self.procs, start=1) if p.is_alive()]
        logger.error("mesh deadline passed; killing ranks %s", self._hung)
        for p in self.procs:
            if p.is_alive():
                p.kill()

    def close(self, timeout_s: float = JOIN_TIMEOUT_S) -> None:
        """Stop every follower; one still alive after `timeout_s` is killed
        and named in the MeshError raised."""
        if self.closed or not self.is_leader:
            return
        for conn in self.conns:
            try:
                conn.send(("stop", None, {}, ()))
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        hung = []
        for r, p in enumerate(self.procs, start=1):
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                hung.append(r)
                p.kill()
                p.join(5)
        errors = self._follower_errors(0.0)
        self._finish()
        if hung or self._hung:
            raise MeshError(f"rank(s) {sorted(set(hung + self._hung))} hung and were killed")
        if errors:
            raise MeshError("\n".join(errors))


def start(world: int, device, deadline: Optional[float] = None,
          timeout_s: float = comm.TIMEOUT_S) -> Ranks:
    """Spawn world − 1 followers and form the process group; → rank 0's
    Ranks (the module docstring)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        raise RuntimeError("a mesh's process group is already running in this process")
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = comm.choose_backend(device.type, world, n_cards)
    logger.info("mesh of %d ranks: backend %s", world, comm.backend_reason(device.type, world, n_cards))
    init = f"tcp://127.0.0.1:{_free_port()}"
    ranks = Ranks(0, world, device, backend)
    ctx = mp.get_context("spawn")
    for r in range(1, world):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_follower_main, args=(r, world, init, device.type, backend, child,
                                                         timeout_s),
                           name=f"dsocr-mesh-rank{r}", daemon=True)
        with _main_hidden():
            proc.start()
        child.close()
        ranks.procs.append(proc)
        ranks.conns.append(parent)
    ranks.set_deadline(deadline)
    try:
        comm.init_group(init, 0, world, backend, timeout_s)
        for r, conn in enumerate(ranks.conns, start=1):
            if not conn.poll(JOIN_TIMEOUT_S):
                raise MeshError(f"rank {r} did not report ready within {JOIN_TIMEOUT_S} s")
            msg = conn.recv()
            if msg[0] != "ready":
                raise MeshError(f"rank {msg[1]} raised:\n{msg[2]}")
    except BaseException as err:
        ranks.fail(err)
    return ranks


def _follower_main(rank: int, world: int, init: str, device_type: str, backend: str, conn,
                   timeout_s: float) -> None:
    """A follower: join the group, then serve rank 0's messages until
    ``stop`` or a closed pipe; on an error report it and exit."""
    try:
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh rank {rank} found no CUDA GPU")
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:  # the ranks share the host's cores: one thread each
            device = torch.device("cpu")
            torch.set_num_threads(1)
        comm.init_group(init, rank, world, backend, timeout_s)
        ranks = Ranks(rank, world, device, backend)
        conn.send(("ready", rank, ""))
        _serve(conn, ranks)
    except BaseException:
        try:
            conn.send(("error", rank, traceback.format_exc()))
        except OSError:
            pass
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()
    os._exit(0)


def _serve(conn, ranks: Ranks) -> None:
    target = None
    while True:
        try:
            kind, op, kwargs, frees = conn.recv()
        except EOFError:  # rank 0 is gone
            return
        if kind == "stop":
            return
        if kind == "build":
            target = None
            gc.collect()
            if ranks.device.type == "cuda":
                torch.cuda.empty_cache()
            target = op(**kwargs, device=ranks.device.type, ranks=ranks)
        elif kind == "call":
            target.mesh_runtime.serve(op, kwargs, frees)
