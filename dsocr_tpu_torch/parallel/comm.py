"""Collectives of the mesh over torch.distributed.

One process per rank; the default process group spans them all. The
backend follows the topology (``choose_backend``): NCCL when every rank
has a card of its own, gloo on the CPU, and gloo when ranks share a card,
because NCCL refuses two ranks on one device ("Duplicate GPU detected",
mesh_backends.py). gloo takes the CUDA tensors as they are and copies
them through host memory itself; the kernels still run on the card.

Every partial sum is reduced in f32 (``all_reduce_f32``), over the mp
group of the rank's dp row; ``all_gather`` joins the mp group's pieces
of a tensor (the dense families' attention outputs, one block of heads
a rank). ``calls`` counts the collectives by name, so a caller can read
how many a decode step made.
"""

from __future__ import annotations

import collections
import datetime
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# the process group's timeout: a collective that waits longer raises
TIMEOUT_S = 60


def choose_backend(device_type: str, world: int, n_cards: int) -> str:
    """"nccl" when each of `world` ranks has its own card, else "gloo"
    (the CPU, or ranks sharing cards)."""
    if device_type == "cuda" and n_cards >= world:
        return "nccl"
    return "gloo"


def backend_reason(device_type: str, world: int, n_cards: int) -> str:
    if device_type != "cuda":
        return "gloo: ranks on the CPU"
    if n_cards >= world:
        return f"nccl: {world} ranks on {n_cards} cards, one each"
    return (f"gloo: {world} ranks share {n_cards} card(s) — NCCL refuses two ranks on one device; "
            "gloo copies CUDA tensors through host memory")


def init_group(init_method: str, rank: int, world: int, backend: str,
               timeout_s: float = TIMEOUT_S) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Comm:
    """The collectives one rank makes: f32 all-reduce and all-gather over
    its mp group, broadcast from rank 0, gather to rank 0."""

    def __init__(self, mesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        self.backend = dist.get_backend()
        self.d, self.m = mesh.coords(rank)
        # every rank creates every group, in the same order
        self.mp_group = None
        for d in range(mesh.dp):
            group = dist.new_group(list(mesh.mp_ranks(d))) if mesh.dp > 1 else dist.group.WORLD
            if d == self.d:
                self.mp_group = group
        self.calls = collections.Counter()

    # -- collectives --------------------------------------------------------------

    def all_reduce_f32(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the mp group, in f32 (a new f32 tensor)."""
        x = t.float().clone() if t.dtype == torch.float32 else t.float()
        if self.mesh.mp == 1:
            return x
        self.calls["all_reduce"] += 1
        dist.all_reduce(x, group=self.mp_group)
        return x

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The mp group's pieces of `t` (one shape on every rank of it)
        joined along `dim` in mp order."""
        if self.mesh.mp == 1:
            return t
        self.calls["all_gather"] += 1
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.mesh.mp)]
        dist.all_gather(out, t, group=self.mp_group)
        return torch.cat(out, dim=dim)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place."""
        if self.mesh.size == 1:
            return t
        self.calls["broadcast"] += 1
        dist.broadcast(t, src=0)
        return t

    def gather(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's `t` (one shape on all ranks) → the list on rank
        0, in rank order; None elsewhere."""
        if self.mesh.size == 1:
            return [t]
        self.calls["gather"] += 1
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.mesh.size)] if self.rank == 0 else None
        dist.gather(t, out, dst=0)
        return out


def join_gathered(pieces: Sequence[torch.Tensor], mesh, rows_split: bool,
                  vocab_split: bool) -> torch.Tensor:
    """Logits pieces gathered in rank order, each [rows, vocab] of rank
    (d, m) → the whole [B, V]: rows of dp row d when `rows_split`, vocab
    slice m when `vocab_split` (else rank (d, 0)'s piece is whole)."""
    rows = []
    for d in range(mesh.dp if rows_split else 1):
        ranks = mesh.mp_ranks(d)
        rows.append(torch.cat([pieces[r] for r in ranks], dim=-1) if vocab_split else pieces[ranks[0]])
    return torch.cat(rows, dim=0)
