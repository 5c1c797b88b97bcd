"""The ("dp", "mp") mesh and its sharding rules (dsocr_tpu/parallel/mesh.py).

A mesh is a grid of ranks, ``dp`` rows by ``mp`` columns: rank
``d * mp + m`` sits at (d, m). The model axis ``mp`` splits attention
heads, MLP and expert intermediate dims (or, with ``ep``, the routed
experts themselves) and the vocabulary; the data axis ``dp`` splits the
slot rows. Every rule returns a partition spec: a tuple with one entry
per tensor dimension, the axis name that splits it or None, and ``()``
for a tensor that every rank holds whole, as ``jax.sharding.PartitionSpec``
reads. A dimension that an axis does not divide replicates instead, and
the slot-cache rules say so once in the log (``_warn_replicated``).

``deepseek_param_shardings`` names the split dimension of each decoder
parameter of the split layout, per layer (the reference's [L, ...]
stacks without their leading L); anything it does not name replicates.
``shard_tensor`` cuts a rank's piece out of a whole tensor.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import torch

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp × mp ranks; ``shape`` as the reference's Mesh.shape reads."""

    dp: int
    mp: int
    ep: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def coords(self, rank: int) -> Tuple[int, int]:
        """rank → (d, m)."""
        return divmod(rank, self.mp)

    def mp_ranks(self, d: int) -> Tuple[int, ...]:
        """The ranks of dp row d (one mp group)."""
        return tuple(range(d * self.mp, (d + 1) * self.mp))


def make_mesh(n_devices: int, dp: Optional[int] = None, ep: bool = False) -> Mesh:
    """n ranks as dp × (n // dp); dp defaults to 1 (model parallelism
    first, as the reference prefers for inference)."""
    dp = dp or 1
    if n_devices % dp:
        raise ValueError(f"dp={dp} does not divide {n_devices} ranks")
    return Mesh(dp, n_devices // dp, ep)


def parse_mesh_spec(spec) -> Optional[Mesh]:
    """'dp=2,mp=4[,ep]' → Mesh (None or '' → None; a Mesh passes
    through). 'ep' puts the routed experts on the mp axis."""
    if spec is None or isinstance(spec, Mesh):
        return spec
    if not spec:
        return None
    parts, ep = {}, False
    for item in str(spec).split(","):
        item = item.strip()
        if item in ("ep", "ep=true", "ep=1"):
            ep = True
            continue
        key, _, value = item.partition("=")
        if key not in ("dp", "mp") or not value.isdigit() or int(value) < 1:
            raise ValueError(f"bad mesh spec {spec!r}: expected dp=N,mp=M[,ep]")
        parts[key] = int(value)
    dp, mp = parts.get("dp", 1), parts.get("mp", 1)
    return make_mesh(dp * mp, dp=dp, ep=ep)


# -- cache, scale, row and pool rules ---------------------------------------------


def cache_sharding(mesh: Mesh, num_kv_heads: int) -> Spec:
    """KV cache [L, B, H_kv, S, D]: batch over dp, heads over mp when
    they divide."""
    h = "mp" if num_kv_heads % mesh.mp == 0 else None
    return (None, "dp", h, None, None)


def scale_sharding(mesh: Mesh, num_kv_heads: int) -> Spec:
    """int8 scale planes [L, B, H_kv, S] of cache_sharding's cache."""
    h = "mp" if num_kv_heads % mesh.mp == 0 else None
    return (None, "dp", h, None)


_warned_fallbacks: set = set()


def _warn_replicated(axis: str, dim: str, n: int, size: int) -> None:
    """Say once that a mesh axis replicates a dimension it cannot split:
    a user who asked for dp must see in the log that the slot cache got
    none."""
    key = (axis, dim, n, size)
    if key in _warned_fallbacks:
        return
    _warned_fallbacks.add(key)
    logging.getLogger("dsocr.mesh").warning(
        "mesh axis %r (size %d) does not divide %s=%d; replicating that "
        "dimension instead — no %s parallelism for the slot KV cache",
        axis, size, dim, n, axis,
    )


def _slot_axes(mesh: Mesh, num_kv_heads: int, n_slots: int, warn: bool):
    b = "dp" if n_slots % mesh.dp == 0 else None
    h = "mp" if num_kv_heads % mesh.mp == 0 else None
    if warn and b is None and mesh.dp > 1:
        _warn_replicated("dp", "n_slots", n_slots, mesh.dp)
    if warn and h is None and mesh.mp > 1:
        _warn_replicated("mp", "num_kv_heads", num_kv_heads, mesh.mp)
    return b, h


def slot_cache_sharding(mesh: Mesh, num_kv_heads: int, n_slots: int) -> Spec:
    """Slot KV cache [L, B, H_kv, S, D]: rows over dp and heads over mp,
    each only where the axis divides."""
    b, h = _slot_axes(mesh, num_kv_heads, n_slots, warn=True)
    return (None, b, h, None, None)


def slot_scale_sharding(mesh: Mesh, num_kv_heads: int, n_slots: int) -> Spec:
    """int8 scale planes [L, B, H_kv, S] matching slot_cache_sharding."""
    b, h = _slot_axes(mesh, num_kv_heads, n_slots, warn=False)
    return (None, b, h, None)


def row_cache_sharding(mesh: Mesh, num_kv_heads: int) -> Spec:
    """One prefilled row [L, 1, H_kv, s_pad, D]: heads over mp only."""
    return (None, None, "mp", None, None) if num_kv_heads % mesh.mp == 0 else ()


def _pool_heads(mesh: Mesh, num_kv_heads: int, num_heads: int) -> bool:
    return num_kv_heads % mesh.mp == 0 and num_heads % mesh.mp == 0


def pool_sharding(mesh: Mesh, num_kv_heads: int, num_heads: int) -> Spec:
    """Page pool [L, P, H_kv, page, D]: heads over mp when both the query
    and the KV head counts divide; every row shares the page axis, so it
    never splits over dp."""
    return (None, None, "mp", None, None) if _pool_heads(mesh, num_kv_heads, num_heads) else ()


def pool_scale_sharding(mesh: Mesh, num_kv_heads: int, num_heads: int) -> Spec:
    """int8 scale planes [L, P, H_kv, page] of pool_sharding's pool."""
    return (None, None, "mp", None) if _pool_heads(mesh, num_kv_heads, num_heads) else ()


# -- decoder parameters -------------------------------------------------------------

# split dims of the split layout's per-layer weights under tensor parallelism
_TP_DIMS = {
    "q_proj": -1, "k_proj": -1, "v_proj": -1, "o_proj": 0,
    "gate_proj": -1, "up_proj": -1, "down_proj": 0,
    "shared_gate": -1, "shared_up": -1, "shared_down": 0,
    "experts_gate": -1, "experts_up": -1, "experts_down": 1,
}
_EXPERT_KEYS = ("experts_gate", "experts_up", "experts_down")


def _spec(ndim: int, dim: int) -> Spec:
    out = [None] * ndim
    out[dim] = "mp"
    return tuple(out)


def param_split_dim(name: str, *, ep: bool = False, packed: bool = False) -> Optional[int]:
    """The dimension of decoder parameter `name` (a state_dict key such
    as ``decoder.moe_layers.0.q_proj`` or ``...experts_gate.codes``) that
    mp splits, or None where it replicates. Float weights: heads, MLP
    and expert intermediate dims, vocab; with `ep`, the routed experts
    over E. Packed weights (`packed`): only the routed experts, over E;
    everything else replicates."""
    parts = name.split(".")
    if parts[-1] in ("codes", "scales", "mins", "highs"):
        parts = parts[:-1]
    leaf = parts[-1]
    if leaf in _EXPERT_KEYS and (ep or packed):
        return 0
    if packed:
        return None
    if leaf == "embed_tokens":
        return 0
    if leaf == "lm_head":
        return -1
    if len(parts) >= 3 and parts[-3] in ("dense_layers", "moe_layers"):
        return _TP_DIMS.get(leaf)
    return None


def deepseek_param_shardings(shapes: Dict[str, Tuple[int, ...]], mesh: Mesh, ep: bool = False,
                             packed: bool = False) -> Dict[str, Spec]:
    """{state_dict key: shape} of a split decoder → {key: spec}, ``()``
    for what replicates (the reference's tree of NamedShardings, per
    layer)."""
    out = {}
    for name, shape in shapes.items():
        dim = param_split_dim(name, ep=ep, packed=packed)
        out[name] = () if dim is None else _spec(len(shape), dim)
    return out


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh, rank: int) -> torch.Tensor:
    """Rank `rank`'s piece of the whole tensor `t` under `spec` (a
    contiguous copy; `t` itself where the spec splits nothing)."""
    d, m = mesh.coords(rank)
    index = {"dp": d, "mp": m}
    out = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if out.shape[dim] % n:
            raise ValueError(f"axis {axis}={n} does not divide dim {dim} of {tuple(t.shape)}")
        size = out.shape[dim] // n
        out = out.narrow(dim, index[axis] * size, size)
    return out.contiguous() if out is not t else t
