"""Contiguous KV cache of single-request decode
(dsocr_tpu/runtime/kv_cache.py).

Preallocated ``[layers, batch, kv_heads, max_seq, head_dim]`` buffers and
one logical length; attention masks out the positions past it, so a reset
is ``length = 0`` and stale data needs no clearing. The reference's
functional updates become in-place writes on the buffers here; the
functions still return the cache, so callers read as the reference's do.
The length is a host int: an eager decode step knows it without a device
read.

The buffers hold the model dtype. The reference's int8 scale planes exist
only for slot steps (runtime/slots.py); the decoder's forward over a
KVCache refuses them as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, H_kv, S_max, Dk]
    v: torch.Tensor  # [L, B, H_kv, S_max, Dv]
    length: int  # number of valid positions
    k_scale: Optional[torch.Tensor] = None  # [L, B, H_kv, S_max] f32 (slot steps only)
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_kv_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int, k_head_dim: int,
                  v_head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (num_layers, batch, num_kv_heads, max_len)
    return KVCache(
        k=torch.zeros((*shape, k_head_dim), dtype=dtype, device=device),
        v=torch.zeros((*shape, v_head_dim), dtype=dtype, device=device),
        length=0,
    )


def write_kv(cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
             start: int) -> KVCache:
    """Write [B, H_kv, S_new, D] K/V at [start, start + S_new) of one
    layer, in place. Does NOT bump `length`: the model bumps it once per
    forward after all layers. A write past max_len raises (the reference's
    dynamic_update_slice would clamp it onto the last positions)."""
    end = start + k_new.shape[2]
    if start < 0 or end > cache.max_len:
        raise ValueError(f"KV write at [{start}, {end}) outside the cache's {cache.max_len} positions")
    cache.k[layer, :, :, start:end] = k_new.to(cache.k.dtype)
    cache.v[layer, :, :, start:end] = v_new.to(cache.v.dtype)
    return cache


def layer_kv(cache: KVCache, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full (k, v) buffers of a layer: [B, H_kv, S_max, D] views."""
    return cache.k[layer], cache.v[layer]


def bump_length(cache: KVCache, amount: int) -> KVCache:
    return cache._replace(length=cache.length + int(amount))


def reset(cache: KVCache) -> KVCache:
    """A logical wipe between requests."""
    return cache._replace(length=0)
