"""Slot KV cache kernels of the continuous-batching decode step.

``slot_kv_update`` replaces slot_kv_update
(dsocr_tpu/ops/pallas/slot_attention.py:194) and ``slot_decode_attention``
replaces slot_decode_attention (:375). ``slot_kv_write`` is the write as
the decode step calls it: it takes the new token unquantized and also
replaces the reference's quantize_kv_int8 (dsocr_tpu/ops/attention.py:83)
that feeds slot_kv_update. Caches are [L, B, NKV, S, D] — int8 codes with
[L, B, NKV, S] f32 scale planes, or the model dtype without scales. Main
path: L = 12, B = 16, NKV = 10, D = 128, S = 2560.

What bounds them on the H100: device-memory bytes. The write moves one
token per (row, head), a few KB per call, so it is launch latency; with
an int8 cache, quantizing the token in PyTorch first cost 11 ops a
tensor (22 launches a layer, each with its host time) on a step that the
host bounds. The attend reads each row's used K/V once and does 4 FLOPs
per byte of bf16 (2 per byte of int8): at the serving step's 16 rows ×
~968 positions it reads ~40 MB of bf16 K/V per layer (~20 MB int8), 12
(6) µs at the card's 3.35 TB/s.

What the design does (csrc/slot_attention.cu over the bodies in
csrc/kv_attention.cuh, which the paged kernels share; only the map from a
row's position to a cache row differs):

- ``slot_kv_write`` and ``slot_kv_update``: one body, grid (B, NKV), a
  warp per plane (K, V) of a (row, head), writing row b's token at
  ``lengths[b]`` of the layer IN PLACE on the torch cache — the port's
  choice (JAX's functional update aliases its buffers instead). The layer
  is a Python int: the wrapper passes the pointer of ``cache[layer]``, a
  view that costs no copy. Rows with ``lengths[b] >= S`` write nothing.
  ``slot_kv_write`` reads the token where the projection left it
  (strides, no copy) and quantizes it in the kernel for an int8 cache
  (amax by warp max, the reference's division and round half to even:
  bit-exact with quantize_kv_int8), or converts it to a float cache's
  dtype; ``slot_kv_update`` keeps the reference's contract (codes and
  scales in) and copies them.
- ``slot_decode_attention``: split-K over positions. A block owns 256
  positions (``_lib.DECODE_SPLIT``) of one (row, KV head), so the step's
  grid grows with the cache's capacity (S) and never reads ``lengths``
  back; its four warps each stream tiles of 16 positions through a
  two-stage cp.async ring, reading only positions [0, lengths[b]], and
  keep f32 online-softmax partials that a second small kernel merges in
  split order (deterministic; no atomics). int8 scales fold in as the
  reference does (k scale after ``* scale``, v scale into p after ``l``
  has accumulated p). The wrapper allocates the partials' scratch.
"""

from __future__ import annotations

import torch

from ..attention import attention, attention_kv_int8, quantize_kv_int8
from . import _lib


def slot_kv_update_plain(k_all, v_all, ks_all, vs_all, k_new, v_new, ks_new,
                         vs_new, layer: int, lengths):
    """Indexed assignment in place; rows with lengths >= S are dropped
    (the reference's out-of-bounds scatter semantics)."""
    S = k_all.shape[3]
    valid = (lengths >= 0) & (lengths < S)
    rows = torch.arange(k_new.shape[0], device=k_new.device)[valid]
    pos = lengths[valid].long()
    k_all[layer, rows, :, pos] = k_new[valid].to(k_all.dtype)
    v_all[layer, rows, :, pos] = v_new[valid].to(v_all.dtype)
    if ks_all is not None:
        ks_all[layer, rows, :, pos] = ks_new[valid]
        vs_all[layer, rows, :, pos] = vs_new[valid]


def slot_kv_update(k_all, v_all, ks_all, vs_all, k_new, v_new, ks_new, vs_new,
                   layer: int, lengths):
    """Write one token per row at position lengths[r] of `layer`, in place.

    k_all/v_all [L, B, NKV, S, D|Dv] (int8 codes or model dtype),
    ks_all/vs_all [L, B, NKV, S] f32 or None; k_new/v_new [B, NKV, D|Dv]
    already in the cache dtype (quantized for int8), ks_new/vs_new
    [B, NKV] f32 or None; lengths [B] int32. Returns None."""
    if k_all.device.type == "cpu":
        return slot_kv_update_plain(k_all, v_all, ks_all, vs_all, k_new, v_new,
                                    ks_new, vs_new, layer, lengths)
    name = "slot_kv_update"
    _lib.require_cuda(name, k_all, v_all, ks_all, vs_all, k_new, v_new, ks_new,
                      vs_new, lengths)
    L, B, NKV, S, D = k_all.shape
    Dv = v_all.shape[-1]
    quant = ks_all is not None
    if k_new.dtype != k_all.dtype or v_new.dtype != v_all.dtype or v_all.dtype != k_all.dtype:
        raise ValueError(f"{name}: new rows must already be in the cache dtype")
    if k_new.shape != (B, NKV, D) or v_new.shape != (B, NKV, Dv) or lengths.shape != (B,):
        raise ValueError(f"{name}: bad shapes {k_new.shape} {v_new.shape}")
    if lengths.dtype != torch.int32 or not 0 <= layer < L:
        raise ValueError(f"{name}: lengths must be int32 and layer in range")
    if quant and (vs_all is None or ks_new is None or vs_new is None
                  or ks_new.dtype != torch.float32 or ks_all.dtype != torch.float32):
        raise ValueError(f"{name}: int8 caches need f32 scale planes and new scales")
    err = _lib.lib().dsocr_slot_kv_update(
        k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        ks_all[layer].data_ptr() if quant else None,
        vs_all[layer].data_ptr() if quant else None,
        k_new.data_ptr(), v_new.data_ptr(), _lib.ptr(ks_new), _lib.ptr(vs_new),
        lengths.data_ptr(), B, NKV, S, D, Dv, k_all.element_size(),
        _lib.stream_ptr(k_all),
    )
    _lib.check(err, name)
    _lib.count_launch(slot_kv_update)


slot_kv_update.launches = 0


def token_rows(k_new, v_new, kv_dtype, quant: bool):
    """The new token [B, NKV, D|Dv] as the cache stores it: int8 codes and
    [B, NKV] scales by quantize_kv_int8 for an int8 cache, else the
    cache's dtype and no scales (what the write kernel computes in its
    body)."""
    if quant:
        (k_q, k_s), (v_q, v_s) = quantize_kv_int8(k_new), quantize_kv_int8(v_new)
        return k_q, v_q, k_s, v_s
    return k_new.to(kv_dtype), v_new.to(kv_dtype), None, None


def token_view(name, t, B, NKV, D):
    """The decoder's [B, NKV, 1, D] (or [B, NKV, D]) token as a [B, NKV,
    D] view; a copy only where D is not contiguous."""
    if t.dim() == 4 and t.shape[2] == 1:
        t = t[:, :, 0]
    if tuple(t.shape) != (B, NKV, D) or t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the token must be [B, NKV, 1, D] = [{B}, {NKV}, 1, {D}] f32 or bf16, "
                         f"got {tuple(t.shape)} {t.dtype}")
    return t if t.stride(-1) == 1 else t.contiguous()


def check_cache_planes(name, k, v, ks, vs):
    """int8 caches with f32 scale planes, or f32 / bf16 caches without."""
    quant = ks is not None
    if k.dtype != v.dtype or quant != (k.dtype == torch.int8) or quant != (vs is not None):
        raise ValueError(f"{name}: scale planes go with int8 caches only")
    if k.dtype not in (torch.int8, torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported cache dtype {k.dtype}")
    if quant and (ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError(f"{name}: scale planes must be f32")
    return quant


def slot_kv_write_plain(k_all, v_all, ks_all, vs_all, k_new, v_new, layer: int, lengths):
    """quantize_kv_int8 (or the cast to the cache's dtype), then the plain
    write."""
    k_new, v_new = (t[:, :, 0] if t.dim() == 4 else t for t in (k_new, v_new))
    slot_kv_update_plain(k_all, v_all, ks_all, vs_all,
                         *token_rows(k_new, v_new, k_all.dtype, ks_all is not None), layer, lengths)


def slot_kv_write(k_all, v_all, ks_all, vs_all, k_new, v_new, layer: int, lengths):
    """Write one token per row at position lengths[r] of `layer`, in place,
    from the token as the decoder leaves it.

    k_all/v_all [L, B, NKV, S, D|Dv] (int8 codes, f32 or bf16),
    ks_all/vs_all [L, B, NKV, S] f32 or None; k_new/v_new [B, NKV, 1,
    D|Dv] (or [B, NKV, D|Dv]) f32 or bf16, any strides with D contiguous:
    quantized in the kernel for an int8 cache (D ≤ 128), else converted;
    lengths [B] int32. Returns None."""
    if k_all.device.type == "cpu":
        return slot_kv_write_plain(k_all, v_all, ks_all, vs_all, k_new, v_new, layer, lengths)
    name = "slot_kv_write"
    _lib.require_cuda(name, k_all, v_all, ks_all, vs_all, lengths)
    L, B, NKV, S, D = k_all.shape
    Dv = v_all.shape[-1]
    quant = check_cache_planes(name, k_all, v_all, ks_all, vs_all)
    k_new, v_new = token_view(name, k_new, B, NKV, D), token_view(name, v_new, B, NKV, Dv)
    if k_new.device != k_all.device or v_new.device != k_all.device or k_new.dtype != v_new.dtype:
        raise ValueError(f"{name}: K and V tokens must share the cache's device and one dtype")
    if quant and max(D, Dv) > 128:
        raise ValueError(f"{name}: the quantizing write takes head dims up to 128")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or not 0 <= layer < L:
        raise ValueError(f"{name}: lengths must be [B] int32 and layer in range")
    err = _lib.lib().dsocr_slot_kv_write(
        k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        ks_all[layer].data_ptr() if quant else None, vs_all[layer].data_ptr() if quant else None,
        k_new.data_ptr(), v_new.data_ptr(), lengths.data_ptr(), k_new.stride(0), k_new.stride(1),
        v_new.stride(0), v_new.stride(1), B, NKV, S, D, Dv, _lib.DTYPE_CODES[k_new.dtype],
        _lib.DTYPE_CODES[k_all.dtype], _lib.stream_ptr(k_all),
    )
    _lib.check(err, name)
    _lib.count_launch(slot_kv_write)


slot_kv_write.launches = 0


def slot_decode_attention_plain(q, k_all, v_all, ks_all, vs_all, layer: int,
                                lengths, *, scale: float):
    """Dense masked attention over the whole [S] row (the reference's
    einsum path: ops/attention.py attention / attention_kv_int8)."""
    pos = torch.arange(k_all.shape[3], device=q.device)
    mask = (pos[None, :] <= lengths.to(q.device)[:, None])[:, None, None, :]  # [B, 1, 1, S]
    if ks_all is not None:
        return attention_kv_int8(q, k_all[layer], ks_all[layer], v_all[layer], vs_all[layer],
                                 mask, scale)
    return attention(q, k_all[layer].to(q.dtype), v_all[layer].to(q.dtype), mask, scale)


def slot_decode_attention(q, k_all, v_all, ks_all, vs_all, layer: int, lengths,
                          *, scale: float):
    """q [B, NH, 1, D] attends [0, lengths[b]] of `layer`'s cache →
    [B, 1, NH·Dv] in q's dtype (f32 inside). CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return slot_decode_attention_plain(q, k_all, v_all, ks_all, vs_all, layer,
                                           lengths, scale=scale)
    name = "slot_decode_attention"
    _lib.require_cuda(name, q, k_all, v_all, ks_all, vs_all, lengths)
    B, NH, Sq, D = q.shape
    L, _, NKV, S, Dv = v_all.shape
    if Sq != 1 or k_all.shape != (L, B, NKV, S, D) or NH % NKV or NH // NKV > 8:
        raise ValueError(f"{name}: bad shapes {q.shape} {k_all.shape} {v_all.shape}")
    if D > 128 or Dv > 128:
        raise ValueError(f"{name}: head dims above 128 are not supported")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_all.dtype != v_all.dtype:
        raise ValueError(f"{name}: unsupported dtypes {q.dtype} {k_all.dtype}")
    quant = k_all.dtype == torch.int8
    if quant != (ks_all is not None and vs_all is not None):
        raise ValueError(f"{name}: scale planes go with int8 caches only")
    if lengths.dtype != torch.int32 or not 0 <= layer < L:
        raise ValueError(f"{name}: lengths must be int32 and layer in range")
    out = torch.empty((B, 1, NH * Dv), dtype=q.dtype, device=q.device)
    splits, part = _lib.decode_partials(B, NKV, S, NH // NKV, Dv, q.device)
    err = _lib.lib().dsocr_slot_decode_attention(
        q.data_ptr(), k_all[layer].data_ptr(), v_all[layer].data_ptr(),
        ks_all[layer].data_ptr() if quant else None,
        vs_all[layer].data_ptr() if quant else None,
        lengths.data_ptr(), part.data_ptr(), out.data_ptr(), B, NH, NKV, S, D, Dv,
        float(scale), splits, _lib.DTYPE_CODES[q.dtype], _lib.DTYPE_CODES[k_all.dtype],
        _lib.stream_ptr(q),
    )
    _lib.check(err, name)
    _lib.count_launch(slot_decode_attention)
    return out


slot_decode_attention.launches = 0
