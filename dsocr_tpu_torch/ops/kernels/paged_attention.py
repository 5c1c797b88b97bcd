"""Paged KV kernels of the continuous-batching decode step.

``paged_kv_update`` replaces paged_kv_update
(dsocr_tpu/ops/pallas/paged_attention.py:233) and
``paged_decode_attention`` replaces paged_decode_attention (:99);
``paged_kv_write`` is the write as the decode step calls it, from the
unquantized token, and also replaces the reference's quantize_kv_int8
(dsocr_tpu/ops/attention.py:83) that feeds paged_kv_update. Row b's
position t lives in page ``tables[b, t // page]`` of a shared pool, at
offset ``t % page``. Pools are [L, P, NKV, page, D]: int8 codes with
[L, P, NKV, page] f32 scale planes, or the model dtype without scales;
tables [B, P_max] int32, lengths [B] int32. A table entry outside [0, P)
is no page: a row holds none until it joins and again once it is
released. Main path: L = 12, P = 108, NKV = 10, page = 128, D = 128,
B = 16, P_max = 12.

What bounds them on the H100: device-memory bytes. The write moves one
token per (row, head), a few KB per call: launch latency (and, before
the quantization moved into it, 22 PyTorch launches a layer to quantize
the token for an int8 pool). The attend
reads each row's used K/V once: at 16 rows × 10 heads × ~1,032 tokens ×
264 B (int8 K and V of 128 plus two f32 scales) it reads ≈43.6 MB a
launch, ≥ 13 µs at 3.35 TB/s.

What the design does (csrc/paged_attention.cu over the bodies in
csrc/kv_attention.cuh, which the contiguous slot kernels share): the
address mapping is the one difference from ops/kernels/slot_attention.py.

- ``paged_kv_write`` and ``paged_kv_update``: the slot write's body
  (``paged_kv_write`` quantizes or converts the token in the kernel,
  ``paged_kv_update`` copies codes and scales), grid (B, NKV), a warp per
  plane, writing row b's token IN PLACE at its page and offset; the layer
  is a Python int, so the wrapper passes the pointer of ``pool[layer]``. A row
  whose position falls on no page (a released or never-joined row, or a
  finished row one past its last page) writes nothing: the reference
  instead writes idle rows' token 0 through a stale table into page
  ``tables[r][0]``, which a live row may own.
- ``paged_decode_attention``: the slot attend's split-K body (256
  positions a block, four warps streaming tiles of 16 positions, partials
  merged in split order by a second kernel), with each tile ending at a
  page boundary and looked up in the row's table. It reads only pages ≤
  lengths[b] // page and only positions ≤ lengths[b], so what the rest of
  a page holds (NaN included) never reaches the product. A position on no
  page is left out; a row with none gets zeros.
"""

from __future__ import annotations

import torch

from ..attention import attention, attention_kv_int8
from . import _lib
from .slot_attention import check_cache_planes, token_rows, token_view


def _pages(tables: torch.Tensor, n_pages: int):
    """(page ids with absent entries as 0, present mask [B, P_max])."""
    pid = tables.long()
    present = (pid >= 0) & (pid < n_pages)
    return torch.where(present, pid, torch.zeros_like(pid)), present


def paged_kv_update_plain(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, ks_new, vs_new,
                          tables, lengths, layer: int):
    """Indexed assignment in place; rows whose position has no page are
    dropped."""
    P, page = k_pool.shape[1], k_pool.shape[3]
    P_max = tables.shape[1]
    pos = lengths.long()
    ordinal = torch.div(pos, page, rounding_mode="floor")
    ok = (pos >= 0) & (ordinal < P_max)
    ids, present = _pages(tables, P)
    rows = torch.arange(len(pos), device=pos.device)
    ordinal = ordinal.clamp(0, P_max - 1)
    ok &= present[rows, ordinal]
    pid, off = ids[rows, ordinal][ok], (pos % page)[ok]
    k_pool[layer, pid, :, off] = k_new[ok].to(k_pool.dtype)
    v_pool[layer, pid, :, off] = v_new[ok].to(v_pool.dtype)
    if ks_pool is not None:
        ks_pool[layer, pid, :, off] = ks_new[ok]
        vs_pool[layer, pid, :, off] = vs_new[ok]


def paged_kv_update(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, ks_new, vs_new,
                    tables, lengths, layer: int):
    """Write one token per row at position lengths[b] of `layer`, through
    the page tables, in place.

    k_pool/v_pool [L, P, NKV, page, D|Dv] (int8 codes or model dtype),
    ks_pool/vs_pool [L, P, NKV, page] f32 or None; k_new/v_new [B, NKV,
    D|Dv] already in the pool dtype (quantized for int8), ks_new/vs_new
    [B, NKV] f32 or None; tables [B, P_max] int32; lengths [B] int32.
    Returns None."""
    if k_pool.device.type == "cpu":
        return paged_kv_update_plain(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, ks_new,
                                     vs_new, tables, lengths, layer)
    name = "paged_kv_update"
    _lib.require_cuda(name, k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, ks_new, vs_new,
                      tables, lengths)
    L, P, NKV, page, D = k_pool.shape
    Dv = v_pool.shape[-1]
    B, P_max = tables.shape
    quant = ks_pool is not None
    if k_new.dtype != k_pool.dtype or v_new.dtype != v_pool.dtype or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{name}: new rows must already be in the pool dtype")
    if (v_pool.shape[:4] != k_pool.shape[:4] or k_new.shape != (B, NKV, D)
            or v_new.shape != (B, NKV, Dv) or lengths.shape != (B,)):
        raise ValueError(f"{name}: bad shapes {k_new.shape} {v_new.shape} {tables.shape}")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32 or not 0 <= layer < L:
        raise ValueError(f"{name}: lengths and tables must be int32 and layer in range")
    if quant and (vs_pool is None or ks_new is None or vs_new is None
                  or ks_new.dtype != torch.float32 or ks_pool.dtype != torch.float32):
        raise ValueError(f"{name}: int8 pools need f32 scale planes and new scales")
    err = _lib.lib().dsocr_paged_kv_update(
        k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        ks_pool[layer].data_ptr() if quant else None,
        vs_pool[layer].data_ptr() if quant else None,
        k_new.data_ptr(), v_new.data_ptr(), _lib.ptr(ks_new), _lib.ptr(vs_new),
        tables.data_ptr(), lengths.data_ptr(), B, NKV, P, page, P_max, D, Dv,
        k_pool.element_size(), _lib.stream_ptr(k_pool),
    )
    _lib.check(err, name)
    _lib.count_launch(paged_kv_update)


paged_kv_update.launches = 0


def paged_kv_write_plain(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, tables, lengths,
                         layer: int):
    """quantize_kv_int8 (or the cast to the pool's dtype), then the plain
    write."""
    k_new, v_new = (t[:, :, 0] if t.dim() == 4 else t for t in (k_new, v_new))
    paged_kv_update_plain(k_pool, v_pool, ks_pool, vs_pool,
                          *token_rows(k_new, v_new, k_pool.dtype, ks_pool is not None), tables, lengths,
                          layer)


def paged_kv_write(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, tables, lengths, layer: int):
    """Write one token per row at position lengths[b] of `layer`, through
    the page tables, in place, from the token as the decoder leaves it.

    k_pool/v_pool [L, P, NKV, page, D|Dv] (int8 codes, f32 or bf16),
    ks_pool/vs_pool [L, P, NKV, page] f32 or None; k_new/v_new [B, NKV, 1,
    D|Dv] (or [B, NKV, D|Dv]) f32 or bf16, any strides with D contiguous:
    quantized in the kernel for an int8 pool (D ≤ 128), else converted;
    tables [B, P_max] int32; lengths [B] int32. Returns None."""
    if k_pool.device.type == "cpu":
        return paged_kv_write_plain(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, tables, lengths,
                                    layer)
    name = "paged_kv_write"
    _lib.require_cuda(name, k_pool, v_pool, ks_pool, vs_pool, tables, lengths)
    L, P, NKV, page, D = k_pool.shape
    Dv = v_pool.shape[-1]
    B, P_max = tables.shape
    quant = check_cache_planes(name, k_pool, v_pool, ks_pool, vs_pool)
    if v_pool.shape[:4] != k_pool.shape[:4]:
        raise ValueError(f"{name}: bad pool shapes {k_pool.shape} {v_pool.shape}")
    k_new, v_new = token_view(name, k_new, B, NKV, D), token_view(name, v_new, B, NKV, Dv)
    if k_new.device != k_pool.device or v_new.device != k_pool.device or k_new.dtype != v_new.dtype:
        raise ValueError(f"{name}: K and V tokens must share the pool's device and one dtype")
    if quant and max(D, Dv) > 128:
        raise ValueError(f"{name}: the quantizing write takes head dims up to 128")
    if (lengths.shape != (B,) or lengths.dtype != torch.int32 or tables.dtype != torch.int32
            or not 0 <= layer < L):
        raise ValueError(f"{name}: lengths [B] and tables must be int32 and layer in range")
    err = _lib.lib().dsocr_paged_kv_write(
        k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        ks_pool[layer].data_ptr() if quant else None, vs_pool[layer].data_ptr() if quant else None,
        k_new.data_ptr(), v_new.data_ptr(), tables.data_ptr(), lengths.data_ptr(), k_new.stride(0),
        k_new.stride(1), v_new.stride(0), v_new.stride(1), B, NKV, P, page, P_max, D, Dv,
        _lib.DTYPE_CODES[k_new.dtype], _lib.DTYPE_CODES[k_pool.dtype], _lib.stream_ptr(k_pool),
    )
    _lib.check(err, name)
    _lib.count_launch(paged_kv_write)


paged_kv_write.launches = 0


def _rows(plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One layer's [P, NKV, page, ...] → each row's pages gathered in table
    order, [B, NKV, P_max·page, ...]."""
    g = plane[ids]  # [B, P_max, NKV, page, ...]
    B, P_max, NKV, page = g.shape[:4]
    return g.transpose(1, 2).reshape(B, NKV, P_max * page, *g.shape[4:])


def paged_decode_attention_plain(q, k_pool, v_pool, ks_pool, vs_pool, tables, lengths,
                                 layer: int, *, scale: float):
    """Each row's pages gathered contiguously, positions past lengths[b]
    or on no page zeroed and masked, then the contiguous attention
    (ops/attention.py: attention / attention_kv_int8) in f32."""
    P, page = k_pool.shape[1], k_pool.shape[3]
    P_max = tables.shape[1]
    ids, present = _pages(tables, P)
    pos = torch.arange(P_max * page, device=q.device)
    live = (pos[None, :] <= lengths.long()[:, None]) & present.repeat_interleave(page, dim=1)

    def gather(pool):
        rows = _rows(pool[layer], ids)
        mask = live[:, None, :, None] if rows.dim() == 4 else live[:, None, :]
        return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    mask = live[:, None, None, :]  # [B, 1, 1, S]
    qf = q.float()[:, :, None]  # [B, NH, 1, D]
    if ks_pool is not None:
        out = attention_kv_int8(qf, gather(k_pool), gather(ks_pool), gather(v_pool),
                                gather(vs_pool), mask, scale)
    else:
        out = attention(qf, gather(k_pool), gather(v_pool), mask, scale)
    return out[:, 0]


def paged_decode_attention(q, k_pool, v_pool, ks_pool, vs_pool, tables, lengths, layer: int,
                           *, scale: float):
    """q [B, NH, D] f32 attends [0, lengths[b]] of `layer` through the page
    tables → [B, NH·Dv] f32. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, ks_pool, vs_pool, tables,
                                            lengths, layer, scale=scale)
    name = "paged_decode_attention"
    _lib.require_cuda(name, q, k_pool, v_pool, ks_pool, vs_pool, tables, lengths)
    B, NH, D = q.shape
    L, P, NKV, page, Dv = v_pool.shape
    P_max = tables.shape[1]
    if k_pool.shape != (L, P, NKV, page, D) or NH % NKV or NH // NKV > 8 or tables.shape[0] != B:
        raise ValueError(f"{name}: bad shapes {q.shape} {k_pool.shape} {v_pool.shape}")
    if D > 128 or Dv > 128:
        raise ValueError(f"{name}: head dims above 128 are not supported")
    if q.dtype != torch.float32 or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"{name}: q must be f32, got {q.dtype} with {k_pool.dtype} pools")
    quant = k_pool.dtype == torch.int8
    if quant != (ks_pool is not None and vs_pool is not None):
        raise ValueError(f"{name}: scale planes go with int8 pools only")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32 or not 0 <= layer < L:
        raise ValueError(f"{name}: lengths and tables must be int32 and layer in range")
    out = torch.empty((B, NH * Dv), dtype=torch.float32, device=q.device)
    splits, part = _lib.decode_partials(B, NKV, P_max * page, NH // NKV, Dv, q.device)
    err = _lib.lib().dsocr_paged_decode_attention(
        q.data_ptr(), k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        ks_pool[layer].data_ptr() if quant else None,
        vs_pool[layer].data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(), part.data_ptr(), out.data_ptr(), B, NH, NKV, P,
        page, P_max, D, Dv, float(scale), splits, _lib.DTYPE_CODES[k_pool.dtype],
        _lib.stream_ptr(q),
    )
    _lib.check(err, name)
    _lib.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
