"""Scaled dot-product attention with GQA, the int8 KV quantizer, and the
slot-mode KV write + attend over the contiguous slot cache or the paged
pool (dsocr_tpu/ops/attention.py; the paged branch of
dsocr_tpu/models/deepseek/decoder.py).

Scores and softmax run in f32 and the value sum accumulates in f32; the
output is cast to q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def repeat_kv(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """[B, H_kv, S, D] → [B, H_kv*repeats, S, D] (GQA head expansion)."""
    return x if repeats == 1 else x.repeat_interleave(repeats, dim=1)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] bool: query (q_offset + i) may attend kv j <= it."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H_kv, Skv, D]
    v: torch.Tensor,  # [B, H_kv, Skv, Dv]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Skv]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, Sq, H*Dv] in q.dtype; a masked score is -1e30."""
    H, H_kv = q.shape[1], k.shape[1]
    if H_kv != H:
        k = repeat_kv(k, H // H_kv)
        v = repeat_kv(v, H // H_kv)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    out = torch.matmul(torch.softmax(scores, dim=-1), v.float())
    B, _, Sq, Dv = out.shape
    return out.transpose(1, 2).reshape(B, Sq, H * Dv).to(q.dtype)


def quantize_kv_int8(x: torch.Tensor):
    """[..., S, D] → (codes int8, scale f32 [..., S]): symmetric per-token
    max-abs scaling, round half to even, safe scale 1.0 where amax is 0.
    Bit-exact with the reference (torch.round and jnp.round both round
    half to even), on the card too: the divisor is a tensor, since
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which moves some scales by an ulp."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax / amax.new_full((), 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(x32 / safe[..., None]).clamp(-127, 127).to(torch.int8)
    return codes, scale


def attention_kv_int8(
    q: torch.Tensor,  # [B, H, Sq, D]
    k_codes: torch.Tensor,  # [B, H_kv, Skv, D] int8
    k_scale: torch.Tensor,  # [B, H_kv, Skv] f32
    v_codes: torch.Tensor,  # [B, H_kv, Skv, Dv] int8
    v_scale: torch.Tensor,  # [B, H_kv, Skv] f32
    mask: Optional[torch.Tensor] = None,  # [B, 1, Sq|1, Skv]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """attention() over an int8 KV cache: k scales fold into the scores,
    v scales into the softmax weights; GQA runs grouped (no repeat)."""
    B, NH, Sq, D = q.shape
    NKV = k_codes.shape[1]
    G = NH // NKV
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.float().reshape(B, NKV, G, Sq, D)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k_codes.float()) * (
        k_scale[:, :, None, None, :] * scale
    )
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1) * v_scale[:, :, None, None, :]
    out = torch.einsum("bkgqs,bksd->bkgqd", weights, v_codes.float())
    Dv = out.shape[-1]
    return out.reshape(B, NH, Sq, Dv).transpose(1, 2).reshape(B, Sq, NH * Dv).to(q.dtype)


def slot_kv_write_attend(
    q: torch.Tensor,  # [B, NH, 1, D]
    k: torch.Tensor,  # [B, H_kv, 1, D] new token K (model dtype)
    v: torch.Tensor,  # [B, H_kv, 1, Dv]
    k_all: torch.Tensor,  # [L, B, H_kv, S_max, D] int8 codes or model dtype
    v_all: torch.Tensor,
    ks_all: Optional[torch.Tensor],  # [L, B, H_kv, S_max] f32 scales or None
    vs_all: Optional[torch.Tensor],
    layer: int,
    row_lengths: torch.Tensor,  # [B] int32 per-row write positions
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Write row r's new K/V at row_lengths[r] of `layer` (in place) and
    attend over [0, row_lengths[r]] of that layer → [B, 1, NH*Dv].

    With scale planes the caches hold int8 codes plus per-token scales,
    and the write quantizes the new token itself (in its kernel on the
    card). Both steps go through the slot kernels
    (ops/kernels/slot_attention.py): the CUDA kernels on the card, their
    plain twins on the CPU."""
    from .kernels import slot_decode_attention, slot_kv_write

    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    slot_kv_write(k_all, v_all, ks_all, vs_all, k, v, layer, row_lengths)
    return slot_decode_attention(
        q.contiguous(), k_all, v_all, ks_all, vs_all, layer, row_lengths, scale=scale
    )


def paged_kv_write_attend(
    q: torch.Tensor,  # [B, NH, 1, D]
    k: torch.Tensor,  # [B, H_kv, 1, D] new token K (model dtype)
    v: torch.Tensor,  # [B, H_kv, 1, Dv]
    k_pool: torch.Tensor,  # [L, P, H_kv, page, D] int8 codes or model dtype
    v_pool: torch.Tensor,
    ks_pool: Optional[torch.Tensor],  # [L, P, H_kv, page] f32 scales or None
    vs_pool: Optional[torch.Tensor],
    tables: torch.Tensor,  # [B, P_max] int32 page ids
    layer: int,
    row_lengths: torch.Tensor,  # [B] int32 per-row write positions
    scale: float,
) -> torch.Tensor:
    """The paged counterpart of slot_kv_write_attend: write row r's new K/V
    at position row_lengths[r] through its page table (in place), then
    attend [0, row_lengths[r]] → [B, 1, NH*Dv] in q's dtype. As in the
    reference, the attend takes q in f32 and returns f32. Both steps go
    through the paged kernels (ops/kernels/paged_attention.py); the write
    quantizes the new token itself for an int8 pool."""
    from .kernels import paged_decode_attention, paged_kv_write

    paged_kv_write(k_pool, v_pool, ks_pool, vs_pool, k, v, tables, row_lengths, layer)
    ctx = paged_decode_attention(q[:, :, 0].float().contiguous(), k_pool, v_pool, ks_pool,
                                 vs_pool, tables, row_lengths, layer, scale=scale)
    return ctx[:, None].to(q.dtype)
