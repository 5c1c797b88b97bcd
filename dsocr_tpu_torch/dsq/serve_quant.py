"""Packing for serving (dsocr_tpu/dsq/serve_quant.py, Q8_0 and Q4_K).

Torch functions on any device, so the full-width decoder (~2.4 G expert
weights) is quantized on the card instead of in NumPy on the host. Q8_0
is bit-exact with the reference's ``q8_rows``: amax/127 in f32, codes
from the f32 inverse rounded half away from zero and clipped, the
returned scale rounded through f16 (what a Q8_0 payload stores). Q4_K is
bit-exact with the reference's NumPy ``quantize_q4_k`` (dsq/quant.py).

Layouts. Q8_0 keeps the reference's:
  plain linears [.., in, out] → {codes [.., out, in] int8,
                                 scales [.., out, in/32] f32}  (row layout)
  expert stacks [.., E, in, out] → {codes [.., E, in, out] int8,
                                    scales [.., E, in/32, out] f32}  (in-major)
Q4_K packs two 4-bit codes per byte, adjacent k values, the even k in the
low nibble, and keeps per 32 values an f32 scale s = d·sc and an f32 min
b = dmin·m (the weight is q·s − b); not the reference's plane split:
  plain linears → {codes [.., out, in/2] uint8, scales, mins [.., out, in/32]}
  expert stacks → {codes [.., E, in/2, out] uint8, scales, mins [.., E, in/32, out]}
A K-quant needs in % 256 == 0; other weights fall back to Q8_0 per
tensor (``effective_method``), as the reference does. Q6_K is not ported
yet (ROADMAP Queue 1) and raises.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from .quant import Q4K_SUB, QK_K, q4k_rows

Q8_BLOCK = 32
METHODS = ("q8_0", "q4_k", "q6_k")
Q4K_CHUNK = 1 << 24  # weights per q4k_rows call: few launches, a bounded working set


def q8_rows(rows: torch.Tensor):
    """[R, K] float → (codes [R, K] int8, scales [R, K/32] f32)."""
    r, k = rows.shape
    x = rows.float().reshape(r, k // Q8_BLOCK, Q8_BLOCK)
    amax = x.abs().amax(dim=-1)
    zero = torch.zeros_like(amax)
    # a tensor divisor: CUDA divides by a scalar as a product with its
    # reciprocal, which is not the correctly rounded quotient
    scale = torch.where(amax > 0.0, amax / torch.full_like(amax, 127.0), zero)
    nonzero = scale != 0.0
    inv = torch.where(nonzero, torch.div(torch.ones_like(scale), torch.where(nonzero, scale, 1.0)), zero)
    t = x * inv[..., None]
    # round half away from zero (Rust f32::round), not torch.round's half-to-even
    q = torch.where(t >= 0.0, torch.floor(t + 0.5), torch.ceil(t - 0.5)).clamp_(-128, 127)
    codes = torch.where(nonzero[..., None], q, 0.0).to(torch.int8)
    return codes.reshape(r, k), scale.to(torch.float16).float()


def effective_method(method: str, in_dim: int) -> str:
    """k-quants need 256-element super-blocks along the contraction dim;
    ineligible tensors fall back to Q8_0."""
    if method in ("q4_k", "q6_k") and in_dim % QK_K != 0:
        return "q8_0"
    return method


def _resolve(method: str, in_dim: int) -> str:
    """The method a weight of this in dim packs with; raises for methods
    the port does not serve."""
    if method not in METHODS:
        raise NotImplementedError(f"runtime quantization `{method}` not supported")
    method = effective_method(method, in_dim)
    if method == "q6_k":
        raise NotImplementedError("q6_k packing is not ported yet (ROADMAP Queue 1: the Q6_K kernels)")
    return method


def pack_nibbles(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """4-bit codes (uint8 0..15) → bytes along `dim`: k = 2j in the low
    nibble of byte j, k = 2j + 1 in the high one."""
    dim %= codes.dim()
    pairs = codes.unflatten(dim, (-1, 2))
    return (pairs.select(dim + 1, 0) | (pairs.select(dim + 1, 1) << 4)).contiguous()


def unpack_nibbles(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of pack_nibbles: bytes → uint8 codes, twice as long
    along `dim`."""
    dim %= packed.dim()
    return torch.stack((packed & 0xF, packed >> 4), dim=dim + 1).flatten(dim, dim + 1)


def quantize_plain(w: torch.Tensor, method: str = "q8_0") -> Union[torch.Tensor, Dict]:
    """[.., in, out] float → packed row layout (module docstring); in dims
    that miss the Q8_0 block stay float (returned unchanged)."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    rows = w.reshape(-1, i, o).transpose(1, 2).reshape(-1, i)
    if _resolve(method, i) == "q4_k":
        codes, scales, mins = _q4k_rows_chunked(rows)
        return {
            "codes": pack_nibbles(codes, -1).reshape(*lead, o, i // 2),
            "scales": scales.reshape(*lead, o, i // Q4K_SUB).contiguous(),
            "mins": mins.reshape(*lead, o, i // Q4K_SUB).contiguous(),
        }
    codes, scales = q8_rows(rows)
    return {
        "codes": codes.reshape(*lead, o, i).contiguous(),
        "scales": scales.reshape(*lead, o, i // Q8_BLOCK).contiguous(),
    }


def _q4k_rows_chunked(rows: torch.Tensor):
    """q4k_rows over [R, in] in chunks of ~Q4K_CHUNK weights."""
    step = max(1, Q4K_CHUNK // rows.shape[1])
    parts = [q4k_rows(rows[r : r + step]) for r in range(0, rows.shape[0], step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def quantize_expert_stack(w: torch.Tensor, method: str = "q8_0") -> Union[torch.Tensor, Dict]:
    """[.., E, in, out] float → packed in-major layout (module docstring);
    Q8_0 one expert at a time to bound the f32 working set; in dims that
    miss the Q8_0 block stay float."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    flat = w.reshape(-1, i, o)
    if _resolve(method, i) == "q4_k":
        g = flat.shape[0]
        codes, scales, mins = _q4k_rows_chunked(flat.transpose(1, 2).reshape(-1, i))  # rows = output columns
        in_major = lambda t: t.reshape(g, o, -1).transpose(1, 2).contiguous()  # noqa: E731
        return {"codes": pack_nibbles(in_major(codes), 1).reshape(*lead, i // 2, o),
                "scales": in_major(scales).reshape(*lead, i // Q4K_SUB, o),
                "mins": in_major(mins).reshape(*lead, i // Q4K_SUB, o)}
    codes = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scales = torch.empty((flat.shape[0], i // Q8_BLOCK, o), dtype=torch.float32, device=w.device)
    for e in range(flat.shape[0]):
        c, s = q8_rows(flat[e].t())  # rows = output columns
        codes[e] = c.t()
        scales[e] = s.t()
    return {"codes": codes.reshape(*lead, i, o), "scales": scales.reshape(*lead, i // Q8_BLOCK, o)}
