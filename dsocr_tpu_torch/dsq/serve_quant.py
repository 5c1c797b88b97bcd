"""Packing for serving (dsocr_tpu/dsq/serve_quant.py: Q8_0, Q4_K, Q6_K).

Torch functions on any device, so the full-width decoder (~2.4 G expert
weights) is quantized on the card instead of in NumPy on the host. Q8_0
is bit-exact with the reference's ``q8_rows``: amax/127 in f32, codes
from the f32 inverse rounded half away from zero and clipped, the
returned scale rounded through f16 (what a Q8_0 payload stores). Q4_K
and Q6_K are bit-exact with the reference's NumPy ``quantize_q4_k`` and
``quantize_q6_k`` (dsq/quant.py).

Layouts. Q8_0 keeps the reference's:
  plain linears [.., in, out] → {codes [.., out, in] int8,
                                 scales [.., out, in/32] f32}  (row layout)
  expert stacks [.., E, in, out] → {codes [.., E, in, out] int8,
                                    scales [.., E, in/32, out] f32}  (in-major)
The K-quants pack adjacent in-values into a byte (``pack_bits``), the
first in the low bits, not the reference's plane split. Q4_K keeps two
4-bit codes per byte and per 32 values an f32 scale s = d·sc and an f32
min b = dmin·m (the weight is q·s − b):
  plain linears → {codes [.., out, in/2] uint8, scales, mins [.., out, in/32]}
  expert stacks → {codes [.., E, in/2, out] uint8, scales, mins [.., E, in/32, out]}
Q6_K keeps the low 4 bits of its 6-bit codes as Q4_K keeps its codes, the
2-bit high parts four to a byte, and per 16 values an f32 scale s = d·sc
(the weight is (q − 32)·s); 1.0 byte per weight, as the reference's planes:
  plain linears → {codes [.., out, in/2], highs [.., out, in/4] uint8,
                   scales [.., out, in/16]}
  expert stacks → {codes [.., E, in/2, out], highs [.., E, in/4, out] uint8,
                   scales [.., E, in/16, out]}
A K-quant needs in % 256 == 0; other weights fall back to Q8_0 per
tensor (``effective_method``), as the reference does.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from .quant import QK_K, q4k_rows, q6k_rows

Q8_BLOCK = 32
METHODS = ("q8_0", "q4_k", "q6_k")
KQ_CHUNK = 1 << 24  # weights per K-quant row call: few launches, a bounded working set


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
    return effective_method(method, in_dim)


def pack_bits(values: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """uint8 values below 2**bits → bytes along `dim`: 8 // bits adjacent
    values per byte, value n·j + i (n = 8 // bits) at bit bits·i of byte j."""
    dim %= values.dim()
    groups = values.unflatten(dim, (-1, 8 // bits))
    out = groups.select(dim + 1, 0).clone()
    for i in range(1, 8 // bits):
        out |= groups.select(dim + 1, i) << (bits * i)
    return out.contiguous()


def unpack_bits(packed: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """The inverse of pack_bits: bytes → uint8 values, 8 // bits times as
    long along `dim`."""
    dim %= packed.dim()
    mask = (1 << bits) - 1
    fields = [(packed >> (bits * i)) & mask for i in range(8 // bits)]
    return torch.stack(fields, dim=dim + 1).flatten(dim, dim + 1)


def _kquant_rows(method: str, rows: torch.Tensor):
    """[R, in] → the K-quant's packed parts along the last dim (module
    docstring), q4k_rows / q6k_rows in chunks of ~KQ_CHUNK weights."""
    fn = q4k_rows if method == "q4_k" else q6k_rows
    step = max(1, KQ_CHUNK // rows.shape[1])
    parts = [fn(rows[r : r + step]) for r in range(0, rows.shape[0], step)]
    out = [torch.cat(p) for p in zip(*parts)]
    if method == "q4_k":
        codes, scales, mins = out
        return {"codes": pack_bits(codes, -1, 4), "scales": scales, "mins": mins}
    codes, scales = out
    return {"codes": pack_bits(codes & 0xF, -1, 4), "highs": pack_bits(codes >> 4, -1, 2),
            "scales": scales}


def quantize_plain(w: torch.Tensor, method: str = "q8_0") -> Union[torch.Tensor, Dict]:
    """[.., in, out] float → packed row layout (module docstring); in dims
    that miss the Q8_0 block stay float (returned unchanged)."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    rows = w.reshape(-1, i, o).transpose(1, 2).reshape(-1, i)
    method = _resolve(method, i)
    if method != "q8_0":
        return {key: t.reshape(*lead, o, -1) for key, t in _kquant_rows(method, rows).items()}
    codes, scales = q8_rows(rows)
    return {
        "codes": codes.reshape(*lead, o, i).contiguous(),
        "scales": scales.reshape(*lead, o, i // Q8_BLOCK).contiguous(),
    }


def quantize_expert_stack(w: torch.Tensor, method: str = "q8_0") -> Union[torch.Tensor, Dict]:
    """[.., E, in, out] float → packed in-major layout (module docstring);
    Q8_0 one expert at a time to bound the f32 working set; in dims that
    miss the Q8_0 block stay float."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    flat = w.reshape(-1, i, o)
    method = _resolve(method, i)
    if method != "q8_0":
        g = flat.shape[0]
        packed = _kquant_rows(method, flat.transpose(1, 2).reshape(-1, i))  # rows = output columns
        return {key: t.reshape(g, o, -1).transpose(1, 2).contiguous().reshape(*lead, -1, o)
                for key, t in packed.items()}
    codes = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scales = torch.empty((flat.shape[0], i // Q8_BLOCK, o), dtype=torch.float32, device=w.device)
    for e in range(flat.shape[0]):
        c, s = q8_rows(flat[e].t())  # rows = output columns
        codes[e] = c.t()
        scales[e] = s.t()
    return {"codes": codes.reshape(*lead, i, o), "scales": scales.reshape(*lead, i // Q8_BLOCK, o)}
