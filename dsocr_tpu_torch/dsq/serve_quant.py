"""Q8_0 packing for serving (dsocr_tpu/dsq/serve_quant.py, Q8_0 half).

Torch functions on any device, so the full-width decoder (~2.4 G expert
weights) is quantized on the card instead of in NumPy on the host. The
results are bit-exact with the reference's ``q8_rows``: amax/127 in f32,
codes from the f32 inverse rounded half away from zero and clipped, the
returned scale rounded through f16 (what a Q8_0 payload stores).

Layouts (the reference's):
  plain linears [.., in, out] → {codes [.., out, in] int8,
                                 scales [.., out, in/32] f32}  (row layout)
  expert stacks [.., E, in, out] → {codes [.., E, in, out] int8,
                                    scales [.., E, in/32, out] f32}  (in-major)
Q4_K/Q6_K are not ported yet (ROADMAP Queue 1) and raise.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

Q8_BLOCK = 32
METHODS = ("q8_0", "q4_k", "q6_k")


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
    if method in ("q4_k", "q6_k") and in_dim % 256 != 0:
        return "q8_0"
    return method


def _require_q8(method: str) -> None:
    if method not in METHODS:
        raise NotImplementedError(f"runtime quantization `{method}` not supported")
    if method != "q8_0":
        raise NotImplementedError(
            f"{method} packing is not ported yet (ROADMAP Queue 1: the K-quant kernels)"
        )


def quantize_plain(w: torch.Tensor, method: str = "q8_0") -> Union[torch.Tensor, Dict]:
    """[.., in, out] float → {codes [.., out, in], scales [.., out, in/32]};
    in dims that miss the Q8_0 block stay float (returned unchanged)."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    _require_q8(effective_method(method, i))
    codes, scales = q8_rows(w.reshape(-1, i, o).transpose(1, 2).reshape(-1, i))
    return {
        "codes": codes.reshape(*lead, o, i).contiguous(),
        "scales": scales.reshape(*lead, o, i // Q8_BLOCK).contiguous(),
    }


def quantize_expert_stack(w: torch.Tensor, method: str = "q8_0") -> Union[torch.Tensor, Dict]:
    """[.., E, in, out] float → in-major {codes [.., E, in, out],
    scales [.., E, in/32, out]}, one expert at a time to bound the f32
    working set; in dims that miss the block stay float."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    _require_q8(effective_method(method, i))
    flat = w.reshape(-1, i, o)
    codes = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scales = torch.empty((flat.shape[0], i // Q8_BLOCK, o), dtype=torch.float32, device=w.device)
    for e in range(flat.shape[0]):
        c, s = q8_rows(flat[e].t())  # rows = output columns
        codes[e] = c.t()
        scales[e] = s.t()
    return {"codes": codes.reshape(*lead, i, o), "scales": scales.reshape(*lead, i // Q8_BLOCK, o)}
