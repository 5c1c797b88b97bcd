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

Raw payloads (the reference's ``raw=``): a snapshot's published ggml
bytes for a weight are decoded on the device straight into these layouts
(``raw_payload_for``: the method must match and the byte count check out,
else the float is packed, as the reference falls back); the decode gives
what quantizing the weights the payload was made from gives, so the two
routes pack the same tensors. ``fused_raw`` concatenates the parts' payloads
of a fused projection, ``collect_raw_plain`` gathers a stacked linear's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch

from .quant import (
    Q4K_BLOCK_BYTES,
    Q6K_BLOCK_BYTES,
    Q8_BLOCK,
    Q8_BLOCK_BYTES,
    QK_K,
    as_payload,
    q4k_rows,
    q4k_rows_from_payload,
    q6k_rows,
    q6k_rows_from_payload,
    q8_rows,
    q8_rows_from_payload,
)

METHODS = ("q8_0", "q4_k", "q6_k")
KQ_CHUNK = 1 << 24  # weights per K-quant row call: few launches, a bounded working set
PAYLOAD_BYTES_PER_ROW = {  # ggml block bytes per weight row of length i
    "q8_0": lambda i: (i // Q8_BLOCK) * Q8_BLOCK_BYTES,
    "q4_k": lambda i: (i // QK_K) * Q4K_BLOCK_BYTES,
    "q6_k": lambda i: (i // QK_K) * Q6K_BLOCK_BYTES,
}


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


def raw_payload_for(raw, method: str, rows: int, i: int, device=None) -> Optional[torch.Tensor]:
    """The payload of `rows` weight rows of length i as one uint8 tensor on
    `device`, when `raw` ({"method", "layers": payloads per layer, or per
    expert of a layer}) holds them under this method with the right byte
    count; else None."""
    if raw is None or raw.get("method") != method:
        return None
    flat = []
    for layer in raw["layers"]:
        flat.extend(layer if isinstance(layer, (list, tuple)) else [layer])
    parts = [as_payload(p) for p in flat]
    if sum(p.numel() for p in parts) != rows * PAYLOAD_BYTES_PER_ROW[method](i):
        return None
    return torch.cat([p.to(device) for p in parts])


def _row_parts(method: str, rows: Optional[torch.Tensor], payload: Optional[torch.Tensor],
               n: int, i: int) -> Dict[str, torch.Tensor]:
    """n weight rows of length i → the method's packed parts along the last
    dim (module docstring): quantized from `rows` [n, i], or decoded from
    their ggml `payload`; K-quants in chunks of ~KQ_CHUNK weights."""
    if method == "q8_0":
        codes, scales = q8_rows(rows) if payload is None else q8_rows_from_payload(payload, n, i)
        return {"codes": codes, "scales": scales}
    step = max(1, KQ_CHUNK // i)
    if payload is None:
        fn = q4k_rows if method == "q4_k" else q6k_rows
        chunks = (fn(rows[a : a + step]) for a in range(0, n, step))
    else:
        fn = q4k_rows_from_payload if method == "q4_k" else q6k_rows_from_payload
        width = PAYLOAD_BYTES_PER_ROW[method](i)
        chunks = (fn(payload[a * width : min(a + step, n) * width], min(step, n - a), i)
                  for a in range(0, n, step))
    out = [torch.cat(p) for p in zip(*chunks)]
    if method == "q4_k":
        codes, scales, mins = out
        return {"codes": pack_bits(codes, -1, 4), "scales": scales, "mins": mins}
    codes, scales = out
    return {"codes": pack_bits(codes & 0xF, -1, 4), "highs": pack_bits(codes >> 4, -1, 2),
            "scales": scales}


def quantize_plain(w: torch.Tensor, method: str = "q8_0", raw=None) -> Union[torch.Tensor, Dict]:
    """[.., in, out] float → packed row layout (module docstring), from the
    snapshot's payload where `raw` holds it; in dims that miss the Q8_0
    block stay float (returned unchanged)."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    method = _resolve(method, i)
    n = math.prod(lead) * o
    payload = raw_payload_for(raw, method, n, i, w.device)
    rows = None if payload is not None else w.reshape(-1, i, o).transpose(1, 2).reshape(-1, i)
    return {key: t.reshape(*lead, o, -1).contiguous()
            for key, t in _row_parts(method, rows, payload, n, i).items()}


def quantize_expert_stack(w: torch.Tensor, method: str = "q8_0", raw=None) -> Union[torch.Tensor, Dict]:
    """[.., E, in, out] float → packed in-major layout (module docstring),
    from the snapshot's payloads (expert-major) where `raw` holds them;
    Q8_0 from floats one expert at a time to bound the f32 working set; in
    dims that miss the Q8_0 block stay float."""
    *lead, i, o = w.shape
    if i % Q8_BLOCK:
        return w
    flat = w.reshape(-1, i, o)
    g = flat.shape[0]
    method = _resolve(method, i)
    payload = raw_payload_for(raw, method, g * o, i, w.device)
    if method == "q8_0" and payload is None:
        codes = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
        scales = torch.empty((g, i // Q8_BLOCK, o), dtype=torch.float32, device=w.device)
        for e in range(g):
            c, s = q8_rows(flat[e].t())  # rows = output columns
            codes[e] = c.t()
            scales[e] = s.t()
        return {"codes": codes.reshape(*lead, i, o), "scales": scales.reshape(*lead, i // Q8_BLOCK, o)}
    rows = None if payload is not None else flat.transpose(1, 2).reshape(-1, i)  # rows = output columns
    return {key: t.reshape(g, o, -1).transpose(1, 2).contiguous().reshape(*lead, -1, o)
            for key, t in _row_parts(method, rows, payload, g * o, i).items()}


def fused_raw(raw: Dict, group: str, key: str, fused_from: Dict,
              layers: Optional[Sequence[int]] = None) -> Optional[Dict]:
    """Raw payloads of `key` (of the given layers, all by default): its own
    entry, or for a projection fused at init (fusion concatenates along the
    out dim) the parts' payloads concatenated in fuse order, per layer (per
    expert for expert stacks), where every part has one with one method.
    `fused_from` maps a fused key to its source keys."""
    ent = raw.get((group, key))
    if ent is not None:
        picked = ent["layers"] if layers is None else [ent["layers"][l] for l in layers]
        return {"method": ent["method"], "layers": picked}
    parts_keys = fused_from.get(key)
    if parts_keys is None:
        return None
    parts = [raw.get((group, k)) for k in parts_keys]
    if any(p is None for p in parts) or len({p["method"] for p in parts}) != 1:
        return None

    def cat(payloads):
        return torch.cat([as_payload(p) for p in payloads])

    out = []
    for l in range(len(parts[0]["layers"])) if layers is None else layers:
        first = parts[0]["layers"][l]
        if isinstance(first, (list, tuple)):  # per-expert nesting
            out.append([cat([p["layers"][l][e] for p in parts]) for e in range(len(first))])
        else:
            out.append(cat([p["layers"][l] for p in parts]))
    return {"method": parts[0]["method"], "layers": out}


def collect_raw_plain(reader, raw: Dict, group: str, key: str, names) -> None:
    """Record the snapshot's raw payloads of a stacked plain linear when
    every layer's record exists with one dtype. `names`: the per-layer
    tensor names (without ``.weight``)."""
    hits = [reader.raw_quant(f"{name}.weight") for name in names]
    if not hits or any(h is None for h in hits) or len({h[1] for h in hits}) != 1:
        return
    raw[(group, key)] = {"method": hits[0][1].lower(), "layers": [h[0] for h in hits]}
