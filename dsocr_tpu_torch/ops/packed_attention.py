"""Frame-blocked full attention over a packed vision token sequence
(dsocr_tpu/ops/packed_attention.py: ``segment_attention``).

The DotsVision and GLM towers pack every frame of a call into one token
sequence, and a token attends only to the tokens of its own frame. The
reference carries the frames as per-token segment ids under a mask, so
that one compiled graph serves every padded length (``bucket_tokens``);
the port runs eagerly, pads nothing and reads the frames from the ids on
the host: each frame is one contiguous run of equal ids, and the frames
of one length go through one attention call as a batch.

On the card that call is ``F.scaled_dot_product_attention`` in the
activation dtype, restricted to the fused backends (flash or memory
efficient; at f32 the memory-efficient one only), so that no [NH, N, N]
score tensor is built (a 24,576-patch GLM page would need 29 GB of f32
scores) and a missing backend raises. This is plain attention in the
reference too, not a Pallas kernel, so the library's call computes it. On
the CPU the same frames run ``ops.attention`` (f32 scores and softmax,
cast back), which builds the scores of one frame batch at a time.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .attention import attention


def frame_runs(seg) -> List[Tuple[int, int]]:
    """Segment ids [N] on the host → the (start, length) of each run of
    equal ids; an id that comes back after another raises, since frames
    are packed one after another."""
    ids = np.asarray(seg).reshape(-1)
    if ids.size == 0:
        return []
    edges = np.flatnonzero(ids[1:] != ids[:-1]) + 1
    starts = np.concatenate([[0], edges])
    lengths = np.diff(np.concatenate([starts, [ids.size]]))
    if len(set(ids[starts].tolist())) != len(starts):
        raise ValueError("segment ids must form one contiguous run per frame")
    return [(int(s), int(n)) for s, n in zip(starts, lengths)]


def _backends(dtype: torch.dtype):
    from torch.nn.attention import SDPBackend

    if dtype == torch.float32:
        return [SDPBackend.EFFICIENT_ATTENTION]
    return [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[F, NH, L, D] frames → [F, L, NH·D] in q's dtype."""
    if q.device.type == "cpu":
        return attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"segment_attention runs on cpu or cuda tensors, not {q.device.type}")
    from torch.nn.attention import sdpa_kernel

    with sdpa_kernel(_backends(q.dtype)):
        out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).flatten(2)


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg) -> torch.Tensor:
    """q/k/v [N, NH, D], seg [N] frame ids (one contiguous run a frame) →
    [N, NH, D] in q's dtype: softmax(q·kᵀ/√D)·v within each frame."""
    n, nh, d = q.shape
    runs = frame_runs(seg)
    if sum(length for _, length in runs) != n:
        raise ValueError(f"segment ids cover {sum(length for _, length in runs)} of {n} tokens")
    out = torch.empty((n, nh * d), dtype=q.dtype, device=q.device)
    by_length: Dict[int, List[int]] = {}
    for start, length in runs:
        by_length.setdefault(length, []).append(start)
    for length, starts in by_length.items():
        count = len(starts)
        if starts[-1] - starts[0] == (count - 1) * length:  # adjacent frames: a view
            rows = slice(starts[0], starts[0] + count * length)
        else:
            base = torch.tensor(starts, dtype=torch.long)
            rows = (base[:, None] + torch.arange(length)[None, :]).reshape(-1).to(q.device)

        def frames(t):  # [F·L, NH, D] → [F, NH, L, D]
            return t[rows].reshape(count, length, nh, d).transpose(1, 2)

        out[rows] = _attend(frames(q), frames(k), frames(v)).reshape(-1, nh * d)
    return out.reshape(n, nh, d)

