"""Token selection: repetition penalty, no-repeat-ngram ban, top-k/top-p,
greedy argmax with first-index ties (dsocr_tpu/core/sampling.py).

Two halves, as in the reference:

- host (NumPy): the executable spec, used for one-off host selection;
  a copy of the reference's host half (jax-free already);
- device (PyTorch): fixed-shape tensor ops over per-row knobs, run inside
  the slot decode loop so logits never leave the device and no step
  syncs with the host.

Sampled tokens come from an explicit torch.Generator and differ from the
reference's random stream; greedy selection is identical.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host (NumPy) implementation — executable spec
# ---------------------------------------------------------------------------


def apply_repetition_penalty_host(
    scores: np.ndarray, context: Sequence[int], penalty: float
) -> None:
    """In-place: seen-token scores divided (if >0) or multiplied (if <=0)."""
    if penalty <= 0.0 or abs(penalty - 1.0) <= np.finfo(np.float32).eps:
        return
    penalty = max(penalty, np.finfo(np.float32).tiny)
    seen = set()
    for token in context:
        idx = int(token)
        if 0 <= idx < scores.shape[0] and idx not in seen:
            seen.add(idx)
            if scores[idx] > 0.0:
                scores[idx] /= penalty
            else:
                scores[idx] *= penalty


def banned_ngram_tokens_host(sequence: Sequence[int], ngram: int) -> set:
    """Tokens that would complete an already-seen ngram at the current
    position (HF no_repeat_ngram semantics)."""
    banned: set = set()
    seq = list(sequence)
    if ngram <= 1 or len(seq) < ngram - 1:
        return banned
    history: dict = {}
    for i in range(len(seq) - ngram + 1):
        window = seq[i : i + ngram]
        prefix = tuple(window[: ngram - 1])
        history.setdefault(prefix, set()).add(window[ngram - 1])
    prefix = tuple(seq[len(seq) - (ngram - 1) :])
    if prefix in history:
        banned |= history[prefix]
    return banned


def _argmax_first_tie(values: np.ndarray) -> Optional[int]:
    """First-index argmax over finite values; None if none are finite."""
    finite = np.isfinite(values)
    if not finite.any():
        return None
    masked = np.where(finite, values, -np.inf)
    return int(np.argmax(masked))


def _apply_top_k_host(logits: np.ndarray, top_k: int) -> None:
    finite_idx = np.flatnonzero(np.isfinite(logits))
    if top_k == 0 or finite_idx.size <= top_k:
        return
    # Stable sort descending by value; drop everything past the k-th.
    order = finite_idx[np.argsort(-logits[finite_idx], kind="stable")]
    logits[order[top_k:]] = -np.inf


def _apply_top_p_host(logits: np.ndarray, top_p: float) -> None:
    if not (0.0 <= top_p < 1.0):
        return
    finite_idx = np.flatnonzero(np.isfinite(logits))
    if finite_idx.size == 0:
        return
    order = finite_idx[np.argsort(-logits[finite_idx], kind="stable")]
    vals = logits[order]
    weights = np.exp(vals - vals[0])
    total = weights.sum()
    if total <= 0.0:
        return
    cumulative = np.cumsum(weights / total)
    exceeding = np.flatnonzero(cumulative > top_p)
    keep = int(exceeding[0]) + 1 if exceeding.size else order.size
    keep = max(keep, 1)
    drop_mask = np.ones(logits.shape[0], dtype=bool)
    drop_mask[order[:keep]] = False
    logits[drop_mask] = -np.inf


def select_token_id_host(
    logits: np.ndarray,
    params,  # DecodeParameters-like
    context: Sequence[int],
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Select the next token id from a [vocab] f32 logits vector."""
    logits = np.asarray(logits, dtype=np.float32).reshape(-1).copy()
    if logits.size == 0:
        raise ValueError("logits tensor is empty")

    adjusted = logits.copy()
    apply_repetition_penalty_host(adjusted, context, params.repetition_penalty)

    filtered = adjusted.copy()
    ngram = params.no_repeat_ngram_size
    if ngram is not None and ngram > 1:
        for token in banned_ngram_tokens_host(context, ngram):
            if 0 <= token < filtered.shape[0]:
                filtered[int(token)] = -np.inf
    if not np.isfinite(filtered).any():
        filtered = adjusted.copy()

    if params.do_sample and params.temperature > 0.0:
        logits64 = filtered.astype(np.float64) / params.temperature
        if params.top_k is not None and 0 < params.top_k < logits64.size:
            _apply_top_k_host(logits64, params.top_k)
        if params.top_p is not None and 0.0 <= params.top_p < 1.0:
            _apply_top_p_host(logits64, params.top_p)
        sampled = _sample_from_logits_host(logits64, rng or np.random.default_rng())
        if sampled is not None:
            return sampled

    for candidate in (filtered, adjusted, logits):
        best = _argmax_first_tie(candidate)
        if best is not None:
            return best
    return 0


def _sample_from_logits_host(
    logits: np.ndarray, rng: np.random.Generator
) -> Optional[int]:
    finite_idx = np.flatnonzero(np.isfinite(logits))
    if finite_idx.size == 0:
        return None
    vals = logits[finite_idx]
    weights = np.exp(vals - vals.max())
    weights = np.where(np.isfinite(weights) & (weights > 0.0), weights, 0.0)
    total = weights.sum()
    if total <= 0.0:
        return int(finite_idx[np.argmax(vals)])
    probs = weights / total
    return int(rng.choice(finite_idx, p=probs))


# ---------------------------------------------------------------------------
# Device (PyTorch) implementation — fixed shapes, per-row knobs
# ---------------------------------------------------------------------------


class SlotSamplingParams(NamedTuple):
    """Per-row sampling knobs, one entry per slot, kept on the device."""

    temperature: torch.Tensor  # [B] f32
    top_p: torch.Tensor  # [B] f32 (>= 1.0 or < 0 disables)
    top_k: torch.Tensor  # [B] i64 (<= 0 or >= V disables)
    repetition_penalty: torch.Tensor  # [B] f32 (1.0 disables)
    do_sample: torch.Tensor  # [B] bool
    ngram: torch.Tensor  # [B] i64 no-repeat-ngram size (<= 1 disables)

    @staticmethod
    def full(B: int, params, device) -> "SlotSamplingParams":
        """Broadcast one host params object to B rows."""

        def arr(v, default, dtype):
            return torch.full((B,), default if v is None else v, dtype=dtype, device=device)

        return SlotSamplingParams(
            temperature=arr(params.temperature, 0.0, torch.float32),
            top_p=arr(params.top_p, 1.0, torch.float32),
            top_k=arr(params.top_k, 0, torch.int64),
            repetition_penalty=arr(params.repetition_penalty, 1.0, torch.float32),
            do_sample=arr(bool(params.do_sample), False, torch.bool),
            ngram=arr(params.no_repeat_ngram_size, 0, torch.int64),
        )


def samples(params) -> bool:
    """Host-side: does this request sample (vs greedy)?"""
    return bool(params.do_sample) and (params.temperature or 0.0) > 0.0


def _scatter_rows(B: int, V: int, targets: torch.Tensor) -> torch.Tensor:
    """[B, V] bool with True at targets; targets == V land in a dropped column."""
    mask = torch.zeros((B, V + 1), dtype=torch.bool, device=targets.device)
    mask.scatter_(1, targets, True)
    return mask[:, :V]


def banned_ngram_mask_slots(
    context: torch.Tensor,  # [B, L] int
    context_len: torch.Tensor,  # [B] int
    ngram_row: torch.Tensor,  # [B] per-row ngram size (<= 1 disables)
    ngram_max: int,
    vocab_size: int,
) -> torch.Tensor:
    """[B, V] mask of banned tokens with a per-row ngram size: context[t]
    is banned iff the (n_r - 1) tokens before t equal the current
    (n_r - 1)-suffix. Windows are gathered at the static ngram_max width."""
    B, L = context.shape
    N1 = ngram_max - 1
    if N1 < 1 or L < 2:
        return torch.zeros((B, vocab_size), dtype=torch.bool, device=context.device)
    dev = context.device
    t = torch.arange(L, device=dev)
    j = torch.arange(N1, device=dev)
    idx = (t[:, None] - N1 + j[None, :]).clamp(0, L - 1)  # [L, N1]
    win = context[:, idx]  # [B, L, N1]
    sfx = torch.gather(context, 1, (context_len[:, None] - N1 + j[None, :]).clamp(0, L - 1))
    care = j[None, :] >= (N1 - (ngram_row[:, None] - 1))  # [B, N1]
    match = ((win == sfx[:, None, :]) | ~care[:, None, :]).all(dim=-1)  # [B, L]
    valid = (
        (t[None, :] >= (ngram_row[:, None] - 1))
        & (t[None, :] < context_len[:, None])
        & (ngram_row[:, None] > 1)
        & (context_len[:, None] >= (ngram_row[:, None] - 1))
    )
    targets = torch.where(match & valid, context, torch.full_like(context, vocab_size))
    return _scatter_rows(B, vocab_size, targets.long())


def select_token_id_slots(
    logits: torch.Tensor,  # [B, V] f32
    context: torch.Tensor,  # [B, L] int
    context_len: torch.Tensor,  # [B] int
    sampling: SlotSamplingParams,
    *,
    ngram_max: int,
    generator: Optional[torch.Generator] = None,
    any_sample: bool = False,
) -> torch.Tensor:
    """Next token per row, [B] int64, with per-row knobs. `any_sample` is
    the host's knowledge that some row samples: the sampled branch (three
    [B, V] sorts) only runs then, and deciding it on the host keeps the
    step free of device→host syncs."""
    B, V = logits.shape
    logits = logits.float()
    L = context.shape[1]
    pen = sampling.repetition_penalty[:, None]
    penalized = torch.where(logits > 0.0, logits / pen, logits * pen)
    valid = torch.arange(L, device=logits.device)[None, :] < context_len[:, None]
    seen = _scatter_rows(B, V, torch.where(valid, context, torch.full_like(context, V)).long())
    apply_pen = seen & ((pen - 1.0).abs() > 1e-7) & (pen > 0.0)
    adjusted = torch.where(apply_pen, penalized, logits)

    banned = banned_ngram_mask_slots(context, context_len, sampling.ngram, ngram_max, V)
    filtered = torch.where(banned, torch.full_like(adjusted, float("-inf")), adjusted)
    any_valid = torch.isfinite(filtered).any(dim=-1, keepdim=True)
    filtered = torch.where(any_valid, filtered, adjusted)

    greedy = torch.argmax(filtered, dim=-1)  # first index among ties
    if not any_sample:
        return greedy
    use_sample = sampling.do_sample & (sampling.temperature > 0.0)
    scaled = filtered / sampling.temperature.clamp_min(1e-6)[:, None]
    k_eff = torch.where((sampling.top_k <= 0) | (sampling.top_k >= V), V, sampling.top_k)
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    scaled = torch.where(ranks >= k_eff[:, None], float("-inf"), scaled)
    p_eff = torch.where((sampling.top_p < 0.0) | (sampling.top_p >= 1.0), 1.0, sampling.top_p)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) <= p_eff[:, None]
    keep[:, 0] = True
    threshold = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled < threshold, float("-inf"), scaled)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(use_sample, sampled, greedy)
