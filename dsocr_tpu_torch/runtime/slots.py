"""Slot-based continuous batching runtime (dsocr_tpu/runtime/slots.py).

A persistent B-slot decode loop over one shared KV cache:

- slot r owns row r of the cache; its tokens live at [0, lengths[r]);
- a request joins between decode chunks: its prefilled K/V block is
  copied into row r (quantized first for an int8 cache);
- finished rows freeze inside the chunk and free their slot at the next
  chunk boundary;
- sampling knobs are per-row device tensors (core.sampling), so
  requests with different parameters share one decode step.

The reference's jitted, donated graphs become in-place updates of the
state's tensors: ``run_chunk`` runs its steps with no device→host sync
per token — the "every row finished" early exit is read once every
``CHECK_EVERY`` steps — and ``join``/``release`` overwrite one row. A join
is all or nothing, as the reference's functional one is: every row's
inputs (first token, sampling row, KV blocks quantized for an int8
cache, pages) are built before the first write, and a failure after it
puts the rows already written back as they were (a free row: ``active``
False, length 0, no pages) before it re-raises. A failed ``join`` or
``join_many`` therefore leaves the state as it was — only the K/V past a
free row's length 0, which nothing reads — so a caller may retry the same
rows one by one on the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sampling import (
    SlotSamplingParams,
    samples,
    select_token_id_host,
    select_token_id_slots,
)
from ..ops.attention import quantize_kv_int8


@dataclasses.dataclass
class SlotCache:
    """KV buffers with per-row lengths. With k_scale/v_scale set, k/v
    hold int8 codes and the scales one f32 per (layer, row, head, token)."""

    k: torch.Tensor  # [L, B, H_kv, S_max, Dk] (model dtype, or int8 codes)
    v: torch.Tensor  # [L, B, H_kv, S_max, Dv]
    lengths: torch.Tensor  # [B] int32
    k_scale: Optional[torch.Tensor] = None  # [L, B, H_kv, S_max] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]


def alloc_slot_cache(num_layers, n_slots, num_kv_heads, max_len, head_dim, v_head_dim,
                     dtype, kv_quant: Optional[str], device) -> SlotCache:
    """Zeroed slot cache; kv_quant "int8" → int8 codes + f32 scale planes."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    kv_dtype = torch.int8 if kv_quant == "int8" else dtype
    shape = (num_layers, n_slots, num_kv_heads, max_len)
    k = torch.zeros((*shape, head_dim), dtype=kv_dtype, device=device)
    v = torch.zeros((*shape, v_head_dim), dtype=kv_dtype, device=device)
    ks = vs = None
    if kv_quant == "int8":
        ks = torch.zeros(shape, dtype=torch.float32, device=device)
        vs = torch.zeros(shape, dtype=torch.float32, device=device)
    lengths = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return SlotCache(k, v, lengths, ks, vs)


@dataclasses.dataclass
class SlotState:
    cache: SlotCache
    context: torch.Tensor  # [B, C] int64 — prompt + generated per row
    ctx_len: torch.Tensor  # [B] int64
    prompt_len: torch.Tensor  # [B] int64
    pos: torch.Tensor  # [B] int64 — next-token position
    current: torch.Tensor  # [B] int64 — token pending append
    active: torch.Tensor  # [B] bool
    budget: torch.Tensor  # [B] int64 — appends remaining
    sampling: SlotSamplingParams
    generator: torch.Generator
    row_samples: List[bool]  # host mirror: does row r sample?


# longest no-repeat-ngram a request may ask for (the static window width)
NGRAM_MAX = 24
# steps between reads of "is any row still active" (one host sync each)
CHECK_EVERY = 8

# step_fn(model_params, token_ids [B], cache, pos [B]) -> logits [B, V] f32,
# with row r's KV written at cache.lengths[r] (lengths NOT bumped)
SlotStepFn = Callable[[Any, torch.Tensor, SlotCache, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SlotHarvest:
    """Host snapshot after a chunk: one device→host copy."""

    context: np.ndarray  # [B, C]
    ctx_len: np.ndarray  # [B]
    prompt_len: np.ndarray  # [B]
    active: np.ndarray  # [B] bool

    def generated(self, row: int) -> List[int]:
        return self.context[row, self.prompt_len[row] : self.ctx_len[row]].tolist()


class SlotRunner:
    """Owns the token-level loop over a SlotState; the engine provides
    step_fn and the prefill that makes a row's KV block. An EOS token
    ends its row and is never appended. Not thread-safe: drive it from
    one scheduler task."""

    def __init__(self, step_fn: SlotStepFn, *, eos_ids: Tuple[int, ...]):
        self.step_fn = step_fn
        self.eos_ids = tuple(eos_ids)

    # -- state --------------------------------------------------------------

    def init_state(self, cache: SlotCache, context_len: int) -> SlotState:
        B = cache.n_slots
        dev = cache.k.device

        def zeros(dtype=torch.int64):
            return torch.zeros((B,), dtype=dtype, device=dev)

        cache.lengths.zero_()
        sampling = SlotSamplingParams(
            temperature=zeros(torch.float32),
            top_p=torch.ones((B,), dtype=torch.float32, device=dev),
            top_k=zeros(),
            repetition_penalty=torch.ones((B,), dtype=torch.float32, device=dev),
            do_sample=zeros(torch.bool),
            ngram=zeros(),
        )
        return SlotState(
            cache=cache,
            context=torch.zeros((B, context_len), dtype=torch.int64, device=dev),
            ctx_len=zeros(), prompt_len=zeros(), pos=zeros(), current=zeros(),
            active=zeros(torch.bool), budget=zeros(), sampling=sampling,
            generator=torch.Generator(device=dev).manual_seed(0),
            row_samples=[False] * B,
        )

    def _is_eos(self, token: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(token, dtype=torch.bool)
        for e in self.eos_ids:
            out |= token == e
        return out

    # -- decode ---------------------------------------------------------------

    def _step(self, model_params: Any, s: SlotState) -> None:
        act = s.active
        C = s.context.shape[1]
        rows = torch.arange(act.shape[0], device=act.device)
        safe_pos = s.ctx_len.clamp(max=C - 1)
        s.context[rows, safe_pos] = torch.where(act, s.current, s.context[rows, safe_pos])
        inc = act.long()
        s.ctx_len += inc
        s.budget -= inc
        alive = act.clone()
        feed = torch.where(act, s.current, torch.zeros_like(s.current))
        logits = self.step_fn(model_params, feed, s.cache, s.pos)
        # only rows that appended a real token keep their KV write
        s.cache.lengths += act.int()
        s.pos += inc
        nxt = select_token_id_slots(
            logits, s.context, s.ctx_len, s.sampling, ngram_max=NGRAM_MAX,
            generator=s.generator, any_sample=any(s.row_samples),
        )
        alive &= ~self._is_eos(nxt)
        alive &= s.budget > 0
        s.current.copy_(torch.where(alive, nxt, s.current))
        s.active.copy_(alive)

    @torch.no_grad()
    def run_chunk(self, model_params: Any, state: SlotState, n_steps: int) -> SlotState:
        """Up to n_steps decode steps for every active row, in place."""
        for i in range(n_steps):
            if i % CHECK_EVERY == 0 and not bool(state.active.any()):
                break
            self._step(model_params, state)
        return state

    @staticmethod
    def snapshot(state: SlotState) -> torch.Tensor:
        """[B, C + 3] packed device copy of what a harvest reads: context,
        ctx_len, prompt_len, active. A copy, not a view: the state is
        updated in place, so the next chunk would overwrite a view."""
        return torch.cat(
            [state.context, state.ctx_len[:, None], state.prompt_len[:, None],
             state.active.long()[:, None]], dim=1,
        )

    def run_chunk_snap(self, model_params: Any, state: SlotState,
                       n_steps: int) -> Tuple[SlotState, torch.Tensor]:
        """run_chunk, then its snapshot, queued before the caller queues
        anything else: the snapshot can be harvested (harvest_from_snap)
        after the next chunk has been dispatched."""
        state = self.run_chunk(model_params, state, n_steps)
        return state, self.snapshot(state)

    @staticmethod
    def harvest_from_snap(snap: torch.Tensor) -> SlotHarvest:
        """One device→host copy of a snapshot."""
        arr = snap.cpu().numpy()
        C = arr.shape[1] - 3
        return SlotHarvest(arr[:, :C], arr[:, C], arr[:, C + 1], arr[:, C + 2].astype(bool))

    def harvest(self, state: SlotState) -> SlotHarvest:
        return self.harvest_from_snap(self.snapshot(state))

    # -- join / release ---------------------------------------------------------

    def _first_host(self, pre: dict, params) -> int:
        rng = np.random.default_rng(params.seed or 0)
        logits = pre["logits"].float().cpu().numpy()
        return select_token_id_host(logits, params, list(pre["prompt_ids"]), rng)

    def _check_packet(self, state: SlotState, pre: dict) -> None:
        n = len(pre["prompt_ids"])
        if n > state.context.shape[1]:
            raise ValueError(f"prompt ({n} tokens) exceeds context buffer {state.context.shape[1]}")
        cache = state.cache
        want = (cache.k.shape[0], 1, cache.k.shape[2])
        row_k, row_v = pre["row_k"], pre["row_v"]
        if tuple(row_k.shape[:3]) != want or row_k.shape[-1] != cache.k.shape[-1]:
            raise ValueError(f"row K block {tuple(row_k.shape)} does not fit the cache")
        if row_v.shape[:4] != row_k.shape[:4] or row_k.shape[3] > cache.max_len:
            raise ValueError(f"row KV blocks {tuple(row_k.shape)} exceed slot length {cache.max_len}")

    def _kv_blocks(self, cache: SlotCache, row_k: torch.Tensor, row_v: torch.Tensor):
        """A prefilled [L, H, s_pad, D] K/V block as the cache stores it:
        [(plane, block)], quantized first for an int8 cache."""
        if cache.k_scale is None:
            return [(cache.k, row_k.to(cache.k.dtype)), (cache.v, row_v.to(cache.v.dtype))]
        (k, k_scale), (v, v_scale) = quantize_kv_int8(row_k), quantize_kv_int8(row_v)
        return [(cache.k, k), (cache.v, v), (cache.k_scale, k_scale), (cache.v_scale, v_scale)]

    def _prepare(self, state: SlotState, row: int, pre: dict, params) -> dict:
        """Everything a row's join writes, built before any write."""
        dev = state.context.device
        n = len(pre["prompt_ids"])
        prompt_row = np.zeros(state.context.shape[1], np.int64)
        prompt_row[:n] = pre["prompt_ids"]
        pos0 = pre.get("pos0")
        return dict(kv=self._kv_blocks(state.cache, pre["row_k"][:, 0], pre["row_v"][:, 0]),
                    prompt=torch.from_numpy(prompt_row).to(dev), n=n,
                    pos=n if pos0 is None else pos0,
                    sampling=SlotSamplingParams.full(1, params, dev), samples=samples(params))

    def _write_row_kv(self, cache: SlotCache, row: int, prep: dict) -> None:
        for plane, block in prep["kv"]:
            plane[:, row, :, : block.shape[2]] = block

    def _row_tensors(self, state: SlotState) -> List[torch.Tensor]:
        """The state tensors indexed by row that a join writes."""
        return [state.cache.lengths, state.context, state.ctx_len, state.prompt_len, state.pos,
                state.current, state.active, state.budget, *state.sampling]

    def _insert(self, state: SlotState, row: int, prep: dict, first: int, active: bool,
                budget: int) -> None:
        self._write_row_kv(state.cache, row, prep)
        state.context[row] = prep["prompt"]
        n = prep["n"]
        state.cache.lengths[row] = n
        state.ctx_len[row] = n
        state.prompt_len[row] = n
        state.pos[row] = prep["pos"]
        state.current[row] = first
        state.budget[row] = budget
        for buf, val in zip(state.sampling, prep["sampling"]):
            buf[row] = val[0]
        state.row_samples[row] = prep["samples"]
        state.active[row] = active  # last: the row is live from here

    def _join_rows(self, state: SlotState, rows: Sequence[int], packets: Sequence[dict],
                   params_list: Sequence[Any], max_news: Sequence[int],
                   firsts: Sequence[Optional[int]]) -> Tuple[SlotState, List[bool], List[int]]:
        """Insert packets all or nothing (the module docstring)."""
        for pre in packets:
            self._check_packet(state, pre)
        firsts_out = [
            int(self._first_host(pre, p) if f is None else f)
            for pre, p, f in zip(packets, params_list, firsts)
        ]
        finished = [f in self.eos_ids or m <= 0 for f, m in zip(firsts_out, max_news)]
        preps = [self._prepare(state, row, pre, p) for row, pre, p in zip(rows, packets, params_list)]
        saved = []
        try:
            for row, prep, f, fin, m in zip(rows, preps, firsts_out, finished, max_news):
                saved.append((row, [t[row].clone() for t in self._row_tensors(state)],
                              state.row_samples[row]))
                self._insert(state, row, prep, f, not fin, m)
        except BaseException:
            for row, values, flag in reversed(saved):
                for t, value in zip(self._row_tensors(state), values):
                    t[row] = value
                state.row_samples[row] = flag
            raise
        return state, finished, firsts_out

    @torch.no_grad()
    def join(self, state: SlotState, row: int, pre: dict, params, max_new: int,
             first: Optional[int] = None) -> Tuple[SlotState, bool, int]:
        """Insert a prefilled packet (prompt_ids, row_k/row_v [L, 1, H,
        s_pad, D], logits [V], pos0) into slot `row`. The first token comes
        precomputed (`first`) or is selected here with the host spec.
        Returns (state, finished, first_token)."""
        state, finished, firsts = self._join_rows(state, [row], [pre], [params], [max_new], [first])
        return state, finished[0], firsts[0]

    @torch.no_grad()
    def join_many(self, state: SlotState, rows: Sequence[int], packets: Sequence[dict],
                  params_list: Sequence[Any], max_news: Sequence[int],
                  firsts: Sequence[Optional[int]]) -> Tuple[SlotState, List[bool], List[int]]:
        """Insert several packets, all or nothing: a bad packet raises with
        the state as it was, so the caller can retry row by row."""
        return self._join_rows(state, rows, packets, params_list, max_news, firsts)

    @torch.no_grad()
    def select_first_tokens(self, packets: Sequence[dict], params_list: Sequence[Any]) -> List[int]:
        """Every packet's first token in one batched device selection (the
        same per-row machinery as the decode step) and one [R] pull; a
        sampling wave draws from the first seed its requests give."""
        if not packets:
            return []
        seed = next((p.seed for p in params_list if getattr(p, "seed", None)), 0)
        dev = packets[0]["logits"].device
        n_max = max(len(p["prompt_ids"]) for p in packets)
        C = max(128, -(-n_max // 128) * 128)
        ctx = np.zeros((len(packets), C), np.int64)
        for i, p in enumerate(packets):
            ctx[i, : len(p["prompt_ids"])] = p["prompt_ids"]
        lens = torch.tensor([len(p["prompt_ids"]) for p in packets], device=dev)
        rows = [SlotSamplingParams.full(1, p, dev) for p in params_list]
        sampling = SlotSamplingParams(*(torch.cat(col) for col in zip(*rows)))
        out = select_token_id_slots(
            torch.stack([p["logits"].float().reshape(-1) for p in packets]),
            torch.from_numpy(ctx).to(dev), lens, sampling, ngram_max=NGRAM_MAX,
            generator=torch.Generator(device=dev).manual_seed(seed),
            any_sample=any(samples(p) for p in params_list),
        )
        return out.tolist()

    @torch.no_grad()
    def release(self, state: SlotState, row: int) -> SlotState:
        state.cache.lengths[row] = 0
        for buf in (state.ctx_len, state.prompt_len, state.pos, state.budget):
            buf[row] = 0
        state.active[row] = False
        state.row_samples[row] = False
        return state
