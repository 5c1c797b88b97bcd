"""Autoregressive generation loop of single-request decode
(dsocr_tpu/runtime/generate.py).

Semantics are the reference's:

- the first token is selected from the prefill's last-position logits
  with the prompt as penalty context; if it is EOS the generation is
  empty;
- each step appends the current token to the context, runs a
  one-token forward, and selects the next token over the prompt and
  what was generated; EOS is never emitted (``emit_eos=False``, DeepSeek)
  or is appended and then ends the row (``emit_eos=True``, Paddle);
- at most ``max_new_tokens`` tokens are produced; rows of a batch decode
  in lockstep with per-row done flags.

The reference runs the loop inside ``lax.while_loop``; here it is an eager
torch loop over device tensors. The host reads "is every row done" once
every ``CHECK_EVERY`` steps, not every step: the few steps that may run
after the last row finished append nothing and do not count, so the
tokens, ``steps`` and the stream callbacks are the reference's. The
callback gets the tokens once per chunk of ``chunk_size`` steps.

Selection runs core.sampling's per-row device selection with one row of
knobs per row. Greedy tokens equal the reference's. Sampled tokens come
from an explicit ``torch.Generator`` and cannot match JAX's PRNG stream.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.sampling import SlotSamplingParams, samples, select_token_id_slots
from .kv_cache import KVCache

logger = logging.getLogger("dsocr_torch.runtime")

# step_fn(params, token_ids [B], cache, pos_state) -> (logits [B, V] f32, cache, pos_state)
StepFn = Callable[[Any, torch.Tensor, KVCache, Any], Tuple[torch.Tensor, KVCache, Any]]

# steps between reads of "is every row done" (one host sync each)
CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class GenerateParams:
    """Generation knobs, fixed for one generation."""

    max_new_tokens: int = 512
    do_sample: bool = False
    temperature: float = 0.0
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: Optional[int] = None
    eos_ids: Tuple[int, ...] = ()
    chunk_size: int = 32
    # DeepSeek's loop never emits EOS; Paddle's pushes EOS, then stops.
    emit_eos: bool = False


@dataclasses.dataclass
class LoopState:
    cache: KVCache
    pos_state: Any
    context: torch.Tensor  # [B, C] int64 — prompt + generated tokens
    ctx_len: torch.Tensor  # [B] int64
    current: torch.Tensor  # [B] int64 — token pending append
    done: torch.Tensor  # [B] bool
    steps: torch.Tensor  # [] int64 — steps taken while some row was live
    generator: torch.Generator


@dataclasses.dataclass
class GenerationResult:
    tokens: List[List[int]]  # per row, EOS excluded unless emit_eos
    prompt_tokens: int
    steps: int


def clamp_new_tokens(prompt_pad: int, requested: int, max_seq_len: int) -> int:
    """max_new_tokens that fits a [*, max_seq_len] KV budget after a
    prompt of prompt_pad positions; raises when the prompt alone leaves no
    room to generate."""
    capacity = max_seq_len - prompt_pad
    if capacity <= 0:
        raise ValueError(
            f"prompt ({prompt_pad} padded tokens) leaves no KV-cache room "
            f"to generate within max_seq_len={max_seq_len}"
        )
    if requested > capacity:
        logger.warning("max_new_tokens %d exceeds remaining cache capacity %d "
                       "(prompt_pad=%d, max_seq_len=%d); truncating",
                       requested, capacity, prompt_pad, max_seq_len)
        return capacity
    return requested


def _is_eos(token: torch.Tensor, eos_ids: Sequence[int]) -> torch.Tensor:
    out = torch.zeros_like(token, dtype=torch.bool)
    for e in eos_ids:
        out |= token == e
    return out


class Generator:
    """Binds a model step function and GenerateParams into chunked runs."""

    def __init__(self, step_fn: StepFn, params: GenerateParams):
        self.step_fn = step_fn
        self.params = params

    def _select(self, logits, context, ctx_len, generator) -> torch.Tensor:
        p = self.params
        sampling = SlotSamplingParams.full(logits.shape[0], p, logits.device)
        return select_token_id_slots(
            logits, context, ctx_len, sampling, ngram_max=max(p.no_repeat_ngram_size or 0, 2),
            generator=generator, any_sample=samples(p),
        )

    @torch.no_grad()
    def start(self, model_params: Any, prefill_logits: torch.Tensor, cache: KVCache, pos_state: Any,
              context: torch.Tensor, ctx_len: torch.Tensor, generator: torch.Generator) -> LoopState:
        """Select the first token from the prefill logits [B, V] (prompt-only
        context written at [0, ctx_len) of `context`)."""
        first = self._select(prefill_logits, context, ctx_len, generator)
        return LoopState(cache=cache, pos_state=pos_state, context=context, ctx_len=ctx_len,
                         current=first, done=_is_eos(first, self.params.eos_ids),
                         steps=torch.zeros((), dtype=torch.int64, device=context.device),
                         generator=generator)

    def _body(self, model_params: Any, s: LoopState) -> None:
        p = self.params
        active = ~s.done
        rows = torch.arange(s.context.shape[0], device=s.context.device)
        # 1. append `current` for live rows (finished rows freeze)
        safe_pos = s.ctx_len.clamp(max=s.context.shape[1] - 1)
        s.context[rows, safe_pos] = torch.where(active, s.current, s.context[rows, safe_pos])
        s.ctx_len += active.long()
        s.steps += active.any().long()
        done = s.done.clone()
        if p.emit_eos:  # EOS was appended above; the row ends now
            done |= active & _is_eos(s.current, p.eos_ids)
        # 2. one token forward (finished rows feed token 0; their output is unused)
        feed = torch.where(active, s.current, torch.zeros_like(s.current))
        logits, s.cache, s.pos_state = self.step_fn(model_params, feed, s.cache, s.pos_state)
        # 3. the next token over prompt + generated context
        nxt = self._select(logits, s.context, s.ctx_len, s.generator)
        if not p.emit_eos:  # EOS ends the row at selection and is never appended
            done |= _is_eos(nxt, p.eos_ids)
        s.current = torch.where(done, s.current, nxt)
        s.done = done

    @torch.no_grad()
    def run_chunk(self, model_params: Any, state: LoopState, n_steps: int, steps0: int) -> LoopState:
        """Up to n_steps steps from `steps0` taken, never past max_new_tokens,
        stopping once every row is done."""
        for i in range(min(steps0 + n_steps, self.params.max_new_tokens) - steps0):
            if i % CHECK_EVERY == 0 and bool(state.done.all()):
                break
            self._body(model_params, state)
        return state

    def generate(
        self,
        model_params: Any,
        prefill_logits: torch.Tensor,  # [B, V] f32 (last prompt position)
        cache: KVCache,
        pos_state: Any,
        prompt_tokens: Sequence[Sequence[int]],
        generator: Optional[torch.Generator] = None,
        stream_callback: Optional[Callable[[int, List[int]], None]] = None,
    ) -> GenerationResult:
        """Run the whole generation, streaming each row's tokens to the
        callback after every chunk. Returns each row's tokens."""
        p = self.params
        dev = prefill_logits.device
        B = len(prompt_tokens)
        prompt_lens = [len(t) for t in prompt_tokens]
        context = np.zeros((B, max(prompt_lens) + p.max_new_tokens), dtype=np.int64)
        for i, toks in enumerate(prompt_tokens):
            context[i, : len(toks)] = toks
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        state = self.start(model_params, prefill_logits, cache, pos_state,
                           torch.from_numpy(context).to(dev),
                           torch.tensor(prompt_lens, dtype=torch.int64, device=dev), generator)
        if bool(state.done.all()):  # EOS as the first token: an empty generation
            return GenerationResult([[] for _ in range(B)], max(prompt_lens), 0)
        emitted = 0
        chunk = p.max_new_tokens if stream_callback is None else max(p.chunk_size, 1)
        while True:
            state = self.run_chunk(model_params, state, chunk, emitted)
            snap = torch.cat([state.steps.reshape(1), state.done.all().long().reshape(1),
                              state.ctx_len, state.context.reshape(-1)]).cpu().numpy()
            steps, all_done, lens = int(snap[0]), bool(snap[1]), snap[2 : 2 + B]
            ctx = snap[2 + B :].reshape(B, -1)
            if stream_callback is not None and steps > emitted:
                for row in range(B):
                    stream_callback(steps, ctx[row, prompt_lens[row] : lens[row]].tolist())
            emitted = steps
            if steps >= p.max_new_tokens or all_done:
                break
        tokens = [ctx[row, prompt_lens[row] : lens[row]].tolist() for row in range(B)]
        return GenerationResult(tokens=tokens, prompt_tokens=max(prompt_lens), steps=emitted)
