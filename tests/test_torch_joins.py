"""Joins are all or nothing, and one request's bad knobs fail only itself:

- a ``join`` whose sampling row cannot be built (``top_k=2**70``) and a
  ``join_many`` whose second row's KV write raises leave the state of a
  ``SlotRunner`` and of a ``PagedSlotRunner`` — every row-indexed state
  tensor, the page tables, the allocator's free list — as it was before
  the call, with another row live beside them; the same rows then join;
- a prefill wave of a default request and one with ``top_k=2**70``: the
  wave's first-token selection fails, each join selects on the host, the
  first request completes with the reference scheduler's tokens and only
  the second fails, as in the reference.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.runtime.paged import PageAllocator, PagedSlotRunner, new_page_pool
from dsocr_tpu_torch.runtime.slots import SlotRunner, alloc_slot_cache
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

L, H, D, S_PAD, V = 2, 2, 4, 8, 32
BAD = dict(top_k=2 ** 70)


def _packet(rng, n):
    return dict(prompt_ids=[int(t) for t in rng.integers(3, V, n)],
                row_k=torch.from_numpy(rng.normal(size=(L, 1, H, S_PAD, D)).astype(np.float32)),
                row_v=torch.from_numpy(rng.normal(size=(L, 1, H, S_PAD, D)).astype(np.float32)),
                logits=torch.from_numpy(rng.normal(size=V).astype(np.float32)), pos0=n)


def _runner(paged, kv_quant):
    step = lambda *a: None  # noqa: E731 — joins run no step
    if paged:
        cache = new_page_pool(L, 12, H, D, D, 4, 3, 6, torch.float32, kv_quant, "cpu")
        runner = PagedSlotRunner(step, eos_ids=(2,), allocator=PageAllocator(12))
    else:
        cache = alloc_slot_cache(L, 3, H, 24, D, D, torch.float32, kv_quant, "cpu")
        runner = SlotRunner(step, eos_ids=(2,))
    return runner, runner.init_state(cache, 32)


def _snapshot(runner, state):
    cache = state.cache
    tensors = [state.context, state.ctx_len, state.prompt_len, state.pos, state.current, state.active,
               state.budget, *state.sampling, cache.lengths]
    if isinstance(runner, PagedSlotRunner):
        tensors.append(cache.tables)
        extra = (list(runner.allocator._free), dict(runner._row_pages))
    else:
        extra = ()
    return [t.clone() for t in tensors], list(state.row_samples), extra


def _assert_same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert a[1:] == b[1:]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_failed_join_leaves_the_state(paged, kv_quant):
    """Repro A: the sampling row of top_k = 2**70 overflows int64."""
    rng = np.random.default_rng(0)
    runner, state = _runner(paged, kv_quant)
    runner.join(state, 0, _packet(rng, 5), DecodeParameters(), 4)
    before = _snapshot(runner, state)
    pre = _packet(rng, 6)
    with pytest.raises((OverflowError, RuntimeError)):
        runner.join(state, 1, pre, DecodeParameters(**BAD), 4, first=7)
    _assert_same(_snapshot(runner, state), before)
    _, finished, first = runner.join(state, 1, pre, DecodeParameters(), 4, first=7)
    assert not finished and first == 7 and bool(state.active[1]) and int(state.cache.lengths[1]) == 6


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_join_many_failing_after_its_first_write_leaves_the_state(paged, kv_quant, monkeypatch):
    """Repro B: the second row's KV write raises after the first row was
    written in full."""
    rng = np.random.default_rng(1)
    runner, state = _runner(paged, kv_quant)
    runner.join(state, 0, _packet(rng, 5), DecodeParameters(), 4)
    before = _snapshot(runner, state)
    packets = [_packet(rng, 6), _packet(rng, 7)]
    params = [DecodeParameters(), DecodeParameters(temperature=0.5)]
    orig = type(runner)._write_row_kv
    writes = []

    def failing(self, cache, row, prep):
        writes.append(row)
        if len(writes) == 2:
            raise RuntimeError("KV write failed")
        return orig(self, cache, row, prep)

    monkeypatch.setattr(type(runner), "_write_row_kv", failing)
    with pytest.raises(RuntimeError, match="KV write failed"):
        runner.join_many(state, [1, 2], packets, params, [4, 4], [None, None])
    assert writes == [1, 2]
    _assert_same(_snapshot(runner, state), before)
    monkeypatch.setattr(type(runner), "_write_row_kv", orig)
    _, finished, _ = runner.join_many(state, [1, 2], packets, params, [4, 4], [None, None])
    assert finished == [False, False] and state.active.tolist() == [True, True, True]


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


def _serve(sched, params_cls, vision):
    images = [np.random.default_rng(3 + i).integers(0, 256, size=(60, 60, 3), dtype=np.uint8)
              for i in range(2)]
    params = [params_cls(max_new_tokens=4, no_repeat_ngram_size=None),
              params_cls(max_new_tokens=4, no_repeat_ngram_size=None, **BAD)]

    async def run():
        return await asyncio.gather(*(sched.submit("<image>q", [img], vision, p)
                                      for img, p in zip(images, params)), return_exceptions=True)

    return asyncio.run(run())


def test_bad_request_fails_alone_in_its_wave(monkeypatch):
    jax_engine = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512)
    want = _serve(JaxScheduler(jax_engine, _Tok(), n_slots=2, max_len=256, chunk_steps=4),
                  JaxParams, JaxVision(64, 64, False))
    assert not isinstance(want[0], BaseException) and isinstance(want[1], BaseException)

    waves = []
    orig = ContinuousScheduler._prepare_jobs
    monkeypatch.setattr(ContinuousScheduler, "_prepare_jobs",
                        lambda self, jobs: waves.append(len(jobs)) or orig(self, jobs))
    port = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu",
                             max_seq_len=512, state=params_from_jax(jax.device_get(jax_engine.params)))
    got = _serve(ContinuousScheduler(port, _Tok(), n_slots=2, max_len=256, chunk_steps=4),
                 DecodeParameters, VisionSettings(64, 64, False))
    assert waves == [2], "both requests must share one prefill wave"
    assert not isinstance(got[0], BaseException), got[0]
    assert got[0].generated_tokens == want[0].generated_tokens
    assert isinstance(got[1], (OverflowError, RuntimeError))
