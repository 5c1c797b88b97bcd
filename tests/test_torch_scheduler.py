"""The port's ContinuousScheduler features against the reference's
(dsocr_tpu/server/scheduler.py), on the same weights (params_from_jax,
tiny config, f32): the reference scheduler's greedy tokens are the
expected output of every served case.

- the env defaults and switch names;
- speculative chunk dispatch matches serial dispatch, and is skipped
  while a row streams;
- streamed token lists extend each other and end equal to the tokens;
- the prefix cache: hits across waves and event loops, aliases in a wave,
  misses, per-request params, LRU and keys, a bad image failing only its
  own job, packets joinable twice and cached in storage of their own;
- load shedding;
- device-fault recovery (a fault injected by wrapping the runner's chunk
  call, as the reference's tests do): every request completes with the
  fault-free tokens, also on the first chunk, a speculated chunk, the
  harvest and an out-of-memory error; a persistent fault gives up and
  fails the futures; a sticky CUDA error is not recovered; a streamed
  request stays consistent, and one that cannot continue fails loudly; a
  paged pool gets every page back;
- the continuation packet (extra_tokens) against the reference's;
- the runner's snapshot harvest and release_all_rows, the stage timers,
  the trace switch, DSOCR_ADMIT_CHUNK, and core/streaming and
  core/benchmark against the reference's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.core import benchmark as J_bench
from dsocr_tpu.core import streaming as J_stream
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.server import prefix_cache as J_prefix
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.core import benchmark as T_bench
from dsocr_tpu_torch.core import streaming as T_stream
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.runtime.paged import PageAllocator, PagedSlotRunner, new_page_pool
from dsocr_tpu_torch.runtime.slots import SlotRunner, alloc_slot_cache
from dsocr_tpu_torch.server.prefix_cache import PrefixCache, request_key
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler, QueueDepthExceeded

VS = VisionSettings(64, 64, False)
JVS = JaxVision(64, 64, False)
ENV = ("DSOCR_SLOTS", "DSOCR_SLOT_SEQ", "DSOCR_FIRST_WAVE", "DSOCR_PIPELINE_CHUNKS",
       "DSOCR_PREFIX_CACHE", "DSOCR_MAX_INFLIGHT", "DSOCR_ADMIT_CHUNK",
       "DSOCR_SCHED_MAX_RECOVERIES", "DSOCR_SCHED_TRACE", "DSOCR_PAGED_KV")


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, size=(60, 60, 3), dtype=np.uint8)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512)


@pytest.fixture(scope="module")
def engine(jax_engine):
    state = params_from_jax(jax.device_get(jax_engine.params))
    return DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu",
                             max_seq_len=512, state=state)


@pytest.fixture(scope="module")
def ref(jax_engine):
    """ref([(prompt, image seed, max_new, extra params), ...]) → the
    reference scheduler's greedy tokens of each request, from one
    reference scheduler (its compiled graphs are reused), memoized."""
    sched = JaxScheduler(jax_engine, _Tok(), n_slots=2, max_len=256, chunk_steps=4)
    memo = {}

    def tokens(requests):
        todo = [r for r in dict.fromkeys(requests) if r not in memo]
        if todo:
            async def run():
                return await asyncio.gather(*(
                    sched.submit(p, [_img(seed)], JVS, _params(JaxParams, n, kw))
                    for p, seed, n, kw in todo))

            for r, out in zip(todo, asyncio.run(run())):
                memo[r] = out.generated_tokens
        return [memo[r] for r in requests]

    return tokens


def _params(cls, max_new, kw=()):
    return cls(max_new_tokens=max_new, no_repeat_ngram_size=None, **dict(kw))


def _serve(sched, requests, stream=None):
    """requests = [(prompt, seed, max_new, extra params)] submitted at once;
    stream[i], where given, is request i's stream_cb."""
    stream = stream or {}

    async def run():
        return await asyncio.gather(*(
            sched.submit(p, [_img(seed)], VS, _params(DecodeParameters, n, kw), stream_cb=stream.get(i))
            for i, (p, seed, n, kw) in enumerate(requests)), return_exceptions=True)

    return asyncio.run(run())


def _tokens(outs):
    for out in outs:
        if isinstance(out, BaseException):
            raise out
    return [o.generated_tokens for o in outs]


# -- env defaults ------------------------------------------------------------------


class _NoSlotEngine:
    max_seq_len = 8192


@pytest.mark.parametrize("env", [
    {},
    {"DSOCR_SLOTS": "6", "DSOCR_SLOT_SEQ": "1000", "DSOCR_FIRST_WAVE": "0", "DSOCR_PIPELINE_CHUNKS": "0",
     "DSOCR_PREFIX_CACHE": "3", "DSOCR_MAX_INFLIGHT": "5", "DSOCR_SCHED_MAX_RECOVERIES": "1"},
])
def test_env_defaults_match_the_reference(env, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = ContinuousScheduler(_NoSlotEngine(), None)
    want = JaxScheduler(_NoSlotEngine(), None)
    assert (got.n_slots, got.max_len, got.prefill_batch, got.chunk_steps, got.stream_chunk_steps) == (
        want.n_slots, want.max_len, want.prefill_batch, want.chunk_steps, want.stream_chunk_steps)
    assert (got._first_wave or None) == want._first_wave_batch
    assert got._pipeline == want._pipeline
    assert got._max_recoveries == want._max_consecutive_failures
    assert got.max_inflight == want.max_inflight
    assert (got.prefix_cache is None) == (want.prefix_cache is None)
    if got.prefix_cache is not None:
        assert got.prefix_cache.capacity == want.prefix_cache.capacity
    assert got.ttft_samples.maxlen == want.ttft_samples.maxlen == 4096
    assert (got.speculated_chunks, got.recoveries, got.shed_requests) == (0, 0, 0)
    if not env:
        assert (got.n_slots, got.max_len, got.prefill_batch, got._first_wave) == (8, 4096, 4, 4)
        assert got._pipeline and got.prefix_cache is None and got.max_inflight is None
        assert got._admit_chunk == 0 and got._max_recoveries == 3


@pytest.mark.parametrize("max_len,want", [(1000, 896), (300, 256), (100, 128)])
def test_max_len_rounds_down_to_128(engine, max_len, want):
    assert ContinuousScheduler(_NoSlotEngine(), None, n_slots=1, max_len=max_len).max_len == want
    # the port also clamps to the engine's RoPE tables (max_seq_len 512)
    assert ContinuousScheduler(engine, _Tok(), n_slots=1, max_len=4096).max_len == 512


# -- speculative dispatch and streaming -------------------------------------------------

SPEC = [("<image>sp1", 90, 16, ()), ("<image>sp2", 91, 16, ())]


def test_speculative_dispatch_matches_serial(engine, ref, monkeypatch):
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("DSOCR_PIPELINE_CHUNKS", flag)
        sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=4)
        runs[flag] = (_tokens(_serve(sched, SPEC)), sched)
    assert runs["0"][1].speculated_chunks == 0
    assert runs["1"][1].speculated_chunks > 0  # 16 tokens in chunks of 4 leave windows
    assert runs["0"][0] == runs["1"][0] == ref(SPEC)
    # a speculated chunk is one more chunk of the batch
    assert len(runs["1"][1].batch_sizes) >= len(runs["0"][1].batch_sizes)


def test_speculation_skipped_while_a_row_streams(engine, ref):
    seen = []
    sched = ContinuousScheduler(engine, _Tok(), n_slots=1, max_len=256, chunk_steps=4,
                                stream_chunk_steps=4)
    req = [("<image>stream", 92, 12, ())]
    out = _tokens(_serve(sched, req, {0: lambda n, toks: seen.append(n)}))
    assert sched.speculated_chunks == 0
    assert seen and seen[-1] == len(out[0])
    assert out == ref(req)


def test_streamed_lists_extend_each_other_and_end_equal(engine, ref):
    reqs = [("<image>st1", 93, 12, ()), ("<image>st2", 94, 9, ())]
    seen = {0: [], 1: []}
    chunks = []
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=8,
                                stream_chunk_steps=3)
    orig = SlotRunner.run_chunk_snap

    def spy(runner, params, state, n):
        chunks.append(n)
        return orig(runner, params, state, n)

    sched._ensure_state()
    sched._runner.run_chunk_snap = spy.__get__(sched._runner)  # bound to this runner only
    streamed = _tokens(_serve(sched, reqs, {i: (lambda n, toks, i=i: seen[i].append((n, list(toks))))
                                           for i in seen}))
    plain = _tokens(_serve(ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=8),
                           reqs))
    assert streamed == plain == ref(reqs)
    assert set(chunks) == {3}  # a streaming row shortens the chunks
    for i, calls in seen.items():
        assert len(calls) >= 2
        for (n_a, a), (n_b, b) in zip(calls, calls[1:]):
            assert n_b > n_a and b[: len(a)] == a
        assert all(n == len(toks) for n, toks in calls)
        assert calls[-1][1] == streamed[i]


# -- the prefix cache ----------------------------------------------------------------


class CountingEngine:
    """Delegates to an engine and counts the rows it prefills."""

    def __init__(self, engine):
        self._engine = engine
        self.rows_prefilled = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def prefill_for_slot(self, tokenizer, prompt, images, vision, extra_tokens=None):
        self.rows_prefilled += 1
        return self._engine.prefill_for_slot(tokenizer, prompt, images, vision, extra_tokens=extra_tokens)

    def prefill_for_slots(self, tokenizer, requests):
        self.rows_prefilled += len(requests)
        return self._engine.prefill_for_slots(tokenizer, requests)


def test_prefix_cache_reuses_identical_requests(engine, ref):
    """Identical requests prefill once: duplicates in a wave alias the first
    packet, later waves and later event loops hit the LRU."""
    req = ("<image>same", 60, 6, ())
    counting = CountingEngine(engine)
    sched = ContinuousScheduler(counting, _Tok(), n_slots=2, max_len=256, chunk_steps=3,
                                prefix_cache=4)
    want = ref([req])[0]
    assert _tokens(_serve(sched, [req] * 4)) == [want] * 4
    assert counting.rows_prefilled == 1
    assert _tokens(_serve(sched, [req] * 2)) == [want] * 2  # a fresh event loop
    assert counting.rows_prefilled == 1
    assert sched.prefix_cache.misses == 1 and sched.prefix_cache.hits == 5


def test_prefix_cache_distinct_requests_miss(engine, ref):
    reqs = [("<image>x", 61, 5, ()), ("<image>x", 62, 5, ()), ("<image>y", 61, 5, ())]
    counting = CountingEngine(engine)
    sched = ContinuousScheduler(counting, _Tok(), n_slots=2, max_len=256, chunk_steps=3,
                                prefix_cache=4)
    assert _tokens(_serve(sched, reqs)) == ref(reqs)
    assert counting.rows_prefilled == 3
    assert sched.prefix_cache.hits == 0 and len(sched.prefix_cache) == 3


def test_prefix_cache_per_request_params(engine, ref):
    """One packet serves requests with other budgets and other selection
    knobs: the wave's first-token selection and the decode use each
    request's own params, for an alias (one wave of three) as for a hit.
    The prompt holds the greedy first token, so the penalty changes it."""
    penalty = (("repetition_penalty", 1.5),)
    reqs = [("<image>bbb", 63, 3, ()), ("<image>bbb", 63, 9, ()), ("<image>bbb", 63, 9, penalty)]
    counting = CountingEngine(engine)
    sched = ContinuousScheduler(counting, _Tok(), n_slots=3, max_len=256, chunk_steps=3,
                                prefill_batch=3, prefix_cache=2)
    want = ref(reqs)
    assert want[1][0] != want[2][0]  # the penalty changes the first token
    assert _tokens(_serve(sched, reqs)) == want  # one wave: two aliases
    assert _tokens(_serve(sched, reqs[::-1])) == want[::-1]  # hits
    assert counting.rows_prefilled == 1
    assert sched.prefix_cache.hits == 5 and sched.prefix_cache.misses == 1


def test_prefix_cache_lru_and_keys():
    img = _img(64)
    k1 = request_key("a", [img], VS)
    assert k1 == request_key("a", [img.copy()], VS)
    assert k1 == J_prefix.request_key("a", [img], JVS)  # the reference's digest
    assert k1 != request_key("b", [img], VS)
    assert k1 != request_key("a", [_img(65)], VS)
    assert k1 != request_key("a", [img], VisionSettings(32, 32, False))
    assert k1 != request_key("a", [img, img], VS)
    cache = PrefixCache(2)
    cache.put("k1", {"v": 1})
    cache.put("k2", {"v": 2})
    assert cache.get("k1") == {"v": 1}  # refreshes k1
    cache.put("k3", {"v": 3})  # evicts k2
    assert cache.get("k2") is None
    assert cache.get("k1") == {"v": 1}
    assert cache.get("k3") == {"v": 3}
    assert len(cache) == 2
    assert cache.hits == 3 and cache.misses == 1
    cache.clear()
    assert len(cache) == 0
    PrefixCache(0).put("k", {})  # capacity 0 keeps nothing


def test_prefix_cache_bad_image_fails_only_its_job(engine, ref):
    class ExplodingImage:
        def __array__(self, *a, **k):
            raise OSError("truncated image")

    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3, prefix_cache=4)
    params = _params(DecodeParameters, 4)

    async def run():
        return await asyncio.gather(
            sched.submit("<image>good", [_img(80)], VS, params),
            sched.submit("<image>bad", [ExplodingImage()], VS, params),
            return_exceptions=True)

    ok, bad = asyncio.run(run())
    assert isinstance(bad, OSError)
    assert ok.generated_tokens == ref([("<image>good", 80, 4, ())])[0]


def test_prefix_cache_alias_counts_as_hit(engine):
    sched = ContinuousScheduler(CountingEngine(engine), _Tok(), n_slots=2, max_len=256, chunk_steps=3,
                                prefix_cache=4)
    _tokens(_serve(sched, [("<image>dup", 81, 4, ())] * 4))
    assert sched.prefix_cache.misses == 1
    assert sched.prefix_cache.hits == 3


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_a_packet_joins_twice_unchanged(engine, paged, kv_quant):
    """A join copies (or quantizes) the packet's K/V and never writes into
    it, so a cached packet can fill any number of rows."""
    eng = engine
    pre = eng.prefill_for_slot(_Tok(), "<image>twice", [_img(82)], VS)
    before = {k: pre[k].clone() for k in ("row_k", "row_v", "logits")}
    if paged:
        lang = eng.cfg.language
        cache = new_page_pool(lang.num_hidden_layers, 16, lang.resolved_kv_heads, lang.head_dim,
                              lang.resolved_v_head_dim, 64, 2, 4, torch.float32, kv_quant, "cpu")
        runner = PagedSlotRunner(eng.slot_step_fn, eos_ids=(), allocator=PageAllocator(16))
    else:
        runner = SlotRunner(eng.slot_step_fn, eos_ids=())
        lang = eng.cfg.language
        cache = alloc_slot_cache(lang.num_hidden_layers, 2, lang.resolved_kv_heads, 256, lang.head_dim,
                                 lang.resolved_v_head_dim, torch.float32, kv_quant, "cpu")
    state = runner.init_state(cache, 256)
    params = _params(DecodeParameters, 8)
    for row in (0, 1):
        runner.join(state, row, pre, params, 8)
    for k, v in before.items():
        assert torch.equal(pre[k], v)
    runner.run_chunk(eng.params, state, 4)
    h = runner.harvest(state)
    assert h.generated(0) == h.generated(1) and len(h.generated(0)) == 4


def test_cached_packets_do_not_pin_the_wave(engine):
    from dsocr_tpu_torch.server.scheduler import _cacheable

    pres = engine.prefill_for_slots(_Tok(), [("<image>a", [_img(83)], VS), ("<image>b", [_img(84)], VS)])
    kept = _cacheable(pres[1])
    for k in ("row_k", "row_v", "logits"):
        assert kept[k].untyped_storage().nbytes() == kept[k].numel() * kept[k].element_size()
        assert torch.equal(kept[k], pres[1][k])
    assert pres[1]["row_k"].untyped_storage().nbytes() > kept["row_k"].untyped_storage().nbytes()


# -- load shedding ---------------------------------------------------------------------


def test_admission_cap_sheds(engine, ref):
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2, max_inflight=2)
    params = _params(DecodeParameters, 4)

    async def run():
        first = [asyncio.ensure_future(sched.submit("<image>q", [_img(40 + i)], VS, params))
                 for i in range(2)]
        await asyncio.sleep(0)  # both submits enqueue before the probe
        try:
            await sched.submit("<image>q", [_img(43)], VS, params)
            shed = None
        except QueueDepthExceeded as err:
            shed = err
        outs = await asyncio.gather(*first)
        retry = await sched.submit("<image>q", [_img(43)], VS, params)
        return shed, outs, retry

    shed, outs, retry = asyncio.run(run())
    assert isinstance(shed, RuntimeError) and shed.retry_after_s >= 2.0
    assert (shed.depth, shed.cap) == (2, 2)
    assert sched.shed_requests == 1
    want = ref([("<image>q", 40, 4, ()), ("<image>q", 41, 4, ()), ("<image>q", 43, 4, ())])
    assert [o.generated_tokens for o in outs] + [retry.generated_tokens] == want


# -- device-fault recovery -------------------------------------------------------------


def _flaky(sched, fail_on, make_err=lambda: RuntimeError("synthetic device fault"),
           method="run_chunk_snap"):
    """Raise make_err() on the given (1-based) calls of the runner's method."""
    sched._ensure_state()
    orig = getattr(sched._runner, method)
    calls = {"n": 0}

    def flaky(*args):
        calls["n"] += 1
        if calls["n"] in fail_on:
            raise make_err()
        return orig(*args)

    setattr(sched._runner, method, flaky)
    return calls


REQS3 = [(f"<image>req{i}", 60 + i, 12, ()) for i in range(3)]


@pytest.mark.parametrize("case", ["third_chunk", "first_chunk", "harvest", "oom"])
def test_chunk_fault_recovery_completes_every_request(engine, ref, case):
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3, prefill_batch=2)
    if case == "harvest":
        _flaky(sched, {2}, method="harvest_from_snap")
    elif case == "oom":
        _flaky(sched, {3}, make_err=lambda: torch.cuda.OutOfMemoryError("synthetic out of memory"))
    else:
        # the third chunk: rows have harvested tokens, so they rejoin as
        # continuations; the first: nothing harvested, rows restart
        _flaky(sched, {3} if case == "third_chunk" else {1})
    outs = _tokens(_serve(sched, REQS3))
    assert sched.recoveries == 1
    assert outs == ref(REQS3)


def test_fault_on_a_speculated_chunk(engine, ref):
    spec_calls = []
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2)
    calls = _flaky(sched, set())
    orig_may = sched._may_speculate

    def may(active, chunk):
        ok = orig_may(active, chunk)
        if ok:
            spec_calls.append(calls["n"] + 1)  # the speculated chunk's call number
        return ok

    sched._may_speculate = may
    assert _tokens(_serve(sched, SPEC)) == ref(SPEC)
    assert spec_calls
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2)
    _flaky(sched, {spec_calls[0]})
    assert _tokens(_serve(sched, SPEC)) == ref(SPEC)
    assert sched.recoveries == 1


def test_persistent_fault_gives_up_and_fails_the_futures(engine):
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2)
    calls = _flaky(sched, set(range(1, 100)))
    outs = _serve(sched, [("<image>dead", 71, 6, ())])
    assert isinstance(outs[0], RuntimeError) and "synthetic device fault" in str(outs[0])
    assert sched.recoveries == 3 and calls["n"] == 4
    assert sched._runner is None and sched._state is None
    # the next request builds a new runner and completes
    assert len(_tokens(_serve(sched, [("<image>dead", 71, 6, ())]))[0]) == 6


def test_sticky_cuda_error_is_not_recovered(engine):
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2)
    _flaky(sched, {1}, make_err=lambda: RuntimeError("CUDA error: an illegal memory access was encountered"))
    outs = _serve(sched, [("<image>sticky", 72, 6, ()), ("<image>sticky2", 73, 6, ())])
    assert all(isinstance(o, RuntimeError) and "illegal memory access" in str(o) for o in outs)
    assert sched.recoveries == 0


def test_streamed_tokens_stay_consistent_across_recovery(engine, ref):
    seen = []
    sched = ContinuousScheduler(engine, _Tok(), n_slots=1, max_len=256, chunk_steps=2,
                                stream_chunk_steps=2)
    _flaky(sched, {2})
    req = [("<image>stream-fault", 72, 10, ())]
    out = _tokens(_serve(sched, req, {0: lambda n, toks: seen.append(list(toks))}))
    assert sched.recoveries == 1
    assert out == ref(req)
    for a, b in zip(seen, seen[1:]):
        assert b[: len(a)] == a
    assert seen[-1] == out[0]


def test_streamed_restart_without_continuation_fails_loudly(engine, ref, monkeypatch):
    real = engine.prefill_for_slot

    def no_continuation(tokenizer, prompt, images, vision):
        return real(tokenizer, prompt, images, vision)

    monkeypatch.setattr(engine, "prefill_for_slot", no_continuation)
    seen = []
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2,
                                stream_chunk_steps=2)
    _flaky(sched, {2})
    reqs = [("<image>stream-nc", 90, 10, ()), ("<image>nostream", 90, 10, ())]
    streamed, plain = _serve(sched, reqs, {0: lambda n, toks: seen.append(n)})
    assert isinstance(streamed, RuntimeError) and "cannot resume" in str(streamed)
    assert seen
    assert plain.generated_tokens == ref(reqs[1:])[0]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_recovery_returns_every_page(jax_engine, ref, kv_quant, monkeypatch):
    monkeypatch.setenv("DSOCR_PAGED_KV", "1")
    state = params_from_jax(jax.device_get(jax_engine.params))
    engine = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu",
                               max_seq_len=512, state=state, kv_quant=kv_quant)
    reqs = [("<image>ra", 30, 8, ()), ("<image>rbb", 31, 8, ()), ("<image>rc", 32, 8, ())]
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3)
    _flaky(sched, {2})
    allocator = sched._runner.allocator
    total = allocator.free_count
    outs = _tokens(_serve(sched, reqs))
    assert sched.recoveries == 1
    assert allocator.free_count == total
    if kv_quant is None:
        assert outs == ref(reqs)
    else:  # int8 KV: the port's own fault-free run
        monkeypatch.delenv("DSOCR_PAGED_KV")
        plain = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3)
        assert outs == _tokens(_serve(plain, reqs))


def test_release_all_rows_returns_the_pool(engine):
    runner, cache = engine.make_paged_slot_runner(3, 256, page_size=64)
    state = runner.init_state(cache, 256)
    total = runner.allocator.free_count
    pre = engine.prefill_for_slot(_Tok(), "<image>pages", [_img(85)], VS)
    for row in range(3):
        runner.join(state, row, pre, _params(DecodeParameters, 8), 8)
    assert runner.allocator.free_count < total
    runner.release_all_rows()
    assert runner.allocator.free_count == total and not runner._row_pages
    state = runner.init_state(cache, 256)
    assert bool((cache.tables == -1).all())
    runner.join(state, 0, pre, _params(DecodeParameters, 8), 8)  # the rows are free again


@pytest.mark.parametrize("extra", [[5, 17, 9], list(range(3, 40))])
def test_continuation_packet_matches_the_reference(engine, jax_engine, extra):
    img = _img(86)
    got = engine.prefill_for_slot(_Tok(), "<image>cont", [img], VS, extra_tokens=extra)
    want = jax_engine.prefill_for_slot(_Tok(), "<image>cont", [img], JVS, extra_tokens=extra)
    assert list(got["prompt_ids"]) == [int(t) for t in want["prompt_ids"]]
    assert got["prompt_ids"][-len(extra):] == extra
    assert got["pos0"] == want["pos0"] == len(got["prompt_ids"])
    want_logits = np.asarray(want["logits"], np.float32).reshape(-1)
    np.testing.assert_allclose(got["logits"].numpy(), want_logits, rtol=1e-5, atol=1e-5)
    assert int(got["logits"].argmax()) == int(want_logits.argmax())
    n = len(got["prompt_ids"])
    np.testing.assert_allclose(got["row_k"][:, 0, :, :n].numpy(),
                               np.asarray(want["row_k"])[:, 0, :, :n], rtol=1e-5, atol=1e-5)


# -- the runner's snapshot -------------------------------------------------------------------


def test_snapshot_is_a_copy_the_next_chunk_leaves_alone(engine):
    runner = SlotRunner(engine.slot_step_fn, eos_ids=())  # no EOS: every step appends
    state = runner.init_state(engine.new_slot_cache(2, 256), 256)
    pre = engine.prefill_for_slot(_Tok(), "<image>snap", [_img(87)], VS)
    runner.join(state, 0, pre, _params(DecodeParameters, 20), 20)
    state, snap = runner.run_chunk_snap(engine.params, state, 3)
    first = runner.harvest_from_snap(snap)
    state, snap2 = runner.run_chunk_snap(engine.params, state, 3)
    again = runner.harvest_from_snap(snap)
    assert len(first.generated(0)) == 3 and again.generated(0) == first.generated(0)
    now = runner.harvest(state)
    later = runner.harvest_from_snap(snap2)
    assert now.generated(0) == later.generated(0) and len(now.generated(0)) == 6
    assert now.generated(0)[:3] == first.generated(0)
    np.testing.assert_array_equal(now.active, later.active)


# -- stage timers, trace, admission chunks -----------------------------------------------------


def test_stage_timers_record_the_reference_names(engine):
    rec = T_bench.BenchRecorder()
    T_bench.set_recorder(rec)
    try:
        sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3, prefix_cache=2)
        _tokens(_serve(sched, [("<image>t1", 88, 5, ()), ("<image>t2", 89, 5, ())]))
        _tokens(_serve(sched, [("<image>t1", 88, 5, ())]))
    finally:
        T_bench.set_recorder(None)
    stages = set(rec.stage_totals())
    assert {"slot.prepare_inputs", "slot.vision_towers", "slot.prefill_rows", "slot.join",
            "slot.decode_chunk", "slot.harvest", "slot.release", "slot.prefix_hit"} <= stages
    assert all(v >= 0 for v in rec.stage_totals().values())
    assert T_bench.Timer("x").finish() == 0.0  # no recorder: a no-op


def test_sched_trace_prints_pipeline_events(engine, capsys, monkeypatch):
    monkeypatch.setenv("DSOCR_SCHED_TRACE", "1")
    sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3)
    _tokens(_serve(sched, [("<image>tr", 95, 4, ())]))
    out = capsys.readouterr().out
    for event in ("wave_grab", "wave_prepared", "packet_put", "join", "chunk_start", "harvest_done"):
        assert f"] {event} " in out


def test_admit_chunk_shortens_chunks_while_a_wave_prefills(engine, ref, monkeypatch):
    monkeypatch.setenv("DSOCR_ADMIT_CHUNK", "2")
    sched = ContinuousScheduler(engine, _Tok(), n_slots=3, max_len=256, chunk_steps=6, prefill_batch=1)
    steps = []
    sched._ensure_state()
    orig = sched._runner.run_chunk_snap

    def spy(params, state, n):
        steps.append(n)
        return orig(params, state, n)

    sched._runner.run_chunk_snap = spy
    reqs = [("<image>ad1", 96, 10, ()), ("<image>ad2", 97, 10, ()), ("<image>ad3", 98, 10, ())]
    assert _tokens(_serve(sched, reqs)) == ref(reqs)
    # short while the later waves prefill beside free rows, full after
    assert set(steps) == {2, 6} and steps[0] == 2 and steps[-1] == 6


# -- core/streaming and core/benchmark ------------------------------------------------------------


@pytest.mark.parametrize("prev,cur", [("", "abc"), ("ab", "abc"), ("abc", "abd"), ("abc", "x"),
                                      ("héllo", "héllo wörld"), ("a�", "ab")])
def test_extract_delta_matches_the_reference(prev, cur):
    assert T_stream.extract_delta(prev, cur) == J_stream.extract_delta(prev, cur)


def test_delta_tracker_matches_the_reference():
    updates = [("He", False), ("Hel�", False), ("Hell��", False), ("Hello wo", False),
               ("Hello wor�", True), ("Hello world", True)]
    got, want = T_stream.DeltaTracker(), J_stream.DeltaTracker()
    for text, final in updates:
        assert got.advance(text, final) == want.advance(text, final)
        assert got.snapshot == want.snapshot
    got.reset()
    assert got.snapshot == ""


def test_bench_recorder_matches_the_reference(tmp_path):
    out = {}
    for name, mod in (("port", T_bench), ("ref", J_bench)):
        rec = mod.BenchRecorder()
        rec.record(mod.BenchEvent("a", 1.5, {"n": 2}))
        rec.record(mod.BenchEvent("a", 2.0))
        rec.record_instant("b", rows=3)
        mod.set_recorder(rec)
        try:
            mod.record_instant("c")
            with mod.Timer("d"):
                pass
            assert mod.get_recorder() is rec
        finally:
            mod.set_recorder(None)
        rec.dump(str(tmp_path / f"{name}.json"))
        data = rec.to_json()
        for event in data["events"]:
            if event["stage"] == "d":
                event["duration_ms"] = 0.0
        data["stage_totals"]["d"] = 0.0
        out[name] = data
    assert out["port"] == out["ref"]
    assert (tmp_path / "port.json").read_text().startswith("{")


# -- the engine's own refusals ------------------------------------------------------------


class _GreedyOnly:
    """The tiny engine behind the hook GLM-OCR's engine has: sampling is
    refused before the request joins."""

    def __init__(self, engine):
        self._engine = engine
        self.asked = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def validate_slot_params(self, params):
        self.asked.append(params.do_sample)
        if params.do_sample or params.temperature != 0.0:
            raise ValueError("this backend requires greedy decoding (do_sample=false)")


def test_engine_validate_slot_params_refuses_before_the_join(engine, ref):
    """As the reference's scheduler does, the port's asks the engine's
    validate_slot_params first: the sampled request fails alone with the
    hook's ValueError, the greedy ones beside it finish with the
    reference's tokens."""
    greedy = _GreedyOnly(engine)
    sched = ContinuousScheduler(greedy, _Tok(), n_slots=2, max_len=256, chunk_steps=4)
    requests = [("<image>\nFree OCR.", 1, 6, ()), ("<image>\nFree OCR.", 2, 6, (("do_sample", True),)),
                ("<image>\nFree OCR.", 3, 6, ())]
    outs = _serve(sched, requests)
    assert isinstance(outs[1], ValueError) and "greedy" in str(outs[1])
    assert _tokens([outs[0], outs[2]]) == ref([requests[0], requests[2]])
    assert sorted(greedy.asked) == [False, False, True]
