"""Continuous-batching serving through the port's ContinuousScheduler
against the reference's, on the same weights (tiny config, f32, 2 slots):
greedy tokens must be identical with a model-dtype and an int8 KV cache,
including a request that joins while another row is mid-generation (the
test orders the prefill and decode threads so that it does). (The
model-dtype cache is bf16 on the card; here it is f32, because XLA's CPU
backend cannot run the reference engine in bf16.)
Also the join_many retry path: a failed batched join leaves the state
intact, and only the bad request fails.

Packed Q8_0 serving: the port's scheduler on params_from_jax of the
reference's Q8_0 engine gives the reference's greedy tokens in both decode
tiers (2 slots gather, 4 slots run the dense sweep: 4 experts at top-2),
and its prefill at S > 32 (packed experts dequantized) matches
deepseek_forward within the tolerance of tests/test_torch_deepseek.py.

Packed Q4_K serving, at hidden 256 (K-quants need in dims % 256): the same
against the reference's Q4_K engine at 2 and 4 slots, f32 and int8 KV, on
a mixed group (Q4_K gate+up, Q8_0 down, as at full width) and, at 2 and 4
slots with f32 KV, on an all-Q4_K group; each decode tier runs the
kernels of each projection's own format. Packed Q6_K serving: the same
against the reference's Q6_K engine, mixed (Q6_K gate+up, Q8_0 down) and
all-Q6_K groups."""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.decoder import build_decoder_rope, deepseek_forward, new_cache
from dsocr_tpu.runtime.kv_cache import reset
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.runtime.slots import SlotRunner
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

BUDGETS = [3, 10, 10]  # the first row finishes early; the third joins mid-flight


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


def _images():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in BUDGETS]


def _serve(sched, params_cls, vision):
    async def run():
        return await asyncio.gather(*(
            sched.submit("<image>q", [img], vision,
                         params_cls(max_new_tokens=n, no_repeat_ngram_size=None))
            for img, n in zip(_images(), BUDGETS)
        ))

    return [o.generated_tokens for o in asyncio.run(run())]


@pytest.fixture(scope="module")
def jax_engines():
    return {
        kvq: JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512, kv_quant=kvq)
        for kvq in (None, "int8")
    }


def _port(jax_engine, kv_quant):
    state = params_from_jax(jax.device_get(jax_engine.params))
    return DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu",
                             max_seq_len=512, kv_quant=kv_quant, state=state)


def _admit_after_second_wave(monkeypatch, timeout=120.0):
    """Order the scheduler's threads. With 2 slots, requests 1 and 2 form
    the first prefill wave and request 3 the second, which is prepared on
    an executor thread while decode chunks run on another. Request 1 (3
    tokens) leaves after the first chunk of 4 steps, request 2 (10 tokens)
    in the third. The admission that follows request 1's release waits
    until the second wave's packet is queued, so request 3 joins while
    request 2 decodes however the host schedules the threads. A packet
    that is not queued within `timeout` seconds fails every request."""
    released = []
    orig_release = SlotRunner.release

    def release(self, state, row):
        released.append(row)
        return orig_release(self, state, row)

    held = []
    orig_admit = ContinuousScheduler._admit_ready

    async def admit_ready(self, loop):
        if released and not held:
            held.append(released[0])
            deadline = time.monotonic() + timeout
            while self._ready_q.empty() and not self._deferred:
                if time.monotonic() > deadline:
                    raise AssertionError(f"the second prefill wave was not queued within {timeout} s "
                                         f"of row {held[0]}'s release")
                await asyncio.sleep(0.005)
        return await orig_admit(self, loop)

    monkeypatch.setattr(SlotRunner, "release", release)
    monkeypatch.setattr(ContinuousScheduler, "_admit_ready", admit_ready)
    return held


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_greedy_tokens_match_reference_scheduler(jax_engines, kv_quant, monkeypatch):
    jax_engine = jax_engines[kv_quant]
    want = _serve(JaxScheduler(jax_engine, _Tok(), n_slots=2, max_len=256, chunk_steps=4),
                  JaxParams, JaxVision(64, 64, False))

    busy_joins = []  # was another row live when a request joined?
    for name in ("join", "join_many"):
        orig = getattr(SlotRunner, name)

        def spy(self, state, *args, _orig=orig, **kw):
            busy_joins.append(bool(state.active.any()))
            return _orig(self, state, *args, **kw)

        monkeypatch.setattr(SlotRunner, name, spy)
    held = _admit_after_second_wave(monkeypatch)
    sched = ContinuousScheduler(_port(jax_engine, kv_quant), _Tok(), n_slots=2, max_len=256,
                                chunk_steps=4)
    got = _serve(sched, DecodeParameters, VisionSettings(64, 64, False))
    assert [len(t) for t in got] == BUDGETS
    assert got == want
    assert held, "no request left its slot while others waited"
    assert any(busy_joins), "no request joined while another was decoding"
    assert len(sched.ttft_samples) == len(BUDGETS)


def test_failed_join_many_retries_per_row(jax_engines, monkeypatch):
    port = _port(jax_engines[None], None)
    clean = _serve(ContinuousScheduler(port, _Tok(), n_slots=4, max_len=256, chunk_steps=4),
                   DecodeParameters, VisionSettings(64, 64, False))

    orig_prefill = port.prefill_for_slots

    def corrupt_second(tokenizer, requests):
        packets = orig_prefill(tokenizer, requests)
        if len(packets) > 1:  # a K block with the wrong head count cannot join
            packets[1] = dict(packets[1], row_k=packets[1]["row_k"][:, :, :1])
        return packets

    monkeypatch.setattr(port, "prefill_for_slots", corrupt_second)
    calls = []
    orig_join_many = SlotRunner.join_many

    def spy_join_many(self, state, rows, packets, *args):
        before = [t.clone() for t in (state.context, state.ctx_len, state.active, state.cache.k)]
        try:
            return orig_join_many(self, state, rows, packets, *args)
        except ValueError:
            after = (state.context, state.ctx_len, state.active, state.cache.k)
            calls.append(all(torch.equal(a, b) for a, b in zip(before, after)))
            raise

    monkeypatch.setattr(SlotRunner, "join_many", spy_join_many)
    sched = ContinuousScheduler(port, _Tok(), n_slots=4, max_len=256, chunk_steps=4,
                                prefill_batch=3)

    async def run():
        return await asyncio.gather(*(
            sched.submit("<image>q", [img], VisionSettings(64, 64, False),
                         DecodeParameters(max_new_tokens=n, no_repeat_ngram_size=None))
            for img, n in zip(_images(), BUDGETS)
        ), return_exceptions=True)

    outs = asyncio.run(run())
    assert calls == [True], "join_many must fail once, leaving the state untouched"
    assert isinstance(outs[1], ValueError)
    assert outs[0].generated_tokens == clean[0]
    assert outs[2].generated_tokens == clean[2]


# -- packed Q8_0 --------------------------------------------------------------------


def _q8_cfg(cfg):
    """Q8_0 blocks need every contraction dim % 32 (the reference's own
    quantized test config, tests/test_deepseek.py)."""
    lang = dataclasses.replace(cfg.language, moe_intermediate_size=32, intermediate_size=64)
    return dataclasses.replace(cfg, language=lang)


@pytest.fixture(scope="module")
def jax_q8_engines():
    """The reference's Q8_0 engines, quantized from one float engine."""
    float_engine = JaxEngine(_q8_cfg(jax_tiny()), dtype=jnp.float32, max_seq_len=512)
    return {
        kvq: JaxEngine(_q8_cfg(jax_tiny()), params=jax.tree_util.tree_map(lambda x: x, float_engine.params),
                       dtype=jnp.float32, max_seq_len=512, kv_quant=kvq, quantize="q8_0")
        for kvq in (None, "int8")
    }


def _port_q8(jax_engine, kv_quant):
    state = params_from_jax(jax.device_get(jax_engine.params))
    port = DeepseekOcrEngine(_q8_cfg(tiny_deepseek_config()), dtype=torch.float32, device="cpu",
                             max_seq_len=512, kv_quant=kv_quant, state=state, quantize="q8_0")
    assert set(state) == set(port.model.state_dict())
    assert state["decoder.moe_layers.0.experts_gateup.codes"].dtype == torch.int8
    return port


@pytest.mark.parametrize("n_slots,tier", [(2, "q8_gather_matmul"), (4, "q8_dense_experts")])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_q8_greedy_tokens_match_reference_scheduler(jax_q8_engines, kv_quant, n_slots, tier, monkeypatch):
    import dsocr_tpu_torch.ops.linear as port_linear

    jax_engine = jax_q8_engines[kv_quant]
    want = _serve(JaxScheduler(jax_engine, _Tok(), n_slots=n_slots, max_len=256, chunk_steps=4),
                  JaxParams, JaxVision(64, 64, False))
    ran = []
    for name in ("q8_gather_matmul", "q8_dense_experts"):
        orig = getattr(port_linear, name)
        monkeypatch.setattr(port_linear, name, lambda *a, _o=orig, _n=name: ran.append(_n) or _o(*a))
    sched = ContinuousScheduler(_port_q8(jax_engine, kv_quant), _Tok(), n_slots=n_slots,
                                max_len=256, chunk_steps=4)
    got = _serve(sched, DecodeParameters, VisionSettings(64, 64, False))
    assert [len(t) for t in got] == BUDGETS
    assert got == want
    assert set(ran) == {tier}, f"decode ran {set(ran)}, expected the {tier} tier only"


def test_q8_prefill_dequant_path_matches_deepseek_forward(jax_q8_engines, monkeypatch):
    import dsocr_tpu_torch.models.deepseek.decoder as port_decoder

    jax_engine = jax_q8_engines[None]
    lang = jax_engine.cfg.language
    params = jax_engine.params["decoder"]
    S = 40  # > 32: the packed experts dequantize to bf16 for the grouped tier
    rng = np.random.default_rng(4)
    embeds = np.asarray(params["embed_tokens"])[rng.integers(0, lang.vocab_size, size=S)][None]
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = deepseek_forward(params, lang, jnp.asarray(embeds), jnp.asarray(pos),
                               reset(new_cache(lang, 1, 64, jnp.float32)), build_decoder_rope(lang, 64))
    port = _port_q8(jax_engine, None)
    dequantized = []
    orig = port_decoder.dequant_stack
    monkeypatch.setattr(port_decoder, "dequant_stack", lambda q: dequantized.append(1) or orig(q))
    with torch.no_grad():
        got, _, _ = port.model.decoder.prefill(torch.from_numpy(embeds), torch.from_numpy(pos).long(),
                                               port._rope)
    assert len(dequantized) == 2 * (lang.num_hidden_layers - 1)  # both stacks of each MoE layer
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# -- packed K-quants (Q4_K, Q6_K) ------------------------------------------------------


def _kq_cfg(cfg, moe_inter):
    """K-quant super-blocks need in dims % 256: hidden 256 (the reference's
    own K-quant engine test, tests/test_kquant_matmul.py). moe_inter 32
    leaves the routed and shared down projections to Q8_0, a mixed group
    as at full width; 256 packs every projection as the K-quant."""
    lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=moe_inter)
    return dataclasses.replace(cfg, projector_n_embed=256, language=lang)


# At moe_inter 256, seed 0's weights end a row on EOS at once; seed 3's
# rows reach their budgets.
_KQ_SEEDS = {32: 0, 256: 3}


@pytest.fixture(scope="module")
def jax_kq_engines():
    """(method, moe_inter, kv_quant) → the reference's K-quant engine (NumPy
    quantizer), quantized from one float engine per config, built on first
    use."""
    floats, engines = {}, {}

    def get(method, moe_inter, kv_quant):
        key = (method, moe_inter, kv_quant)
        if key not in engines:
            cfg = _kq_cfg(jax_tiny(), moe_inter)
            if moe_inter not in floats:
                floats[moe_inter] = JaxEngine(cfg, dtype=jnp.float32, max_seq_len=512,
                                              seed=_KQ_SEEDS[moe_inter])
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("DSOCR_NO_NATIVE", "1")
                engines[key] = JaxEngine(
                    cfg, params=jax.tree_util.tree_map(lambda x: x, floats[moe_inter].params),
                    dtype=jnp.float32, max_seq_len=512, kv_quant=kv_quant, quantize=method)
        return engines[key]

    return get


def _port_kq(jax_engine, method, moe_inter, kv_quant):
    state = params_from_jax(jax.device_get(jax_engine.params))
    port = DeepseekOcrEngine(_kq_cfg(tiny_deepseek_config(), moe_inter), dtype=torch.float32,
                             device="cpu", max_seq_len=512, kv_quant=kv_quant, state=state,
                             quantize=method)
    assert set(state) == set(port.model.state_dict())
    assert state["decoder.moe_layers.0.experts_gateup.codes"].dtype == torch.uint8
    return port


def _kq_greedy_tokens_match(get, method, moe_inter, n_slots, kv_quant, kernels, monkeypatch):
    import dsocr_tpu_torch.ops.linear as port_linear

    jax_engine = get(method, moe_inter, kv_quant)
    want = _serve(JaxScheduler(jax_engine, _Tok(), n_slots=n_slots, max_len=256, chunk_steps=4),
                  JaxParams, JaxVision(64, 64, False))
    fmt = method.replace("_", "")  # q4k, q6k
    ran = []
    for name in ("gather_matmul", "dense_experts", "dense_experts_perx"):
        for prefix in (fmt, "q8"):
            orig = getattr(port_linear, f"{prefix}_{name}")
            monkeypatch.setattr(port_linear, f"{prefix}_{name}",
                                lambda *a, _o=orig, _n=f"{prefix}_{name}": ran.append(_n) or _o(*a))
    sched = ContinuousScheduler(_port_kq(jax_engine, method, moe_inter, kv_quant), _Tok(),
                                n_slots=n_slots, max_len=256, chunk_steps=4)
    got = _serve(sched, DecodeParameters, VisionSettings(64, 64, False))
    assert [len(t) for t in got] == BUDGETS
    assert got == want
    assert set(ran) == kernels, f"decode ran {set(ran)}, expected {kernels}"


@pytest.mark.parametrize("moe_inter,n_slots,kv_quant,kernels", [
    (32, 2, None, {"q4k_gather_matmul", "q8_gather_matmul"}),
    (32, 2, "int8", {"q4k_gather_matmul", "q8_gather_matmul"}),
    (32, 4, None, {"q4k_dense_experts", "q8_dense_experts_perx"}),
    (32, 4, "int8", {"q4k_dense_experts", "q8_dense_experts_perx"}),
    (256, 2, None, {"q4k_gather_matmul"}),
    (256, 4, None, {"q4k_dense_experts", "q4k_dense_experts_perx"}),
])
def test_q4k_greedy_tokens_match_reference_scheduler(jax_kq_engines, moe_inter, n_slots, kv_quant,
                                                     kernels, monkeypatch):
    """moe_inter 32: Q4_K gate+up with a Q8_0 down; 256: all Q4_K. Two
    slots gather (N·top_k ≤ 4 experts), four sweep every expert."""
    _kq_greedy_tokens_match(jax_kq_engines, "q4_k", moe_inter, n_slots, kv_quant, kernels, monkeypatch)


@pytest.mark.parametrize("moe_inter,n_slots,kv_quant,kernels", [
    (32, 2, None, {"q6k_gather_matmul", "q8_gather_matmul"}),
    (32, 2, "int8", {"q6k_gather_matmul", "q8_gather_matmul"}),
    (32, 4, None, {"q6k_dense_experts", "q8_dense_experts_perx"}),
    (32, 4, "int8", {"q6k_dense_experts", "q8_dense_experts_perx"}),
    (256, 2, None, {"q6k_gather_matmul"}),
    (256, 4, None, {"q6k_dense_experts", "q6k_dense_experts_perx"}),
])
def test_q6k_greedy_tokens_match_reference_scheduler(jax_kq_engines, moe_inter, n_slots, kv_quant,
                                                     kernels, monkeypatch):
    """moe_inter 32: Q6_K gate+up with a Q8_0 down, as at full width; 256:
    all Q6_K, the path that reaches q6k_dense_experts_perx."""
    _kq_greedy_tokens_match(jax_kq_engines, "q6_k", moe_inter, n_slots, kv_quant, kernels, monkeypatch)
