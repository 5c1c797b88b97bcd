"""Single-request decode in the port against the reference, on the same
inputs and weights (numpy seeds, params_from_jax / decoder_state_from_jax):

- runtime/kv_cache.py: write, layer views, length bumps and reset equal
  the reference's KVCache functions;
- runtime/generate.py: clamp_new_tokens, and the Generator's tokens, step
  count and per-chunk stream callbacks equal the reference Generator's
  over the same deterministic step function (EOS as the first token,
  EOS mid-way with emit_eos off and on, a repetition penalty and an
  n-gram ban);
- the decoder's split layout over a contiguous KVCache (prefill 3, then
  decode 2) against deepseek_forward on the reference's split tree, in
  f32 and bf16, float and packed (Q8_0, Q4_K with a Q8_0 down, Q6_K), and
  against the port's fused layout of the same weights; the split stacks
  pack bit-exact with the reference's quantize_decoder_params;
- engine.decode with and without the cache: greedy generated_tokens and
  truncated equal the reference engine's, f32, bf16 and Q8_0.

Tolerances: f32 atol = rtol = 1e-4 on logits (sums in another order);
the packed decoders 1e-4 as well (the kernels' twins round x to bf16 as
the Pallas kernels do); bf16 runs the port in bf16 against the reference
in f32 on the same bf16 weights (XLA's CPU backend has no bf16 × bf16 → f32
dot at these shapes): 2^-4 of the largest logit, bf16 roundings of the
hidden state through three layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.decoder import build_decoder_rope, deepseek_forward, init_deepseek_params
from dsocr_tpu.models.deepseek.decoder import fuse_decoder_params as jax_fuse
from dsocr_tpu.models.deepseek.decoder import new_cache
from dsocr_tpu.models.deepseek.quantize import quantize_decoder_params as jax_quantize
from dsocr_tpu.runtime import generate as jax_gen
from dsocr_tpu.runtime import kv_cache as jax_kv
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.models.deepseek.convert import decoder_state_from_jax
from dsocr_tpu_torch.models.deepseek.decoder import DeepseekDecoder, fuse_decoder_params
from dsocr_tpu_torch.models.deepseek.quantize import quantize_decoder_params
from dsocr_tpu_torch.ops.rope import build_rope_tables
from dsocr_tpu_torch.runtime import generate as gen
from dsocr_tpu_torch.runtime import kv_cache as kv

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


# -- kv_cache --------------------------------------------------------------------------------


def test_kv_cache_matches_reference():
    rng = np.random.default_rng(0)
    k_new = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    v_new = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    ref = jax_kv.init_kv_cache(3, 2, 3, 10, 8, 6, jnp.float32)
    ref = jax_kv.bump_length(jax_kv.write_kv(ref, 1, jnp.asarray(k_new), jnp.asarray(v_new), 5), 4)
    port = kv.init_kv_cache(3, 2, 3, 10, 8, 6, torch.float32)
    port = kv.bump_length(kv.write_kv(port, 1, torch.from_numpy(k_new), torch.from_numpy(v_new), 5), 4)
    assert port.length == int(ref.length) == 4 and port.max_len == ref.max_len == 10
    assert port.num_layers == ref.num_layers == 3
    for got, want in zip(kv.layer_kv(port, 1), jax_kv.layer_kv(ref, 1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(port.k.numpy(), np.asarray(ref.k))
    assert kv.reset(port).length == int(jax_kv.reset(ref).length) == 0
    with pytest.raises(ValueError):  # the reference would clamp the write onto [6, 10)
        kv.write_kv(port, 0, torch.from_numpy(k_new), torch.from_numpy(v_new), 8)


# -- generate ----------------------------------------------------------------------------------


@pytest.mark.parametrize("prompt_pad,requested,max_seq", [(128, 64, 512), (128, 600, 512), (512, 8, 512),
                                                          (640, 8, 512)])
def test_clamp_new_tokens_matches_reference(prompt_pad, requested, max_seq):
    try:
        want = jax_gen.clamp_new_tokens(prompt_pad, requested, max_seq)
    except ValueError:
        with pytest.raises(ValueError):
            gen.clamp_new_tokens(prompt_pad, requested, max_seq)
        return
    assert gen.clamp_new_tokens(prompt_pad, requested, max_seq) == want


V, EOS = 16, 2


def _table(seed):
    """A deterministic next-token logit table [V, V]: token 5 is followed by
    EOS; the prefill logits pick 5 for row 0 and 7 for row 1."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, V)).astype(np.float32)
    table[5, EOS] = 10.0
    prefill = rng.normal(size=(2, V)).astype(np.float32)
    prefill[0, 5] = prefill[1, 7] = 10.0
    return table, prefill


def _generate_both(params_kw, prefill, table, prompts):
    """(reference result and stream calls, port result and stream calls)."""
    out = []
    for lib in ("jax", "torch"):
        calls = []
        cb = lambda steps, toks, _c=calls: _c.append((steps, list(toks)))  # noqa: E731
        if lib == "jax":
            tab = jnp.asarray(table)
            step = lambda p, ids, cache, pos: (tab[ids], cache, pos)  # noqa: E731
            g = jax_gen.Generator(step, jax_gen.GenerateParams(**params_kw))
            cache = jax_kv.init_kv_cache(1, 2, 1, 4, 1, 1, jnp.float32)
            res = g.generate(None, jnp.asarray(prefill), cache, None, prompts, stream_callback=cb)
        else:
            tab = torch.from_numpy(table)
            step = lambda p, ids, cache, pos: (tab[ids], cache, pos)  # noqa: E731
            g = gen.Generator(step, gen.GenerateParams(**params_kw))
            cache = kv.init_kv_cache(1, 2, 1, 4, 1, 1, torch.float32)
            res = g.generate(None, torch.from_numpy(prefill), cache, None, prompts, stream_callback=cb)
        out.append((res.tokens, res.prompt_tokens, res.steps, calls))
    return out


@pytest.mark.parametrize("emit_eos", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("knobs", [{}, {"repetition_penalty": 1.3, "no_repeat_ngram_size": 3}])
def test_generator_matches_reference(seed, emit_eos, knobs):
    """Two rows in lockstep, 12 new tokens in chunks of 5 (the callback runs
    after each chunk): row 0 ends at EOS after one token."""
    table, prefill = _table(seed)
    prompts = [[3, 4, 9], [1, 8, 9, 11, 12]]
    kw = dict(max_new_tokens=12, eos_ids=(EOS,), chunk_size=5, emit_eos=emit_eos, **knobs)
    want, got = _generate_both(kw, prefill, table, prompts)
    assert got == want
    assert len(got[0][0]) == (2 if emit_eos else 1)  # [5] or [5, EOS]


def test_generator_eos_first_token_is_an_empty_generation():
    table, prefill = _table(0)
    prefill[:, EOS] = 100.0
    want, got = _generate_both(dict(max_new_tokens=6, eos_ids=(EOS,)), prefill, table, [[1], [2, 3]])
    assert got == want and got[0] == [[], []] and got[2] == 0


# -- the decoder over a KVCache -------------------------------------------------------------------


def _lang(hidden=None, inter=None):
    lang = jax_tiny().language
    port = tiny_deepseek_config().language
    kw = {k: v for k, v in (("hidden_size", hidden), ("moe_intermediate_size", inter)) if v}
    return dataclasses.replace(lang, **kw), dataclasses.replace(port, **kw)


def _bf16_values(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), tree)


def _run_reference(params, lang, embeds, n_prefill):
    rope = build_decoder_rope(lang, 64)
    S = embeds.shape[1]
    pos = jnp.arange(S, dtype=jnp.int32)[None]
    cache = jax_kv.reset(new_cache(lang, 1, 16, jnp.float32))
    logits, cache = deepseek_forward(params, lang, jnp.asarray(embeds[:, :n_prefill]), pos[:, :n_prefill],
                                     cache, rope)
    out = [np.asarray(logits[0])]
    cache = jax_kv.bump_length(cache, n_prefill)
    for s in range(n_prefill, S):
        logits, cache = deepseek_forward(params, lang, jnp.asarray(embeds[:, s : s + 1]),
                                         pos[:, s : s + 1], cache, rope)
        cache = jax_kv.bump_length(cache, 1)
        out.append(np.asarray(logits[0]))
    return out


def _run_port(decoder, lang, embeds, n_prefill, dtype=torch.float32):
    cfg = decoder.cfg
    rope = build_rope_tables(64, cfg.rope_dim, cfg.rope_theta, "cpu")
    x = torch.from_numpy(embeds).to(dtype)
    S = x.shape[1]
    pos = torch.arange(S)[None]
    cache = kv.init_kv_cache(cfg.num_hidden_layers, 1, cfg.resolved_kv_heads, 16, cfg.head_dim,
                             cfg.resolved_v_head_dim, dtype)
    with torch.no_grad():
        logits, cache = decoder(x[:, :n_prefill], pos[:, :n_prefill], cache, rope)
        out = [logits[0].float().numpy()]
        cache = kv.bump_length(cache, n_prefill)
        for s in range(n_prefill, S):
            logits, cache = decoder(x[:, s : s + 1], pos[:, s : s + 1], cache, rope)
            cache = kv.bump_length(cache, 1)
            out.append(logits[0].float().numpy())
    return out


def _embeds(params, lang, seed=1, S=5):
    tokens = np.random.default_rng(seed).integers(0, lang.vocab_size, S)
    return np.asarray(params["embed_tokens"])[tokens][None].astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_decoder_over_kv_cache_matches_deepseek_forward(dtype):
    lang, port_lang = _lang()
    params = jax.device_get(init_deepseek_params(lang, jax.random.PRNGKey(0), jnp.float32))
    if dtype == "bf16":
        params = _bf16_values(params)
    tdtype = torch.float32 if dtype == "f32" else torch.bfloat16
    decoder = DeepseekDecoder.from_state(port_lang, decoder_state_from_jax(params), tdtype, "cpu")
    assert decoder.moe_layers[0].split and hasattr(decoder.moe_layers[0], "experts_gate")
    embeds = _embeds(params, lang)
    want = _run_reference(params, lang, embeds, 3)
    got = _run_port(decoder, port_lang, embeds, 3, tdtype)
    for g, w in zip(got, want):
        if dtype == "f32":
            np.testing.assert_allclose(g, w, **TOL)
        else:
            assert float(np.abs(g - w).max()) <= 2.0 ** -4 * float(np.abs(w).max())


def test_full_logits_with_left_padding_match_deepseek_forward():
    """The forward's other two knobs: logits at every position and
    left-padded rows (pad_start), split layout, against deepseek_forward
    on two rows padded by 0 and 2 positions (compared where a row is live)."""
    lang, port_lang = _lang()
    params = jax.device_get(init_deepseek_params(lang, jax.random.PRNGKey(6), jnp.float32))
    decoder = DeepseekDecoder.from_state(port_lang, decoder_state_from_jax(params), torch.float32, "cpu")
    S, pads = 6, np.array([0, 2], np.int32)
    embeds = np.concatenate([_embeds(params, lang, seed=7, S=S), _embeds(params, lang, seed=8, S=S)])
    pos = np.maximum(np.arange(S)[None] - pads[:, None], 0).astype(np.int32)
    want, _ = deepseek_forward(params, lang, jnp.asarray(embeds), jnp.asarray(pos),
                               jax_kv.reset(new_cache(lang, 2, 8, jnp.float32)), build_decoder_rope(lang, 64),
                               full_logits=True, pad_start=jnp.asarray(pads))
    cfg = decoder.cfg
    cache = kv.init_kv_cache(cfg.num_hidden_layers, 2, cfg.resolved_kv_heads, 8, cfg.head_dim,
                             cfg.resolved_v_head_dim, torch.float32)
    with torch.no_grad():
        got, _ = decoder(torch.from_numpy(embeds), torch.from_numpy(pos).long(), cache,
                         build_rope_tables(64, cfg.rope_dim, cfg.rope_theta, "cpu"), full_logits=True,
                         pad_start=torch.from_numpy(pads))
    assert got.shape == (2, S, lang.vocab_size)
    for row, pad in enumerate(pads):
        np.testing.assert_allclose(got[row, pad:].numpy(), np.asarray(want)[row, pad:], **TOL)


def test_split_and_fused_layouts_agree():
    lang, port_lang = _lang()
    params = jax.device_get(init_deepseek_params(lang, jax.random.PRNGKey(2), jnp.float32))
    state = decoder_state_from_jax(params)
    split = DeepseekDecoder.from_state(port_lang, state, torch.float32, "cpu")
    fused = DeepseekDecoder.from_state(port_lang, fuse_decoder_params(state), torch.float32, "cpu")
    assert not fused.moe_layers[0].split and hasattr(fused.moe_layers[0], "experts_gateup")
    embeds = _embeds(params, lang, seed=3)
    for a, b in zip(_run_port(split, port_lang, embeds, 3), _run_port(fused, port_lang, embeds, 3)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    # the reference's fusion of the same tree is the port's
    want = decoder_state_from_jax(jax.device_get(jax_fuse(params)))
    got = fuse_decoder_params(state)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("method,hidden,inter", [("q8_0", None, 32), ("q4_k", 256, 32), ("q6_k", 256, 256)])
def test_packed_split_decoder_matches_deepseek_forward(method, hidden, inter):
    """The reference's quantize_decoder_params on a split tree (no fusion):
    its packed stacks equal the port's packing of the same float weights bit
    for bit, and the packed split decoder's prefill and decode steps (the
    packed gather kernels' twins at B·S ≤ 32) match deepseek_forward."""
    lang, port_lang = _lang(hidden, inter)
    params = jax.device_get(init_deepseek_params(lang, jax.random.PRNGKey(4), jnp.float32))
    packed = jax.device_get(jax_quantize(params, method))
    state = decoder_state_from_jax(packed)
    assert "moe_layers.0.experts_gate.codes" in state and "moe_layers.0.q_proj.codes" in state
    prefixed = {f"decoder.{key}": v for key, v in decoder_state_from_jax(params).items()}
    mine = {key[len("decoder."):]: v for key, v in quantize_decoder_params(prefixed, method).items()}
    assert set(mine) == set(state)
    for key in state:
        assert torch.equal(mine[key], state[key]), key
    decoder = DeepseekDecoder.from_state(port_lang, state, torch.float32, "cpu")
    embeds = _embeds(params, lang, seed=5)
    for g, w in zip(_run_port(decoder, port_lang, embeds, 3), _run_reference(packed, lang, embeds, 3)):
        np.testing.assert_allclose(g, w, **TOL)


def test_kv_cache_forward_refuses_int8_scales():
    _, port_lang = _lang()
    decoder = DeepseekDecoder(port_lang, torch.float32, "cpu")
    cache = kv.init_kv_cache(port_lang.num_hidden_layers, 1, port_lang.resolved_kv_heads, 8,
                             port_lang.head_dim, port_lang.resolved_v_head_dim, torch.float32)
    cache = cache._replace(k_scale=torch.ones(1), v_scale=torch.ones(1))
    rope = build_rope_tables(8, port_lang.rope_dim, port_lang.rope_theta, "cpu")
    with pytest.raises(ValueError, match="int8"):
        decoder(torch.zeros(1, 1, port_lang.hidden_size), torch.zeros(1, 1, dtype=torch.long), cache, rope)


# -- engine.decode -----------------------------------------------------------------------------------


def _image():
    return np.random.default_rng(3).integers(0, 256, size=(60, 60, 3), dtype=np.uint8)


_ENGINES = {}


def _engines(dtype, quantize):
    """(reference, port) engines on the same weights, built once."""
    key = (dtype, quantize)
    if key not in _ENGINES:
        cfg = jax_tiny()
        if quantize:  # Q8_0 blocks need every contraction dim % 32
            cfg = dataclasses.replace(cfg, language=dataclasses.replace(cfg.language,
                                                                        moe_intermediate_size=32))
        port_cfg = tiny_deepseek_config()
        port_cfg = dataclasses.replace(port_cfg, language=dataclasses.replace(
            port_cfg.language, moe_intermediate_size=cfg.language.moe_intermediate_size))
        jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
        ref = JaxEngine(cfg, dtype=jdt, max_seq_len=512, quantize=quantize)
        state = params_from_jax(jax.device_get(ref.params))
        port = DeepseekOcrEngine(port_cfg, dtype=tdt, device="cpu", max_seq_len=512, state=state,
                                 quantize=quantize)
        _ENGINES[key] = ref, port
    return _ENGINES[key]


@pytest.mark.parametrize("dtype,quantize", [("f32", None), ("bf16", None), ("f32", "q8_0")])
@pytest.mark.parametrize("use_cache", [True, False])
def test_engine_decode_matches_reference(dtype, quantize, use_cache):
    ref, port = _engines(dtype, quantize)
    n = 8 if use_cache else 4
    want = ref.decode(_Tok(), "<image>\nFree OCR.", [_image()], JaxVision(64, 64, False),
                      JaxParams(max_new_tokens=n, use_cache=use_cache))
    streamed = []
    got = port.decode(_Tok(), "<image>\nFree OCR.", [_image()], VisionSettings(64, 64, False),
                      DecodeParameters(max_new_tokens=n, use_cache=use_cache),
                      stream=lambda steps, toks: streamed.append(list(toks)))
    assert got.generated_tokens == want.generated_tokens
    assert (got.prompt_tokens, got.response_tokens, got.truncated, got.text) == (
        want.prompt_tokens, want.response_tokens, want.truncated, want.text)
    assert (streamed[-1] if streamed else []) == got.generated_tokens
    if use_cache:
        assert {"vision.prepare_inputs", "decode.prefill", "decode.generate"} <= set(port.decode_stages)


def test_engine_decode_truncates_like_the_reference(monkeypatch):
    """A budget of 136 positions leaves 8 after the 128-position prompt
    bucket: 12 requested tokens are cut to 8 and the outcome says so."""
    ref, port = _engines("f32", None)
    monkeypatch.setattr(ref, "max_seq_len", 136)
    monkeypatch.setattr(port, "max_seq_len", 136)
    want = ref.decode(_Tok(), "<image>q", [_image()], JaxVision(64, 64, False),
                      JaxParams(max_new_tokens=12, no_repeat_ngram_size=None))
    got = port.decode(_Tok(), "<image>q", [_image()], VisionSettings(64, 64, False),
                      DecodeParameters(max_new_tokens=12, no_repeat_ngram_size=None))
    assert want.truncated and got.truncated
    assert got.generated_tokens == want.generated_tokens
