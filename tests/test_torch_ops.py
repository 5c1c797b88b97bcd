"""The port's ops against dsocr_tpu.ops on the same numpy inputs:
norms, RoPE with the MLA regroup, attention, the int8 KV quantizer
(bit-exact), the MoE router, the three fused expert tiers and greedy
(plus top-k) token selection.
Tolerance: atol = 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu import ops as J
from dsocr_tpu.ops import moe as jmoe
from dsocr_tpu_torch import ops as T

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rng(seed):
    return np.random.default_rng(seed)


def test_norms_match():
    rng = _rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3
    w = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        T.rms_norm(_t(x), _t(w)).numpy(), np.asarray(J.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL
    )
    np.testing.assert_allclose(
        T.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(J.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), **TOL,
    )


@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_tables_and_mla_regroup(interleaved):
    cos_j, sin_j = J.build_rope_tables(64, 8, 10000.0)
    cos_t, sin_t = T.build_rope_tables(64, 8, 10000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)
    x = _rng(1).normal(size=(2, 3, 64, 8)).astype(np.float32)
    want = J.apply_rope(jnp.asarray(x), cos_j, sin_j, interleaved=interleaved)
    got = T.apply_rope(_t(x), cos_t, sin_t, interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_partial_rope_matches_decoder():
    from dsocr_tpu.models.deepseek.decoder import _partial_rope

    cos_j, sin_j = J.build_rope_tables(32, 4)
    cos_t, sin_t = T.build_rope_tables(32, 4)
    pos = _rng(2).integers(0, 32, size=(2, 5))
    x = _rng(3).normal(size=(2, 3, 5, 8)).astype(np.float32)
    want = _partial_rope(jnp.asarray(x), cos_j[pos][:, None], sin_j[pos][:, None], 4, True)
    got = T.partial_rope(_t(x), cos_t[_t(pos)][:, None], sin_t[_t(pos)][:, None], 4, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantize_kv_int8_bit_exact():
    rng = _rng(4)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # amax 0 → safe scale 1.0
    x[0, 1, 2, :2] = [127.0 * 0.5 / 127.0, -1.0]  # exact .5 ties after scaling
    x[1, 2, 3] = np.linspace(-2.5, 2.5, 16)
    codes_j, scale_j = J.quantize_kv_int8(jnp.asarray(x))
    codes_t, scale_t = T.quantize_kv_int8(_t(x))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))
    for dtype in (torch.bfloat16,):
        xb = _t(x).to(dtype)
        cj, sj = J.quantize_kv_int8(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
        ct, st = T.quantize_kv_int8(xb)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_attention_and_int8_attention_match():
    rng = _rng(5)
    q = rng.normal(size=(2, 4, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)
    mask = np.asarray(J.causal_mask(3, 6, 3))[None, None]
    np.testing.assert_allclose(
        T.attention(_t(q), _t(k), _t(v), _t(mask)).numpy(),
        np.asarray(J.attention(*map(jnp.asarray, (q, k, v, mask)))), **TOL,
    )
    kc, ks = J.quantize_kv_int8(jnp.asarray(k))
    vc, vs = J.quantize_kv_int8(jnp.asarray(v))
    slot_mask = (np.arange(6)[None, None, None, :] <= np.array([2, 5])[:, None, None, None])
    want = J.attention_kv_int8(jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(slot_mask))
    got = T.attention_kv_int8(_t(q), _t(kc), _t(ks), _t(vc), _t(vs), _t(slot_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scoring,norm", [("softmax", False), ("sigmoid", True)])
def test_moe_router_matches(scoring, norm):
    rng = _rng(6)
    tokens = rng.normal(size=(9, 32)).astype(np.float32)
    gate = rng.normal(size=(8, 32)).astype(np.float32) * 32 ** -0.5
    cfg_j = jmoe.MoeConfig(8, 3, scoring, norm, 1.5)
    cfg_t = T.MoeConfig(8, 3, scoring, norm, 1.5)
    wj, ij = jmoe.moe_router(jnp.asarray(tokens), jnp.asarray(gate), cfg_j)
    wt, it = T.moe_router(_t(tokens), _t(gate), cfg_t)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)


@pytest.mark.parametrize("n", [1, 7, 32, 45])  # unrolled, dense, dense edge, grouped
def test_moe_fused_tiers_match(n):
    rng = _rng(10 + n)
    E, H, I, K = 6, 16, 8, 2
    tokens = rng.normal(size=(n, H)).astype(np.float32)
    gateup = rng.normal(size=(E, H, 2 * I)).astype(np.float32) * H ** -0.5
    down = rng.normal(size=(E, I, H)).astype(np.float32) * I ** -0.5
    gate = rng.normal(size=(E, H)).astype(np.float32)
    cfg = jmoe.MoeConfig(E, K)
    w, idx = jmoe.moe_router(jnp.asarray(tokens), jnp.asarray(gate), cfg)
    want = jmoe.moe_apply_fused(jnp.asarray(tokens), w, idx, jnp.asarray(gateup), jnp.asarray(down))
    got = T.moe_apply_fused(_t(tokens), _t(w), _t(idx).long(), _t(gateup), _t(down))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slot_kv_write_attend_matches_reference():
    """One slot decode step on an int8 and a model-dtype cache: same new
    cache contents and attention as the reference's helper."""
    from dsocr_tpu.ops.attention import slot_kv_write_attend as jax_write_attend

    rng = _rng(20)
    L, B, NKV, S, D = 2, 3, 2, 16, 8
    q = rng.normal(size=(B, 4, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, NKV, 1, D)).astype(np.float32)
    v = rng.normal(size=(B, NKV, 1, D)).astype(np.float32)
    lengths = np.array([0, 7, 15], np.int32)
    mask = np.arange(S)[None, None, None, :] <= lengths[:, None, None, None]
    for quant in (False, True):
        if quant:
            k_all = rng.integers(-127, 128, size=(L, B, NKV, S, D)).astype(np.int8)
            ks = rng.uniform(0.01, 0.1, size=(L, B, NKV, S)).astype(np.float32)
        else:
            k_all = rng.normal(size=(L, B, NKV, S, D)).astype(np.float32)
            ks = None
        v_all, vs = k_all.copy(), None if ks is None else ks.copy()
        want = jax_write_attend(
            *map(jnp.asarray, (q, k, v, k_all, v_all)),
            None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
            jnp.int32(1), jnp.asarray(lengths), jnp.asarray(mask), D ** -0.5,
        )
        caches = [None if c is None else _t(c).clone() for c in (k_all, v_all, ks, vs)]
        got = T.slot_kv_write_attend(_t(q), _t(k), _t(v), *caches, 1, _t(lengths), D ** -0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), **TOL)
        for c, w in zip(caches, want[1:]):
            if c is not None:
                np.testing.assert_array_equal(c.numpy(), np.asarray(w))


def test_select_token_id_slots_greedy_matches():
    """Per-row repetition penalty and no-repeat-ngram ban, greedy: the
    same token ids as the reference's device selection (and its host spec)."""
    from dsocr_tpu.core.sampling import SlotSamplingParams as JaxSampling
    from dsocr_tpu.core.sampling import select_token_id_host
    from dsocr_tpu.core.sampling import select_token_id_slots as jax_select
    from dsocr_tpu_torch.core.sampling import SlotSamplingParams, select_token_id_slots

    rng = _rng(30)
    B, V, L = 4, 50, 24
    context = rng.integers(0, 6, size=(B, L)).astype(np.int32)  # many repeats
    ctx_len = np.array([0, 5, 17, 24], np.int32)
    logits = rng.normal(size=(B, V)).astype(np.float32)
    logits[:, :6] += 2.0  # make the banned/penalized tokens the likely winners
    pen = np.array([1.0, 1.3, 0.7, 1.1], np.float32)
    ngram = np.array([0, 2, 3, 4], np.int32)
    zeros = np.zeros(B, np.float32)
    want = jax_select(
        jnp.asarray(logits), jnp.asarray(context), jnp.asarray(ctx_len),
        JaxSampling(jnp.asarray(zeros), jnp.ones(B), jnp.zeros(B, jnp.int32), jnp.asarray(pen),
                    jnp.zeros(B, bool), jnp.asarray(ngram)),
        ngram_max=5, rng_key=jax.random.PRNGKey(0),
    )
    sampling = SlotSamplingParams(
        _t(zeros), torch.ones(B), torch.zeros(B, dtype=torch.int64), _t(pen),
        torch.zeros(B, dtype=torch.bool), _t(ngram).long(),
    )
    got = select_token_id_slots(_t(logits), _t(context).long(), _t(ctx_len).long(), sampling,
                                ngram_max=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    class P:
        do_sample, temperature, top_p, top_k = False, 0.0, None, None

    for r in range(B):
        p = P()
        p.repetition_penalty, p.no_repeat_ngram_size = float(pen[r]), int(ngram[r]) or None
        assert int(got[r]) == select_token_id_host(logits[r], p, list(context[r, : ctx_len[r]]))


def test_sampled_rows_respect_top_k_and_greedy_rows_stay_greedy():
    from dsocr_tpu_torch.core.sampling import SlotSamplingParams, select_token_id_slots

    B, V = 3, 40
    logits = torch.from_numpy(_rng(31).normal(size=(B, V)).astype(np.float32))
    top3 = logits.topk(3, dim=-1).indices
    sampling = SlotSamplingParams(
        temperature=torch.tensor([1.0, 1.0, 0.0]), top_p=torch.tensor([1.0, 0.5, 1.0]),
        top_k=torch.tensor([3, 0, 0]), repetition_penalty=torch.ones(B),
        do_sample=torch.tensor([True, True, False]), ngram=torch.zeros(B, dtype=torch.int64),
    )
    gen = torch.Generator().manual_seed(0)
    context = torch.zeros((B, 4), dtype=torch.int64)
    lens = torch.zeros(B, dtype=torch.int64)
    for _ in range(20):
        tok = select_token_id_slots(logits, context, lens, sampling, ngram_max=4,
                                    generator=gen, any_sample=True)
        assert int(tok[0]) in top3[0].tolist()
        assert int(tok[2]) == int(logits[2].argmax())
