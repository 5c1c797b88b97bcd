"""The port's kernel twins (ops/kernels/*_plain) against the reference's
Pallas kernels in interpret mode and its plain XLA oracles. The CUDA
kernels against these twins: tests/test_torch_cuda.py.

Inputs come from numpy.random.default_rng and feed both packages.
Tolerance: f32 atol = rtol = 1e-5; slot_kv_update is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.ops import attention as jax_attention
from dsocr_tpu.ops import attention_kv_int8 as jax_attention_kv_int8
from dsocr_tpu.ops import causal_mask as jax_causal_mask
from dsocr_tpu.ops.pallas.prefill_attention import flash_prefill_attention as jax_prefill
from dsocr_tpu.ops.pallas.sam_attention import sam_flash_attention as jax_sam
from dsocr_tpu.ops.pallas.slot_attention import slot_decode_attention as jax_slot_decode
from dsocr_tpu.ops.pallas.slot_attention import slot_kv_update as jax_slot_update
from dsocr_tpu_torch.ops import kernels as K

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- sam_flash_attention ----------------------------------------------------


def _sam_case(seed, BH, qh, qw, D=8):
    rng = np.random.default_rng(seed)
    S = qh * qw
    q = rng.normal(size=(BH, S, D)).astype(np.float32) * 0.3
    k = rng.normal(size=(BH, S, D)).astype(np.float32) * 0.3
    v = rng.normal(size=(BH, S, D)).astype(np.float32)
    bh = rng.normal(size=(BH, S, qh)).astype(np.float32) * 0.2
    bw = rng.normal(size=(BH, S, qw)).astype(np.float32) * 0.2
    return q, k, v, bh, bw


@pytest.mark.parametrize("qh,qw", [(4, 6), (5, 5), (8, 8)])
def test_sam_twin_matches_pallas(qh, qw):
    args = _sam_case(qh * 31 + qw, 3, qh, qw)
    want = np.asarray(jax_sam(*map(jnp.asarray, args), width=qw, block_q=16, interpret=True))
    got = K.sam_flash_attention(*map(_t, args), width=qw)  # CPU → twin
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- flash_prefill_attention --------------------------------------------------


def _prefill_case(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32) * 0.4
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32) * 0.4
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,Hkv,S,D,pads", [
    (2, 4, 4, 32, 16, [0, 0]),
    (1, 4, 2, 24, 8, [0]),  # GQA, uneven final block
    (3, 2, 2, 32, 8, [0, 5, 17]),  # left-padded rows (fully masked queries)
])
def test_prefill_twin_matches_pallas_and_oracle(B, H, Hkv, S, D, pads):
    q, k, v = _prefill_case(B * 131 + S, B, H, Hkv, S, D)
    pad = np.asarray(pads, np.int32)
    scale = D ** -0.5
    got = K.flash_prefill_attention(_t(q), _t(k), _t(v), _t(pad), scale=scale).numpy()
    pallas = np.asarray(jax_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
        scale=scale, block_q=16, interpret=True,
    ))
    mask = np.asarray(jax_causal_mask(S, S, 0))[None, None] & (
        np.arange(S)[None, None, None, :] >= pad[:, None, None, None]
    )
    oracle = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale
    ))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    if pads[-1] > 0:
        # a fully masked query row is the uniform mean of v over all keys
        h_kv = np.arange(H) // (H // Hkv)
        mean_v = v[-1].mean(axis=1)[h_kv]  # [H, D]
        np.testing.assert_allclose(got[-1, 0].reshape(H, D), mean_v, **TOL)


@pytest.mark.parametrize("B,H,Hkv,S,D,pads", [
    (3, 2, 1, 130, 8, [63, 64, 65]),  # pads at the CUDA kernel's 64-wide tile boundaries
    (2, 2, 2, 1, 8, [0, 1]),  # one position: one live key, or none (the mean of v)
])
def test_prefill_twin_at_tile_edges_matches_pallas_and_oracle(B, H, Hkv, S, D, pads):
    """The edges of the CUDA kernel's schedule (key tiles from the pad's
    tile on, full walks for tiles that hold fully masked rows, a ragged
    last tile), pinned on the function both implement."""
    q, k, v = _prefill_case(B * 17 + S, B, H, Hkv, S, D)
    pad = np.asarray(pads, np.int32)
    scale = D ** -0.5
    got = K.flash_prefill_attention(_t(q), _t(k), _t(v), _t(pad), scale=scale).numpy()
    pallas = np.asarray(jax_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
        scale=scale, block_q=16, interpret=True,
    ))
    mask = np.asarray(jax_causal_mask(S, S, 0))[None, None] & (
        np.arange(S)[None, None, None, :] >= pad[:, None, None, None]
    )
    oracle = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale
    ))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


# -- slot caches ------------------------------------------------------------------


def _bf16(x):
    """f32 values rounded to bf16 and back (both frameworks round to nearest
    even), so one array can feed a bf16 cache on either side."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _slot_case(seed, B, NH, NKV, S, D, kind, L=3):
    """kind: "f32", "bf16" (f32 arrays holding bf16 values) or "int8"."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, NH, 1, D)).astype(np.float32)
    if kind == "int8":
        k_all = rng.integers(-127, 128, size=(L, B, NKV, S, D)).astype(np.int8)
        v_all = rng.integers(-127, 128, size=(L, B, NKV, S, D)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, size=(L, B, NKV, S)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, size=(L, B, NKV, S)).astype(np.float32)
    else:
        k_all = rng.normal(size=(L, B, NKV, S, D)).astype(np.float32)
        v_all = rng.normal(size=(L, B, NKV, S, D)).astype(np.float32)
        if kind == "bf16":
            k_all, v_all = _bf16(k_all), _bf16(v_all)
        ks = vs = None
    lengths = rng.integers(0, S, size=(B,)).astype(np.int32)
    lengths[0], lengths[-1] = 0, S - 1
    return q, k_all, v_all, ks, vs, lengths


def _opt(fn, x):
    return None if x is None else fn(x)


def _cache_t(x, kind):
    return _t(x).to(torch.bfloat16) if kind == "bf16" else _t(x)


def _cache_j(x, kind):
    return jnp.asarray(x, jnp.bfloat16) if kind == "bf16" else jnp.asarray(x)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("B,NH,NKV,S,D", [(4, 4, 4, 256, 32), (3, 8, 2, 128, 16)])
def test_slot_decode_twin_matches_pallas_and_oracle(kind, B, NH, NKV, S, D):
    quant = kind == "int8"
    q, k_all, v_all, ks, vs, lengths = _slot_case(7 + B, B, NH, NKV, S, D, kind)
    scale = D ** -0.5
    for layer in (0, 2):
        got = K.slot_decode_attention(
            _t(q), _cache_t(k_all, kind), _cache_t(v_all, kind), _opt(_t, ks), _opt(_t, vs),
            layer, _t(lengths), scale=scale,
        ).numpy()
        pallas = np.asarray(jax_slot_decode(
            jnp.asarray(q), _cache_j(k_all, kind), _cache_j(v_all, kind), _opt(jnp.asarray, ks),
            _opt(jnp.asarray, vs), jnp.int32(layer), jnp.asarray(lengths),
            scale=scale, interpret=True,
        ))
        mask = jnp.asarray(np.arange(S)[None, None, None, :] <= lengths[:, None, None, None])
        if quant:
            oracle = jax_attention_kv_int8(
                jnp.asarray(q), jnp.asarray(k_all[layer]), jnp.asarray(ks[layer]),
                jnp.asarray(v_all[layer]), jnp.asarray(vs[layer]), mask, scale,
            )
        else:
            oracle = jax_attention(
                jnp.asarray(q), jnp.asarray(k_all[layer]), jnp.asarray(v_all[layer]), mask, scale
            )
        np.testing.assert_allclose(got, pallas, **TOL)
        np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_slot_decode_twin_at_split_edges_matches_pallas_and_oracle(kind):
    """Rows that attend up to either side of a 256-position split boundary
    of the CUDA attend (lengths 255, 256, 257: 256, 257, 258 positions),
    a row of one position, and GQA."""
    B, NH, NKV, S, D = 5, 4, 2, 300, 16
    q, k_all, v_all, ks, vs, _ = _slot_case(21, B, NH, NKV, S, D, kind, L=2)
    lengths = np.asarray([255, 256, 257, 0, S - 1], np.int32)
    scale = D ** -0.5
    got = K.slot_decode_attention(
        _t(q), _cache_t(k_all, kind), _cache_t(v_all, kind), _opt(_t, ks), _opt(_t, vs),
        1, _t(lengths), scale=scale,
    ).numpy()
    pallas = np.asarray(jax_slot_decode(
        jnp.asarray(q), _cache_j(k_all, kind), _cache_j(v_all, kind), _opt(jnp.asarray, ks),
        _opt(jnp.asarray, vs), jnp.int32(1), jnp.asarray(lengths), scale=scale, interpret=True,
    ))
    mask = jnp.asarray(np.arange(S)[None, None, None, :] <= lengths[:, None, None, None])
    if kind == "int8":
        oracle = jax_attention_kv_int8(
            jnp.asarray(q), jnp.asarray(k_all[1]), jnp.asarray(ks[1]), jnp.asarray(v_all[1]),
            jnp.asarray(vs[1]), mask, scale,
        )
    else:
        oracle = jax_attention(jnp.asarray(q), jnp.asarray(k_all[1]), jnp.asarray(v_all[1]), mask, scale)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_slot_kv_update_twin_bit_exact_with_pallas(kind):
    B, NKV, S, D = 4, 2, 256, 16
    quant = kind == "int8"
    _, k_all, v_all, ks, vs, lengths = _slot_case(11, B, 2, NKV, S, D, kind)
    rng = np.random.default_rng(12)
    if quant:
        k_new = rng.integers(-127, 128, size=(B, NKV, D)).astype(np.int8)
        v_new = rng.integers(-127, 128, size=(B, NKV, D)).astype(np.int8)
        ks_new = rng.uniform(0.01, 0.1, size=(B, NKV)).astype(np.float32)
        vs_new = rng.uniform(0.01, 0.1, size=(B, NKV)).astype(np.float32)
    else:
        k_new = _bf16(rng.normal(size=(B, NKV, D)))
        v_new = _bf16(rng.normal(size=(B, NKV, D)))
        ks_new = vs_new = None
    layer = 1
    want = jax_slot_update(
        _cache_j(k_all, kind), _cache_j(v_all, kind), _opt(jnp.asarray, ks), _opt(jnp.asarray, vs),
        _cache_j(k_new, kind), _cache_j(v_new, kind), _opt(jnp.asarray, ks_new),
        _opt(jnp.asarray, vs_new), jnp.int32(layer), jnp.asarray(lengths), interpret=True,
    )
    caches = [_cache_t(k_all, kind), _cache_t(v_all, kind), _opt(_t, ks), _opt(_t, vs)]
    K.slot_kv_update(*caches, _cache_t(k_new, kind), _cache_t(v_new, kind), _opt(_t, ks_new),
                     _opt(_t, vs_new), layer, _t(lengths))  # in place
    for got, ref in zip(caches, want):
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref).astype(np.float32))


def test_slot_kv_update_drops_rows_past_the_end():
    """lengths >= S write nothing (the reference scatter's drop mode)."""
    L, B, NKV, S, D = 2, 3, 2, 8, 4
    k_all = torch.zeros((L, B, NKV, S, D))
    v_all = torch.zeros((L, B, NKV, S, D))
    new = torch.ones((B, NKV, D))
    lengths = torch.tensor([S - 1, S, 3], dtype=torch.int32)
    K.slot_kv_update(k_all, v_all, None, None, new, new, None, None, 1, lengths)
    want = jnp.zeros((L, B, NKV, S, D)).at[1, jnp.arange(B), :, jnp.asarray(lengths.numpy()), :].set(
        jnp.ones((B, NKV, D))
    )
    np.testing.assert_array_equal(k_all.numpy(), np.asarray(want))
    assert k_all[1, 1].sum() == 0


def test_launch_counter_is_thread_safe():
    """The prefill and decode workers count launches from two threads."""
    import sys
    import threading

    from dsocr_tpu_torch.ops.kernels import _lib

    def fake_wrapper():
        pass

    fake_wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [_lib.count_launch(fake_wrapper) for _ in range(2000)])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fake_wrapper.launches == 16 * 2000
