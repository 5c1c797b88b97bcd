"""Paged KV serving and the megafused Q8_0 expert chain of the port against
the reference, on the CPU, with inputs from numpy.random.default_rng fed
to both packages (the reference's Pallas kernels in interpret mode):

- the page allocator's semantics (tests/test_paged_slots.py's);
- the paged KV write's twin bit-exact with the reference's
  paged_kv_update (codes and scales), and silent for a row whose position
  falls on no page;
- the paged attend's twin against the reference's paged_decode_attention
  for MHA, GQA, int8 and bf16 pools at 1e-5 (a bf16 pool's values convert
  to f32 exactly, so both sides run the same f32 arithmetic and differ
  only in summation order, as for f32), and deaf to what unused pages and
  positions past a row's length hold, NaN included;
- the megafused chain's twin against q8_moe_megafused_layered at the
  reference's own test shapes (E 4, H 768, MI 256, N 16, top-3 with a
  duplicate expert) at rtol = atol = 2e-5, and moe_apply_quant_fused with
  DSOCR_Q8_MEGAFUSED=1 against the switch off and against the reference's;
- greedy tokens of the port's DSOCR_PAGED_KV=1 serving equal the
  reference's paged serving (on params_from_jax weights) and the port's
  contiguous serving: 3 requests through 2 slots with f32 and int8 KV, a
  pool of 3 pages and one of 1 page (requests wait for pages), and Q8_0 at
  4 slots with DSOCR_Q8_MEGAFUSED=1 on both sides;
- a paged join_many that finds too few pages leaves the state and the
  free list as they were, and an idle row's decode step writes into no
  page (the reference writes through a released row's stale table).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.ops import moe as jax_moe
from dsocr_tpu.ops.pallas import dequant_matmul as jax_dq
from dsocr_tpu.ops.pallas import paged_attention as jax_pa
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.ops import kernels as K
from dsocr_tpu_torch.ops.linear import PackedQ8
from dsocr_tpu_torch.ops.moe import moe_apply_quant_fused
from dsocr_tpu_torch.runtime.paged import NO_PAGE, PageAllocator
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

BUDGETS = [3, 10, 10]  # the first row finishes early; the third joins mid-flight


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the test processes from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the allocator ------------------------------------------------------------------


def test_allocator_alloc_release_share():
    a = PageAllocator(8)
    p1 = a.alloc(3)
    p2 = a.alloc(2)
    assert p1 == [0, 1, 2] and p2 == [3, 4]  # LIFO from page 0, as the reference's
    assert len(set(p1) | set(p2)) == 5 and a.free_count == 3
    with pytest.raises(MemoryError):
        a.alloc(4)
    assert a.free_count == 3  # a refused alloc takes nothing
    a.share(p1)  # refcount 2
    a.release(p1)
    assert a.free_count == 3  # still mapped once
    a.release(p1)
    assert a.free_count == 6
    a.release(p2)
    assert a.free_count == 8
    assert a.alloc(1) == [4]  # the page released last comes back first


# -- the paged KV write ---------------------------------------------------------------


def _pools(rng, kind, L, P, NKV, page, D, B):
    if kind == "int8":
        codes = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
        scales = lambda *s: rng.uniform(0.01, 0.1, s).astype(np.float32)  # noqa: E731
        return (codes(L, P, NKV, page, D), codes(L, P, NKV, page, D), scales(L, P, NKV, page),
                scales(L, P, NKV, page), codes(B, NKV, D), codes(B, NKV, D), scales(B, NKV),
                scales(B, NKV))
    normal = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (normal(L, P, NKV, page, D), normal(L, P, NKV, page, D), None, None,
            normal(B, NKV, D), normal(B, NKV, D), None, None)


def _jax_pool(x, kind):
    return None if x is None else jnp.asarray(x, jnp.bfloat16 if kind == "bf16" and x.dtype == np.float32 else x.dtype)


def _torch_pool(x, kind):
    return None if x is None else (_t(x).to(torch.bfloat16) if kind == "bf16" else _t(x))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_paged_kv_update_twin_bit_exact_with_reference(kind):
    rng = np.random.default_rng(5)
    L, P, NKV, page, D, B, P_max = 3, 12, 2, 16, 64, 4, 3
    arrays = _pools(rng, kind, L, P, NKV, page, D, B)
    tables = rng.permutation(P)[: B * P_max].reshape(B, P_max).astype(np.int32)
    lengths = rng.integers(0, page * P_max, (B,)).astype(np.int32)
    lengths[0] = page * P_max - 1  # the last slot of the last page
    want = jax_pa.paged_kv_update(*(_jax_pool(x, kind) for x in arrays), jnp.asarray(tables),
                                  jnp.asarray(lengths), jnp.asarray(2, jnp.int32), interpret=True)
    got = [_torch_pool(x, kind) for x in arrays]
    K.paged_kv_update(*got, _t(tables), _t(lengths), 2)
    for g, w in zip(got[:4], want):
        if g is None:
            assert w is None
        else:
            np.testing.assert_array_equal(g.float().numpy() if kind == "bf16" else g.numpy(), _np(w))


def test_paged_kv_update_skips_rows_without_a_page():
    """Released rows (NO_PAGE), a row one past its last page and a row past
    the table's capacity write nothing; the others write as usual."""
    rng = np.random.default_rng(6)
    L, P, NKV, page, D, B, P_max = 2, 8, 2, 4, 8, 4, 2
    arrays = [_torch_pool(x, "int8") for x in _pools(rng, "int8", L, P, NKV, page, D, B)]
    tables = torch.tensor([[3, 5], [NO_PAGE, NO_PAGE], [6, NO_PAGE], [0, 1]], dtype=torch.int32)
    lengths = torch.tensor([5, 0, page, page * P_max], dtype=torch.int32)
    before = [x.clone() for x in arrays[:4]]
    K.paged_kv_update(*arrays, tables, lengths, 1)
    for pool, old in zip(arrays[:4], before):
        changed = (pool != old).reshape(L, P, NKV, page, -1).any(-1).any(2).nonzero().tolist()
        assert sorted({(li, p, off) for li, p, off in changed}) == [(1, 5, 1)]


# -- the paged attend ------------------------------------------------------------------


def _attend_inputs(seed, kind, B=3, H=4, H_kv=4, D=16, L=2, P=16, page=8, P_max=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 128, (L, P, H_kv, page, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, P, H_kv, page, D)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (L, P, H_kv, page)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (L, P, H_kv, page)).astype(np.float32)
    else:
        k = rng.normal(size=(L, P, H_kv, page, D)).astype(np.float32)
        v = rng.normal(size=(L, P, H_kv, page, D)).astype(np.float32)
        ks = vs = None
    tables = rng.permutation(P)[: B * P_max].reshape(B, P_max).astype(np.int32)
    return q, k, v, ks, vs, tables


@pytest.mark.parametrize("kind,H,H_kv,lengths", [
    ("f32", 4, 4, [0, 7, 8]),
    ("f32", 4, 4, [15, 22, 31]),
    ("f32", 8, 2, [5, 12, 30]),  # GQA
    ("bf16", 8, 2, [0, 13, 31]),
    ("int8", 4, 2, [0, 13, 31]),
])
def test_paged_attend_twin_matches_reference(kind, H, H_kv, lengths):
    q, k, v, ks, vs, tables = _attend_inputs(len(lengths) + H, kind, H=H, H_kv=H_kv)
    lens = np.asarray(lengths, np.int32)
    for layer in (0, 1):
        want = jax_pa.paged_decode_attention(
            jnp.asarray(q), _jax_pool(k, kind), _jax_pool(v, kind), jnp.asarray(tables),
            jnp.asarray(lens), jnp.int32(layer), scale=0.25,
            ks_pool=None if ks is None else jnp.asarray(ks),
            vs_pool=None if vs is None else jnp.asarray(vs), interpret=True)
        got = K.paged_decode_attention(_t(q), _torch_pool(k, kind), _torch_pool(v, kind),
                                       None if ks is None else _t(ks), None if vs is None else _t(vs),
                                       _t(tables), _t(lens), layer, scale=0.25)
        assert got.dtype == torch.float32 and got.shape == (3, H * 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_attend_ignores_unused_page_contents(kind):
    """NaN in every page a row does not attend, and past its length inside
    its last page, changes nothing (the reference's test poisons with 1e4;
    the twin holds with NaN, as the kernel does)."""
    q, k, v, ks, vs, tables = _attend_inputs(2, kind)
    lens = np.asarray([9, 9, 3], np.int32)  # 2, 2 and 1 of 4 table pages
    args = lambda k_, v_, ks_, vs_: (  # noqa: E731
        _t(q), _t(k_), _t(v_), None if ks_ is None else _t(ks_), None if vs_ is None else _t(vs_),
        _t(tables), _t(lens), 0)
    base = K.paged_decode_attention(*args(k, v, ks, vs), scale=0.25)
    page = k.shape[3]
    poison_k, poison_v = k.astype(np.float32), v.astype(np.float32)
    poison_ks, poison_vs = (None, None) if ks is None else (ks.copy(), vs.copy())
    planes = [a for a in (poison_k, poison_v, poison_ks, poison_vs) if a is not None]
    for p in set(range(k.shape[1])) - set(tables.ravel().tolist()):
        for arr in planes:
            arr[0, p] = np.nan
    for b, n in enumerate(lens):
        for j, p in enumerate(tables[b]):
            lo = max(0, n + 1 - j * page)  # first unused offset of this page
            for arr in planes:
                arr[0, p, :, lo:] = np.nan
    if kind == "int8":  # int8 codes hold no NaN: poison the scales and extreme codes
        poison_k = np.where(np.isnan(poison_k), 127, k).astype(np.int8)
        poison_v = np.where(np.isnan(poison_v), -127, v).astype(np.int8)
    got = K.paged_decode_attention(*args(poison_k, poison_v, poison_ks, poison_vs), scale=0.25)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    if kind == "f32":  # the reference's own poison, both packages
        hot = np.where(np.isnan(poison_k), 1e4, k).astype(np.float32)
        want = jax_pa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(hot), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(lens),
            jnp.int32(0), scale=0.25, interpret=True)
        got = K.paged_decode_attention(*args(hot, v, None, None), scale=0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paged_attend_row_without_pages_gives_zeros():
    q, k, v, _, _, tables = _attend_inputs(3, "f32")
    tables[1] = NO_PAGE
    lens = np.asarray([4, 0, 9], np.int32)
    out = K.paged_decode_attention(_t(q), _t(k), _t(v), None, None, _t(tables), _t(lens), 0,
                                   scale=0.25)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isfinite(out).all() and out[0].abs().sum() > 0


# -- the megafused Q8_0 expert chain ------------------------------------------------------


def _megafused_inputs():
    """tests/test_dequant_matmul.py's megafused case: two layers of E 4
    experts, H 768, MI 256; 16 tokens at top-3, row 0 choosing expert 1
    twice."""
    rng = np.random.default_rng(23)
    L, E, H, MI, N, topk = 2, 4, 768, 256, 16, 3
    gu = jax_sq.quantize_expert_stack(rng.normal(size=(L, E, H, 2 * MI)).astype(np.float32) * 0.3)
    dn = jax_sq.quantize_expert_stack(rng.normal(size=(L, E, MI, H)).astype(np.float32) * 0.3)
    x = rng.normal(size=(N, H)).astype(np.float32) * 0.3
    tw = rng.random((N, topk)).astype(np.float32)
    ti = rng.integers(0, E, (N, topk)).astype(np.int32)
    ti[0, :2] = 1
    w_dense = np.zeros((E, N), np.float32)
    np.add.at(w_dense, (ti.reshape(-1), np.repeat(np.arange(N), topk)), tw.reshape(-1))
    return x, tw, ti, w_dense, gu, dn


def _assert_megafused_close(got, want, x, w_dense, gu, dn, layer):
    """rtol = atol = 2e-5 plus chip_smoke.megafused_tol: both packages sum
    gate+up in f32 in their own order and compute silu their own way, and
    where that moves an inter element across a bf16 rounding boundary the
    element differs by one bf16 ulp (1.7 % of these outputs moved by up to
    6.6e-4 without it)."""
    import chip_smoke

    tol = chip_smoke.megafused_tol(torch, _t(x), _t(w_dense), _t(gu["codes"][layer]),
                                   _t(gu["scales"][layer]), _t(dn["codes"][layer]),
                                   _t(dn["scales"][layer])).numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert (np.abs(got - want) <= 2e-5 + 2e-5 * np.abs(want) + tol).all()


def test_q8_megafused_twin_matches_reference():
    x, _, _, w_dense, gu, dn = _megafused_inputs()
    for layer in (0, 1):
        want = jax_dq.q8_moe_megafused_layered(
            jnp.asarray(x), jnp.asarray(w_dense), jnp.asarray(gu["codes"]), jnp.asarray(gu["scales"]),
            jnp.asarray(dn["codes"]), jnp.asarray(dn["scales"]), jnp.asarray(layer, jnp.int32),
            interpret=True)
        got = K.q8_moe_megafused(_t(x), _t(w_dense), _t(gu["codes"][layer]), _t(gu["scales"][layer]),
                                 _t(dn["codes"][layer]), _t(dn["scales"][layer]))
        assert got.dtype == torch.float32 and got.shape == x.shape
        _assert_megafused_close(got, want, x, w_dense, gu, dn, layer)


def test_megafused_switch_matches_the_sweep_and_the_reference(monkeypatch):
    """moe_apply_quant_fused's dense tier with DSOCR_Q8_MEGAFUSED=1 runs the
    megafused twin once and matches the two-kernel sweep (switch off) and
    the reference's moe_apply_q8_dense_fused with the switch on."""
    import dsocr_tpu_torch.ops.moe as port_moe

    x, tw, ti, w_dense, gu, dn = _megafused_inputs()
    layer = 1
    holders = [PackedQ8(_t(p["codes"][layer]), _t(p["scales"][layer]), in_major=True) for p in (gu, dn)]
    ran = []
    orig = port_moe.q8_moe_megafused
    monkeypatch.setattr(port_moe, "q8_moe_megafused", lambda *a: ran.append(1) or orig(*a))
    outs = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("DSOCR_Q8_MEGAFUSED", switch)
        outs[switch] = moe_apply_quant_fused(_t(x), _t(tw), _t(ti).long(), *holders).numpy()
        assert len(ran) == int(switch)
    np.testing.assert_allclose(outs["1"], outs["0"], rtol=2e-5, atol=2e-5)
    want = jax_moe.moe_apply_q8_dense_fused(
        jnp.asarray(x), jnp.asarray(tw), jnp.asarray(ti),
        *(jax_moe.LayeredQ8(jnp.asarray(p["codes"]), jnp.asarray(p["scales"]), jnp.int32(layer))
          for p in (gu, dn)))
    _assert_megafused_close(outs["1"], want, x, w_dense, gu, dn, layer)


# -- serving ------------------------------------------------------------------------------


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


def _q8_cfg(cfg):
    lang = dataclasses.replace(cfg.language, moe_intermediate_size=32, intermediate_size=64)
    return dataclasses.replace(cfg, language=lang)


@pytest.fixture(scope="module")
def jax_engines():
    """(quantize, kv_quant) → the reference's engine, built on first use;
    the Q8_0 engines quantized from one float engine."""
    engines = {}

    def get(quantize, kv_quant):
        if (quantize, kv_quant) not in engines:
            if quantize is None:
                engines[None, kv_quant] = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512,
                                                    kv_quant=kv_quant)
            else:
                if "float_q8" not in engines:
                    engines["float_q8"] = JaxEngine(_q8_cfg(jax_tiny()), dtype=jnp.float32,
                                                    max_seq_len=512)
                engines[quantize, kv_quant] = JaxEngine(
                    _q8_cfg(jax_tiny()),
                    params=jax.tree_util.tree_map(lambda x: x, engines["float_q8"].params),
                    dtype=jnp.float32, max_seq_len=512, kv_quant=kv_quant, quantize=quantize)
        return engines[quantize, kv_quant]

    return get


def _port(jax_engine, quantize, kv_quant):
    state = params_from_jax(jax.device_get(jax_engine.params))
    cfg = tiny_deepseek_config() if quantize is None else _q8_cfg(tiny_deepseek_config())
    return DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512,
                             kv_quant=kv_quant, state=state, quantize=quantize)


@pytest.mark.parametrize("quantize,kv_quant,n_slots,pool,vs_reference", [
    (None, None, 2, None, True),
    (None, "int8", 2, None, True),
    (None, None, 2, "3", True),  # under the worst case of 2 slots × 2 pages
    (None, None, 2, "1", True),  # one row at a time: joins wait for pages
    # Here the reference's idle row 1, whose table of zeros names the page
    # row 0 owns, writes token 0's K/V over row 0's position 0 each step;
    # with int8 KV that changes row 0's third token. The port matches its
    # contiguous serving.
    (None, "int8", 2, "1", False),
    ("q8_0", None, 4, None, True),  # the dense tier, megafused on both sides
    ("q8_0", "int8", 4, None, True),
])
def test_paged_serving_matches_reference_and_contiguous(jax_engines, quantize, kv_quant, n_slots,
                                                        pool, vs_reference, monkeypatch):
    import dsocr_tpu_torch.ops.kernels as port_kernels
    import dsocr_tpu_torch.ops.moe as port_moe

    jax_engine = jax_engines(quantize, kv_quant)
    port = _port(jax_engine, quantize, kv_quant)
    kw = dict(n_slots=n_slots, max_len=256, chunk_steps=4)
    vision = VisionSettings(64, 64, False)
    contiguous = _serve(ContinuousScheduler(port, _Tok(), **kw), DecodeParameters, vision)

    monkeypatch.setenv("DSOCR_PAGED_KV", "1")
    if pool:
        monkeypatch.setenv("DSOCR_POOL_PAGES", pool)
    if quantize:
        monkeypatch.setenv("DSOCR_Q8_MEGAFUSED", "1")
    traced = []
    orig_ref = jax_dq.q8_moe_megafused_layered_auto
    monkeypatch.setattr(jax_dq, "q8_moe_megafused_layered_auto",
                        lambda *a: traced.append(1) or orig_ref(*a))
    want = _serve(JaxScheduler(jax_engine, _Tok(), **kw), JaxParams, JaxVision(64, 64, False))

    ran = []
    for mod, name in ((port_kernels, "paged_kv_write"), (port_kernels, "paged_decode_attention"),
                      (port_moe, "q8_moe_megafused")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: ran.append(_n) or _o(*a, **k))
    sched = ContinuousScheduler(port, _Tok(), **kw)
    got = _serve(sched, DecodeParameters, vision)
    assert [len(t) for t in got] == BUDGETS
    assert got == contiguous
    assert got == want if vs_reference else got != want
    expect = {"paged_kv_write", "paged_decode_attention"} | ({"q8_moe_megafused"} if quantize else set())
    assert set(ran) == expect
    assert bool(traced) == bool(quantize)  # the reference ran its megafused branch too
    allocator = sched._runner.allocator
    assert allocator.free_count == allocator.n_pages  # every page came back
    if pool == "1":
        assert max(sched.batch_sizes) == 1


def _paged_port_runner(n_slots, n_pages):
    eng = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu",
                            max_seq_len=512, seed=2)
    runner, cache = eng.make_paged_slot_runner(n_slots, 256, n_pages=n_pages)
    state = runner.init_state(cache, context_len=256)
    imgs = _images()
    packets = eng.prefill_for_slots(_Tok(), [("<image>q", [im], VisionSettings(64, 64, False))
                                             for im in imgs[:n_slots]])
    return eng, runner, state, packets


def _snapshot(state):
    c = state.cache
    return [t.clone() for t in (c.k, c.v, c.tables, c.lengths, state.context, state.ctx_len,
                                state.active, state.budget)]


def test_failed_paged_join_many_leaves_state_and_free_list():
    _, runner, state, packets = _paged_port_runner(2, 1)
    params = [DecodeParameters(max_new_tokens=4)] * 2
    before, free = _snapshot(state), list(runner.allocator._free)
    with pytest.raises(MemoryError):
        runner.join_many(state, [0, 1], packets, params, [4, 4], [None, None])
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(state)))
    assert runner.allocator._free == free and runner._row_pages == {}
    # the per-row retry admits the row that fits, and the next one waits
    runner.join(state, 0, packets[0], params[0], 4)
    with pytest.raises(MemoryError):
        runner.join(state, 1, packets[1], params[1], 4)
    assert state.cache.tables[0, 0] == 0 and (state.cache.tables[1] == NO_PAGE).all()


def test_idle_rows_write_into_no_page():
    """Rows 0 and 1 join and decode, both leave, a new packet joins row 0
    (taking the pages row 1 held last). A decode step then changes the
    pool only inside row 0's pages: the released row 1 holds none."""
    eng, runner, state, packets = _paged_port_runner(2, 4)
    params = [DecodeParameters(max_new_tokens=6, no_repeat_ngram_size=None)] * 2
    runner.join_many(state, [0, 1], packets, params, [6, 6], [None, None])
    runner.run_chunk(eng.params, state, 3)
    for row in (0, 1):
        runner.release(state, row)
    assert runner.allocator.free_count == 4
    runner.join(state, 0, packets[1], params[0], 6)
    own = set(runner._row_pages[0])
    assert (state.cache.tables[1] == NO_PAGE).all()
    before = state.cache.k.clone(), state.cache.v.clone()
    runner.run_chunk(eng.params, state, 1)
    for pool, old in zip((state.cache.k, state.cache.v), before):
        changed = {p for p in range(pool.shape[1]) if not torch.equal(pool[:, p], old[:, p])}
        assert changed == own
