"""The KV writes from the decoder's unquantized token (``slot_kv_write``,
``paged_kv_write``: csrc/kv_attention.cuh's body quantizes the token
itself) against the reference: its ``quantize_kv_int8`` (or the cast to
the cache's dtype) followed by its Pallas ``slot_kv_update`` or
``paged_kv_update`` in interpret mode. On the CPU the wrappers run their
twins, which the card's kernels match bit for bit
(tests/test_torch_cuda.py). Bit-exact: codes, scales and float planes.

The tokens are the views DeepseekDecoder._qkv leaves ([B, NKV, 1, D] of
one projection, not contiguous), with chip_smoke.kv_tokens's edge cases:
an all-zero row (scale 0, safe 1) and rows whose values sit on rounding
ties at scales 1 and 0.5 (round half to even on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsocr_tpu.ops.attention import quantize_kv_int8 as jax_quantize
from dsocr_tpu.ops.pallas import paged_attention as jax_pa
from dsocr_tpu.ops.pallas.slot_attention import slot_kv_update as jax_slot_update
from dsocr_tpu_torch.ops import kernels as K
from dsocr_tpu_torch.ops import slot_kv_write_attend


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tokens(rng, B, NKV, D, token):
    """(k, v) torch views [B, NKV, 1, D] in the token dtype, and the same
    values as jnp [B, NKV, D]."""
    qkv = torch.from_numpy(rng.normal(size=(B, 1, 3 * NKV * D)).astype(np.float32)).to(DTYPES[token][0])
    k, v = chip_smoke.kv_tokens(torch, qkv, NKV, D)
    assert not k.is_contiguous()
    as_jax = [jnp.asarray(t[:, :, 0].float().numpy()).astype(DTYPES[token][1]) for t in (k, v)]
    return (k, v), as_jax


def _caches(rng, kind, lead, D):
    """(torch planes, jnp planes) of a cache [*lead, D]: int8 codes with f32
    scale planes, or f32 / bf16 values without."""
    if kind == "int8":
        codes = [rng.integers(-127, 128, size=(*lead, D)).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(0.01, 0.1, size=lead).astype(np.float32) for _ in range(2)]
        arrays = codes + scales
        return [torch.from_numpy(a.copy()) for a in arrays], [jnp.asarray(a) for a in arrays]
    values = [rng.normal(size=(*lead, D)).astype(np.float32) for _ in range(2)]
    t_dtype, j_dtype = DTYPES[kind]
    return ([torch.from_numpy(a.copy()).to(t_dtype) for a in values] + [None, None],
            [jnp.asarray(a).astype(j_dtype) for a in values] + [None, None])


def _reference_token(kind, k_j, v_j):
    """What the reference writes: quantize_kv_int8 for an int8 cache, else
    the cast to the cache's dtype."""
    if kind == "int8":
        (kq, ks), (vq, vs) = jax_quantize(k_j), jax_quantize(v_j)
        return kq, vq, ks, vs
    dtype = DTYPES[kind][1]
    return k_j.astype(dtype), v_j.astype(dtype), None, None


def _assert_planes_equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("token", ["bf16", "f32"])
@pytest.mark.parametrize("D", [128, 16])
def test_slot_kv_write_twin_bit_exact_with_reference(kind, token, D):
    rng = np.random.default_rng(D + len(kind) + len(token))
    L, B, NKV, S, layer = 3, 5, 2, 32, 1
    caches, jax_caches = _caches(rng, kind, (L, B, NKV, S), D)
    (k, v), (k_j, v_j) = _tokens(rng, B, NKV, D, token)
    lengths = np.array([0, S - 1, 7, 12, 19], np.int32)
    want = jax_slot_update(*jax_caches, *_reference_token(kind, k_j, v_j), jnp.int32(layer),
                           jnp.asarray(lengths), interpret=True)
    before = K.slot_kv_write.launches
    K.slot_kv_write(*caches, k, v, layer, torch.from_numpy(lengths))
    assert K.slot_kv_write.launches == before  # the twin ran: no launch
    _assert_planes_equal(caches, want)


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("token", ["bf16", "f32"])
def test_paged_kv_write_twin_bit_exact_with_reference(kind, token):
    rng = np.random.default_rng(40 + len(kind) + len(token))
    L, P, NKV, page, D, P_max, layer = 3, 12, 2, 16, 64, 3, 2
    pools, jax_pools = _caches(rng, kind, (L, P, NKV, page), D)
    (k, v), (k_j, v_j) = _tokens(rng, 5, NKV, D, token)
    # rows 0-2 (the zero and tie rows) on pages; row 3's page entry is -1;
    # row 4 on its third page
    tables = np.array([[4, 1, 9], [0, 7, 3], [2, 5, 6], [-1, -1, -1], [8, 10, 11]], np.int32)
    lengths = np.array([3, page + 5, 0, 2, 2 * page + 1], np.int32)
    # the reference's write is given the rows that have a page; the port's
    # must leave everything else untouched (checked below)
    live = tables[np.arange(5), lengths // page] >= 0
    want = jax_pa.paged_kv_update(
        *jax_pools, *(None if x is None else x[live] for x in _reference_token(kind, k_j, v_j)),
        jnp.asarray(tables[live]), jnp.asarray(lengths[live]), jnp.asarray(layer, jnp.int32), interpret=True)
    before = [None if p is None else p.clone() for p in pools]
    K.paged_kv_write(*pools, k, v, torch.from_numpy(tables), torch.from_numpy(lengths), layer)
    _assert_planes_equal(pools, want)
    # the row without a page wrote nothing: what changed is the live rows' positions
    changed = (pools[0] != before[0]).reshape(L, P, NKV, page, D).any(-1).any(2).nonzero().tolist()
    assert {tuple(c) for c in changed} <= {(layer, int(tables[b, lengths[b] // page]), int(lengths[b] % page))
                                           for b in np.nonzero(live)[0]}


def test_kv_write_twins_quantize_ties_and_zero_rows_as_the_reference():
    """The edge rows alone: scale 0 gives codes 0 and scale 0; values on
    k + 0.5 of the scale round to even."""
    rng = np.random.default_rng(3)
    (k, v), (k_j, v_j) = _tokens(rng, 3, 2, 128, "bf16")
    caches, _ = _caches(rng, "int8", (1, 3, 2, 4), 128)
    K.slot_kv_write(*caches, k, v, 0, torch.zeros(3, dtype=torch.int32))
    codes, scales = caches[0][0, :, :, 0], caches[2][0, :, :, 0]
    assert float(scales[0, 0]) == 0.0 and not codes[0, 0].any()
    assert float(scales[1, 0]) == 1.0 and codes[1, 0, 1:3].tolist() == [-98, -98]  # -98.5, -97.5
    assert float(caches[3][0, 2, 1, 0]) == 0.5
    kq, ks = jax_quantize(k_j)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(kq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ks))


def test_write_attend_writes_through_the_fused_write(monkeypatch):
    """slot_kv_write_attend hands the decoder's token to slot_kv_write
    unquantized (no PyTorch quantization before the write)."""
    import dsocr_tpu_torch.ops.kernels as port_kernels

    rng = np.random.default_rng(9)
    (k, v), _ = _tokens(rng, 3, 2, 16, "bf16")
    caches, _ = _caches(rng, "int8", (1, 3, 2, 8), 16)
    seen = []
    orig = port_kernels.slot_kv_write
    monkeypatch.setattr(port_kernels, "slot_kv_write", lambda *a: seen.append(a[4:6]) or orig(*a))
    q = torch.from_numpy(rng.normal(size=(3, 2, 1, 16)).astype(np.float32)).to(torch.bfloat16)
    slot_kv_write_attend(q, k, v, *caches, 0, torch.tensor([0, 3, 7], dtype=torch.int32), 0.25)
    assert len(seen) == 1 and seen[0][0] is k and seen[0][1] is v
