"""Packed Q6_K serving pieces of the port against the reference, on the
CPU, with inputs from numpy.random.default_rng fed to both packages:

- ``q6k_rows`` (dsq/quant.py) is bit-exact with the reference's NumPy
  ``quantize_q6_k`` followed by its payload decode, in codes and d·sc
  scales, including a dead super-block, a near-zero sub-block, exact
  .5 ties and bf16-rounded weights;
- both packers (dsq/serve_quant.py) equal ``params_from_jax``'s
  conversion of the reference's quarter-plane dicts, including the Q8_0
  fallback at in dim 96, and the 2-bit packing round-trips;
- each kernel twin (ops/kernels/kquant_matmul.py) matches the Pallas
  functions it replaces, run in interpret mode: plain and ``_layered``,
  row and in-major, f32 and bf16 x;
- PackedQ6K.dequant is bit-exact with dequant_q6k_planes; project over a
  PackedQ6K and both decode tiers of moe_apply_quant_fused (a mixed Q6_K
  / Q8_0 group and an all-Q6_K one) match the reference's, and run the
  kernels of each projection's format;
- a CPU tensor never reaches the CUDA library;
- the engine's random init packs the float model's weights;
- chip_smoke.py's Q6_K parity cases hold no greedy near-tie: their
  tokens stay the same when every packed matmul sums its bf16 products in
  f64 instead, as they must for CUDA tokens to equal CPU tokens.

Tolerance of the matmuls: 1e-5 · max(|bf16 x| @ |W|), as for Q4_K
(tests/test_torch_kquant.py). Both sides sum exact bf16 × bf16 products
in f32, in different orders; this bounds the reassociation error with
room to spare.

The reference's packers run its NumPy quantizer (DSOCR_NO_NATIVE=1).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.dsq.quant import quantize_q6_k
from dsocr_tpu.ops import moe as jax_moe
from dsocr_tpu.ops.linear import project as jax_project
from dsocr_tpu.ops.pallas import kquant_matmul as jax_kq
from dsocr_tpu_torch.dsq import serve_quant as sq
from dsocr_tpu_torch.dsq.quant import q6k_rows
from dsocr_tpu_torch.models.deepseek.convert import _q6k_from_planes
from dsocr_tpu_torch.ops import kernels as K
from dsocr_tpu_torch.ops.kernels.kquant_matmul import dequant_q6k
from dsocr_tpu_torch.ops.linear import PackedQ6K, PackedQ8, project
from dsocr_tpu_torch.ops.moe import moe_apply_quant_fused


@pytest.fixture(autouse=True)
def _numpy_quantizer(monkeypatch):
    monkeypatch.setenv("DSOCR_NO_NATIVE", "1")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process
    keeps several test processes from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32_of_bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_close(got, want, x, w):
    """w: the dequantized weight as [.., K, M], x [.., N, K]."""
    bound = np.abs(_f32_of_bf16(x)) @ np.abs(np.asarray(w, np.float32))
    tol = 1e-5 * float(bound.max())
    assert got.shape == want.shape
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= tol


# -- the quantizer -------------------------------------------------------------------


def _rows_with_edges(rng, r, k, std):
    x = (rng.normal(size=(r, k)) * std).astype(np.float32)
    x[0, :256] = 0.0  # a dead super-block
    x[1, :16] = 1e-20  # a near-zero sub-block: its 8-bit scale rounds to 0
    x[1, 16:32] = 0.0  # an all-zero (dead) sub-block in a live super-block
    x[2, :16] = np.arange(16, dtype=np.float32) * 0.5 - 4.0  # .5 steps: exact ties
    x[3, 32:48] = -x[3, 32:48].max() * 3  # equal magnitudes: argmax takes the first
    return x


@pytest.mark.parametrize("r,k,std", [(8, 256, 1.0), (6, 512, 0.02), (5, 1280, 30.0), (40, 256, 1e-3)])
def test_q6k_rows_bit_exact(r, k, std):
    x = _rows_with_edges(np.random.default_rng(r * k), r, k, std)
    codes, scales = q6k_rows(_t(x))
    want_c, want_s = jax_kq._q6k_decode_payload(quantize_q6_k(x, r, k), r, k)
    assert codes.dtype == torch.uint8 and int(codes.max()) <= 63
    assert scales.dtype == torch.float32 and scales.shape == (r, k // 16)
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    assert (scales.numpy()[0, :16] == 0).all() and (codes.numpy()[0, :256] == 0).all()
    assert (scales.numpy()[1, :2] == 0).all()


def test_q6k_rows_bit_exact_on_bf16_weights():
    """The engine packs weights drawn in the model dtype."""
    x = _f32_of_bf16(np.random.default_rng(2).normal(size=(64, 768)) * 0.05)
    codes, scales = q6k_rows(_t(x).to(torch.bfloat16))
    want_c, want_s = jax_kq._q6k_decode_payload(quantize_q6_k(x, 64, 768), 64, 768)
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(scales.numpy(), want_s)


def test_q6k_rows_needs_whole_super_blocks():
    with pytest.raises(ValueError, match="256"):
        q6k_rows(torch.zeros((2, 96)))


def _assert_packed_equal(got, planes, in_major):
    if "codes" in planes:  # the Q8_0 fallback
        assert got["codes"].dtype == torch.int8 and set(got) == {"codes", "scales"}
        np.testing.assert_array_equal(got["codes"].numpy(), planes["codes"])
        np.testing.assert_array_equal(got["scales"].numpy(), planes["scales"])
        return
    want = _q6k_from_planes(planes, in_major)
    assert set(got) == set(want) == {"codes", "highs", "scales"}
    assert all(t.is_contiguous() for t in got.values())  # the kernels take dense layouts
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])


@pytest.mark.parametrize("shape", [(256, 40), (2, 512, 24), (96, 8), (40, 8)])
def test_quantize_plain_q6k_equals_reference_planes(shape):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = sq.quantize_plain(_t(w), "q6_k")
    want = jax_sq.quantize_plain(w, "q6_k")
    if shape[-2] % 32:  # stays float
        assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), w)
        return
    if shape[-2] % 256 == 0:
        assert got["codes"].shape == (*shape[:-2], shape[-1], shape[-2] // 2)
        assert got["highs"].shape == (*shape[:-2], shape[-1], shape[-2] // 4)
    _assert_packed_equal(got, want, in_major=False)


@pytest.mark.parametrize("shape", [(2, 3, 256, 24), (1, 4, 512, 36), (1, 2, 96, 16)])
def test_quantize_expert_stack_q6k_equals_reference_planes(shape):
    w = (np.random.default_rng(sum(shape)).normal(size=shape) * 0.1).astype(np.float32)
    w[0, 0, :16, 0] = 0.0
    got = sq.quantize_expert_stack(_t(w), "q6_k")
    want = jax_sq.quantize_expert_stack(w, "q6_k")
    if shape[-2] % 256 == 0:
        assert got["highs"].shape == (*shape[:-2], shape[-2] // 4, shape[-1])
    _assert_packed_equal(got, want, in_major=True)


def test_q6k_planes_decode_to_the_reference_codes():
    """params_from_jax's unpacking of ql_a/ql_b/qh/s_i gives the payload's
    codes and scales in K order."""
    w = np.random.default_rng(5).normal(size=(512, 40)).astype(np.float32)
    port = _q6k_from_planes(jax_sq.quantize_plain(w, "q6_k"), in_major=False)
    codes = sq.unpack_bits(_t(port["codes"]), -1, 4) | (sq.unpack_bits(_t(port["highs"]), -1, 2) << 4)
    rows = w.T.copy()
    want_c, want_s = jax_kq._q6k_decode_payload(quantize_q6_k(rows, 40, 512), 40, 512)
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(port["scales"], want_s)


def test_bit_packing_round_trips():
    rng = np.random.default_rng(0)
    for bits in (2, 4):
        values = torch.from_numpy(rng.integers(0, 1 << bits, size=(4, 8, 16)).astype(np.uint8))
        for dim in (-1, -2, 0):
            packed = sq.pack_bits(values, dim, bits)
            assert packed.shape[dim] * (8 // bits) == values.shape[dim]
            assert torch.equal(sq.unpack_bits(packed, dim, bits), values)
    quad = torch.tensor([1, 2, 3, 0], dtype=torch.uint8)
    assert int(sq.pack_bits(quad, 0, 2)[0]) == 1 | (2 << 2) | (3 << 4)


# -- the kernel twins against the Pallas kernels ---------------------------------------


def _w(rng, lead, k, m):
    return (rng.normal(size=(*lead, k, m)) * k ** -0.5).astype(np.float32)


def _x(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return x if dtype == "f32" else _f32_of_bf16(x)


def _jx(x, dtype):
    return jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)


def _tx(x, dtype):
    return _t(x) if dtype == "f32" else _t(x).to(torch.bfloat16)


def _jplanes(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _packed(p):
    return p["codes"], p["highs"], p["scales"]


def _deq(p, dim):
    """The port's packed dict → f32 of the bf16 weight, K along `dim`."""
    return dequant_q6k(*_packed(p), dim).float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,m", [(5, 256, 128), (16, 512, 200), (40, 256, 384), (1, 256, 128), (17, 512, 200),
                                   (1, 512, 36)])
def test_q6k_matmul_twin_matches_pallas(dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    w = _w(rng, (), k, m)
    x = _x(rng, (n, k), dtype)
    want = jax_kq.q6k_matmul(_jx(x, dtype), _jplanes(jax_sq.quantize_plain(w, "q6_k")), interpret=True)
    p = sq.quantize_plain(_t(w), "q6_k")
    got = K.q6k_matmul(_tx(x, dtype), *_packed(p))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, x, _deq(p, -1).T)


@pytest.mark.parametrize("layer", [0, 2])
def test_q6k_matmul_twin_on_a_layer_matches_layered_pallas(layer):
    rng = np.random.default_rng(layer)
    w = _w(rng, (3,), 256, 128)  # [L, K, M]
    x = _x(rng, (7, 256), "f32")
    want = jax_kq.q6k_matmul_layered(jnp.asarray(x), _jplanes(jax_sq.quantize_plain(w, "q6_k")),
                                     jnp.int32(layer), interpret=True)
    p = sq.quantize_plain(_t(w), "q6_k")  # codes [L, M, K/2]
    got = K.q6k_matmul(_t(x), *(t[layer] for t in _packed(p)))
    _assert_close(got.numpy(), want, x, _deq(p, -1)[layer].T)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", [(4, 8, 256, 64), (3, 5, 512, 36), (8, 12, 256, 128)])
def test_q6k_gather_twin_matches_pallas(dtype, e, n, k, m):
    rng = np.random.default_rng(e * n + k)
    w = _w(rng, (1, e), k, m)
    x = _x(rng, (n, k), dtype)
    idx = rng.integers(0, e, size=n).astype(np.int32)
    planes = {key: v[0] for key, v in jax_sq.quantize_expert_stack(w, "q6_k").items()}
    want = jax_kq.q6k_gather_matmul(_jx(x, dtype), _jplanes(planes), jnp.asarray(idx), interpret=True)
    p = sq.quantize_expert_stack(_t(w[0]), "q6_k")  # [E, K/2, M]
    got = K.q6k_gather_matmul(_tx(x, dtype), *_packed(p), _t(idx))
    deq = _deq(p, -2)[idx]  # [N, K, M]
    for row in range(n):
        _assert_close(got.numpy()[row : row + 1], np.asarray(want)[row : row + 1], x[row : row + 1], deq[row])


@pytest.mark.parametrize("layer", [0, 1])
def test_q6k_gather_twin_on_a_layer_matches_layered_pallas(layer):
    rng = np.random.default_rng(10 + layer)
    w = _w(rng, (2, 4), 256, 64)  # [L, E, K, M]
    x = _x(rng, (6, 256), "f32")
    idx = np.asarray([3, 0, 0, 2, 1, 3], np.int32)
    want = jax_kq.q6k_gather_matmul_layered(
        jnp.asarray(x), _jplanes(jax_sq.quantize_expert_stack(w, "q6_k")), jnp.asarray(idx),
        jnp.int32(layer), interpret=True,
    )
    p = sq.quantize_expert_stack(_t(w), "q6_k")  # [L, E, K/2, M]
    got = K.q6k_gather_matmul(_t(x), *(t[layer] for t in _packed(p)), _t(idx))
    deq = _deq(p, -2)[layer][idx]
    for row in range(len(idx)):
        _assert_close(got.numpy()[row : row + 1], np.asarray(want)[row : row + 1], x[row : row + 1], deq[row])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", [(4, 3, 256, 64), (5, 16, 512, 36), (3, 20, 256, 256)])
def test_q6k_dense_expert_twins_match_layered_pallas(dtype, e, n, k, m):
    rng = np.random.default_rng(e + n * k)
    w = _w(rng, (2, e), k, m)
    planes = _jplanes(jax_sq.quantize_expert_stack(w, "q6_k"))
    p = sq.quantize_expert_stack(_t(w), "q6_k")
    layer = 1
    packed = tuple(t[layer] for t in _packed(p))
    deq = _deq(p, -2)[layer]
    x = _x(rng, (n, k), dtype)
    want = jax_kq.q6k_dense_experts_layered(_jx(x, dtype), planes, jnp.int32(layer), interpret=True)
    got = K.q6k_dense_experts(_tx(x, dtype), *packed)
    _assert_close(got.numpy(), want, x[None], deq)
    xe = _x(rng, (e, n, k), dtype)
    want = jax_kq.q6k_dense_experts_perx_layered(_jx(xe, dtype), planes, jnp.int32(layer), interpret=True)
    got = K.q6k_dense_experts_perx(_tx(xe, dtype), *packed)
    _assert_close(got.numpy(), want, xe, deq)


def test_cpu_tensors_never_reach_the_cuda_library(monkeypatch):
    from dsocr_tpu_torch.ops.kernels import _lib

    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_lib, "lib", refuse)
    rng = np.random.default_rng(0)
    rows = _packed(sq.quantize_plain(_t(_w(rng, (), 256, 64)), "q6_k"))
    ex = _packed(sq.quantize_expert_stack(_t(_w(rng, (3,), 256, 64)), "q6_k"))
    x = _t(rng.normal(size=(4, 256)).astype(np.float32))
    before = K.launch_counts()
    assert K.q6k_matmul(x, *rows).shape == (4, 64)
    idx = torch.tensor([0, 2, 1, 1], dtype=torch.int32)
    assert K.q6k_gather_matmul(x, *ex, idx).shape == (4, 64)
    assert K.q6k_dense_experts(x, *ex).shape == (3, 4, 64)
    assert K.q6k_dense_experts_perx(torch.stack([x] * 3), *ex).shape == (3, 4, 64)
    assert K.launch_counts() == before  # the twins count nothing


# -- dequant, project and the decode tiers -----------------------------------------------


@pytest.mark.parametrize("in_major", [False, True])
def test_dequant_q6k_bit_exact(in_major):
    w = _w(np.random.default_rng(4), (1, 3), 512, 40)
    if in_major:
        planes = {k: jnp.asarray(v[0]) for k, v in jax_sq.quantize_expert_stack(w, "q6_k").items()}
        p = sq.quantize_expert_stack(_t(w[0]), "q6_k")
        holder = PackedQ6K(*_packed(p), in_major=True)
        want = jax_kq.dequant_q6k_planes(planes, axis=-2)
        got = holder.dequant()
        assert holder.float_shape == (3, 512, 40)
        assert got.dtype == torch.bfloat16 and got.shape == (3, 512, 40)
    else:
        planes = _jplanes(jax_sq.quantize_plain(w[0], "q6_k"))
        p = sq.quantize_plain(_t(w[0]), "q6_k")  # [3, 40, 256]
        want = jax_kq.dequant_q6k_planes(planes, axis=-1)
        got = dequant_q6k(*_packed(p), -1)
        assert got.shape == (3, 40, 512)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_project_over_packed_q6k_weight_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    w = _w(rng, (), 256, 96)
    x = rng.normal(size=(*lead, 256)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    want = jax_project(jnp.asarray(x), _jplanes(jax_sq.quantize_plain(w, "q6_k")), jnp.asarray(bias))
    p = sq.quantize_plain(_t(w), "q6_k")
    holder = PackedQ6K(*_packed(p), in_major=False)
    assert holder.float_shape == (256, 96)
    got = project(_t(x), holder, _t(bias))
    assert got.dtype == torch.float32 and got.shape == (*lead, 96)
    _assert_close(got.numpy() - bias, np.asarray(want) - bias, x, _deq(p, -1).T)


_EXPERT_KERNELS = ("q6k_gather_matmul", "q6k_dense_experts", "q6k_dense_experts_perx",
                   "q8_gather_matmul", "q8_dense_experts", "q8_dense_experts_perx")


def _stack(rng, k, m):
    """One layer's expert stack packed by both packages: (reference view
    of layer 1 of a 2-layer stack, port holder of that layer)."""
    w = _w(rng, (2, 4), k, m)
    ref = jax_sq.quantize_expert_stack(w, "q6_k")
    port = sq.quantize_expert_stack(_t(w[1]), "q6_k")
    if "codes" in ref:  # the Q8_0 fallback (k % 256)
        view = jax_moe.LayeredQ8(jnp.asarray(ref["codes"]), jnp.asarray(ref["scales"]), jnp.int32(1))
        return view, PackedQ8(port["codes"], port["scales"], in_major=True)
    view = jax_moe.LayeredKQuant(_jplanes(ref), jnp.int32(1), "q6_k")
    return view, PackedQ6K(*_packed(port), in_major=True)


@pytest.mark.parametrize("inter,n,kernels", [
    (32, 2, {"q6k_gather_matmul", "q8_gather_matmul"}),
    (32, 5, {"q6k_dense_experts", "q8_dense_experts_perx"}),
    (32, 1, {"q6k_gather_matmul", "q8_gather_matmul"}),
    (256, 2, {"q6k_gather_matmul"}),
    (256, 5, {"q6k_dense_experts", "q6k_dense_experts_perx"}),
])
def test_moe_apply_quant_fused_matches_reference(inter, n, kernels, monkeypatch):
    """E = 4 experts at top-2: N·k ≤ 4 gathers, above that the dense sweep.
    inter 32: Q6_K gate+up with a Q8_0 down (in dim 32 misses 256)."""
    import dsocr_tpu_torch.ops.linear as port_linear

    rng = np.random.default_rng(n + inter)
    E, k, H = 4, 2, 256
    gu_ref, gu = _stack(rng, H, 2 * inter)
    dn_ref, dn = _stack(rng, inter, H)
    tokens = rng.normal(size=(n, H)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(n)]).astype(np.int32)
    want = jax_moe.moe_apply_quant_fused(jnp.asarray(tokens), jnp.asarray(weights), jnp.asarray(idx),
                                         gu_ref, dn_ref)
    ran = []
    for name in _EXPERT_KERNELS:
        orig = getattr(port_linear, name)
        monkeypatch.setattr(port_linear, name, lambda *a, _o=orig, _n=name: ran.append(_n) or _o(*a))
    got = moe_apply_quant_fused(_t(tokens), _t(weights), _t(idx).long(), gu, dn)
    assert set(ran) == kernels
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- the engine --------------------------------------------------------------------


def _kq_tiny():
    from dsocr_tpu_torch.models.deepseek import tiny_deepseek_config

    cfg = tiny_deepseek_config()
    lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=32)
    return dataclasses.replace(cfg, projector_n_embed=256, language=lang)


@pytest.mark.parametrize("init", ["seed", "float_state"])
def test_q6k_engine_packs_the_float_models_weights(init):
    """One seed: the Q6_K engine's random init holds the packed float
    engine's weights, as does a Q6_K engine given the float state; in dims
    that miss 256 (the down projections, in dim 32) pack as Q8_0, and the
    dense-prefix MLP, router, norms and embeddings stay float."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine
    from dsocr_tpu_torch.models.deepseek.quantize import quantize_decoder_params

    kw = dict(dtype=torch.float32, device="cpu", max_seq_len=64)
    float_state = DeepseekOcrEngine(_kq_tiny(), seed=5, **kw).model.state_dict()
    want = quantize_decoder_params(float_state, "q6_k")
    if init == "seed":
        engine = DeepseekOcrEngine(_kq_tiny(), seed=5, quantize="q6_k", **kw)
    else:
        engine = DeepseekOcrEngine(_kq_tiny(), state=float_state, quantize="q6_k", **kw)
    got = engine.model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    q6k = {k.rsplit(".", 1)[0] for k in got if k.endswith(".highs")}
    q8 = {k.rsplit(".", 1)[0] for k in got if k.endswith(".codes")} - q6k
    assert {"decoder.lm_head", "decoder.moe_layers.1.experts_gateup",
            "decoder.dense_layers.0.qkv_proj", "decoder.moe_layers.0.o_proj"} <= q6k
    assert q8 == {f"decoder.moe_layers.{i}.{key}" for i in (0, 1)
                  for key in ("experts_down", "shared_down")}
    assert not any("gateup_proj" in k or "gate_weight" in k or "norm" in k for k in q6k | q8)
    assert isinstance(engine.model.decoder.moe_layers[0].experts_gateup, PackedQ6K)
    assert isinstance(engine.model.decoder.moe_layers[0].experts_down, PackedQ8)
    assert engine.model.decoder.moe_layers[0].experts_gateup.float_shape == (4, 256, 64)


# -- chip_smoke.py's Q6_K parity seed ----------------------------------------------


def _resummed(monkeypatch):
    """Every packed holder's matmuls with the same bf16 products summed in
    f64: results that differ from the twins' in the last bits, as the
    card's tensor-core order does."""
    from dsocr_tpu_torch.ops import linear

    def row_w(h):  # [out, in] bf16
        if isinstance(h, PackedQ6K):
            return dequant_q6k(h.codes, h.highs, h.scales, -1)
        return (h.codes.float() * h.scales.repeat_interleave(32, dim=-1)).to(torch.bfloat16)

    def x64(x):
        return x.to(torch.bfloat16).double()

    for cls in (linear.PackedQ8, PackedQ6K):
        monkeypatch.setattr(cls, "matmul", lambda self, x: (x64(x) @ row_w(self).double().t()).float())
        monkeypatch.setattr(cls, "gather", lambda self, x, idx: torch.bmm(
            x64(x)[:, None], self.dequant().double()[idx.long()])[:, 0].float())
        monkeypatch.setattr(cls, "dense", lambda self, x: torch.matmul(
            x64(x)[None], self.dequant().double()).float())
        monkeypatch.setattr(cls, "dense_perx", lambda self, x: torch.matmul(
            x64(x), self.dequant().double()).float())


@pytest.mark.parametrize("moe_inter,n_slots,kv_quant", [
    (32, 2, None), (32, 2, "int8"), (32, 4, None), (32, 4, "int8"), (256, 4, None), (256, 4, "int8"),
])
def test_smoke_parity_seed_has_no_near_tie(moe_inter, n_slots, kv_quant, monkeypatch):
    """chip_smoke.py's Q6_K parity at Q6K_PARITY_SEED: the twins' greedy
    tokens, and the same with every packed matmul summed in f64."""
    import pathlib

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = tiny_deepseek_config()
    lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=moe_inter)
    cfg = dataclasses.replace(cfg, projector_n_embed=256, language=lang)
    rng = np.random.default_rng(3)  # chip_smoke.parity_phase's requests
    images = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in range(3)]
    kw = dict(dtype=torch.float32, device="cpu", max_seq_len=512, quantize="q6_k")
    state = DeepseekOcrEngine(cfg, seed=chip_smoke.Q6K_PARITY_SEED, **kw).model.state_dict()

    def tokens():
        engine = DeepseekOcrEngine(cfg, kv_quant=kv_quant, state=state, **kw)
        outs, _ = chip_smoke.serve(engine, chip_smoke.TinyTokenizer(), images, VisionSettings(64, 64, False),
                                   DecodeParameters(max_new_tokens=16, no_repeat_ngram_size=None),
                                   n_slots=n_slots, max_len=256, chunk=8)
        return [o.generated_tokens for o in outs]

    want = tokens()
    _resummed(monkeypatch)
    assert tokens() == want
