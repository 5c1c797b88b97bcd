"""Packed Q4_K serving pieces of the port against the reference, on the
CPU, with inputs from numpy.random.default_rng fed to both packages:

- ``q4k_rows`` (dsq/quant.py) is bit-exact with the reference's NumPy
  ``quantize_q4_k`` followed by its payload decode, including all-zero
  and flat sub-blocks, exact .5 ties and a super-block whose largest
  scale is 0;
- both packers (dsq/serve_quant.py) equal the reference's plane dicts
  after the layout change, including the Q8_0 fallback at in dim 96, and
  ``params_from_jax``'s conversion gives the port packer's tensors;
- each kernel twin (ops/kernels/kquant_matmul.py) matches the Pallas
  functions it replaces, run in interpret mode: plain and ``_layered``,
  row and in-major, f32 and bf16 x;
- PackedQ4K.dequant, project over a PackedQ4K and both decode tiers of
  moe_apply_quant_fused (a mixed Q4_K / Q8_0 group and an all-Q4_K one)
  match the reference's, and run the kernels of each projection's format;
- a CPU tensor never reaches the CUDA library;
- the engine's random init packs the float model's weights.

Tolerance of the matmuls: 1e-5 · max(|bf16 x| @ |W|). Both sides sum
exact bf16 × bf16 products in f32, in different orders; this bounds the
reassociation error with room to spare.

The reference's packers run its NumPy quantizer (DSOCR_NO_NATIVE=1).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.dsq.quant import quantize_q4_k
from dsocr_tpu.ops import moe as jax_moe
from dsocr_tpu.ops.linear import project as jax_project
from dsocr_tpu.ops.pallas import kquant_matmul as jax_kq
from dsocr_tpu_torch.dsq import serve_quant as sq
from dsocr_tpu_torch.dsq.quant import q4k_rows
from dsocr_tpu_torch.ops import kernels as K
from dsocr_tpu_torch.ops.linear import PackedQ4K, PackedQ8, project
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
    x[0, :32] = 0.0  # an all-zero sub-block
    x[1, 32:64] = 0.75  # a flat sub-block: vmax == vmin
    x[2, :32] = np.arange(32, dtype=np.float32) * 0.5 - 7.5  # .5 steps: exact ties
    x[3, :256] = 0.0  # a whole super-block at 0: max scale 0
    x[4, :256] = np.repeat(np.linspace(0.0, 2.0, 8, dtype=np.float32), 32)  # flat, max scale 0
    return x


@pytest.mark.parametrize("r,k,std", [(8, 256, 1.0), (6, 512, 0.02), (5, 1280, 30.0), (40, 256, 1e-3)])
def test_q4k_rows_bit_exact(r, k, std):
    x = _rows_with_edges(np.random.default_rng(r * k), r, k, std)
    codes, scales, mins = q4k_rows(_t(x))
    want_c, want_s, want_b = jax_kq._q4k_decode_payload(quantize_q4_k(x, r, k), r, k)
    assert codes.dtype == torch.uint8 and int(codes.max()) <= 15
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    np.testing.assert_array_equal(mins.numpy(), want_b)
    assert (scales.numpy()[3, :8] == 0).all() and (codes.numpy()[3, :256] == 0).all()


def test_q4k_rows_bit_exact_on_bf16_weights():
    """The engine packs weights drawn in the model dtype."""
    x = _f32_of_bf16(np.random.default_rng(2).normal(size=(64, 768)) * 0.05)
    codes, scales, mins = q4k_rows(_t(x).to(torch.bfloat16))
    want_c, want_s, want_b = jax_kq._q4k_decode_payload(quantize_q4_k(x, 64, 768), 64, 768)
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    np.testing.assert_array_equal(mins.numpy(), want_b)


def test_q4k_rows_needs_whole_super_blocks():
    with pytest.raises(ValueError, match="256"):
        q4k_rows(torch.zeros((2, 96)))


def _planes_to_codes(planes, axis):
    """The reference's plane dict → (codes in K order, scales, mins)."""
    p = np.asarray(planes["packed"])
    codes = np.concatenate([p & 0xF, p >> 4], axis=axis)
    s = np.concatenate([planes["s_lo"], planes["s_hi"]], axis=axis)
    b = np.concatenate([planes["b_lo"], planes["b_hi"]], axis=axis)
    return codes, s, b


def _assert_packed_equal(got, want, axis):
    if "codes" in want:  # the Q8_0 fallback
        assert got["codes"].dtype == torch.int8 and set(got) == {"codes", "scales"}
        np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
        np.testing.assert_array_equal(got["scales"].numpy(), want["scales"])
        return
    codes, s, b = _planes_to_codes(want, axis)
    assert all(t.is_contiguous() for t in got.values())  # the kernels take dense layouts
    assert got["codes"].dtype == torch.uint8
    assert got["codes"].shape[axis] * 2 == codes.shape[axis]
    np.testing.assert_array_equal(sq.unpack_bits(got["codes"], axis, 4).numpy(), codes)
    np.testing.assert_array_equal(got["scales"].numpy(), s)
    np.testing.assert_array_equal(got["mins"].numpy(), b)


@pytest.mark.parametrize("shape", [(256, 40), (2, 512, 24), (96, 8), (40, 8)])
def test_quantize_plain_q4k_bit_exact(shape):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = sq.quantize_plain(_t(w), "q4_k")
    want = jax_sq.quantize_plain(w, "q4_k")
    if shape[-2] % 32:  # stays float
        assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), w)
        return
    _assert_packed_equal(got, want, -1)


@pytest.mark.parametrize("shape", [(2, 3, 256, 24), (1, 4, 512, 36), (1, 2, 96, 16)])
def test_quantize_expert_stack_q4k_bit_exact(shape):
    w = (np.random.default_rng(sum(shape)).normal(size=shape) * 0.1).astype(np.float32)
    w[0, 0, :32, 0] = 0.0
    got = sq.quantize_expert_stack(_t(w), "q4_k")
    want = jax_sq.quantize_expert_stack(w, "q4_k")
    _assert_packed_equal(got, want, -2)


@pytest.mark.parametrize("in_major", [False, True])
def test_params_from_jax_planes_equal_the_port_packer(in_major):
    from dsocr_tpu_torch.models.deepseek.convert import _q4k_from_planes

    w = np.random.default_rng(7).normal(size=(3, 512, 40)).astype(np.float32)
    if in_major:
        want = sq.quantize_expert_stack(_t(w), "q4_k")
        planes = jax_sq.quantize_expert_stack(w[None], "q4_k")
        planes = {k: v[0] for k, v in planes.items()}
    else:
        want = sq.quantize_plain(_t(w), "q4_k")
        planes = jax_sq.quantize_plain(w, "q4_k")
    got = _q4k_from_planes(planes, in_major=in_major)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].numpy())


def test_nibble_packing_round_trips():
    codes = torch.from_numpy(np.random.default_rng(0).integers(0, 16, size=(4, 8, 6)).astype(np.uint8))
    for dim in (-1, -2, 0):
        packed = sq.pack_bits(codes, dim, 4)
        assert packed.shape[dim] * 2 == codes.shape[dim]
        assert torch.equal(sq.unpack_bits(packed, dim, 4), codes)
    assert int(sq.pack_bits(torch.tensor([3, 12], dtype=torch.uint8), 0, 4)[0]) == 3 | (12 << 4)


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


def _deq(p, dim):
    """The port's packed dict → f32 of the bf16 weight, K along `dim`."""
    from dsocr_tpu_torch.ops.kernels.kquant_matmul import dequant_q4k

    return dequant_q4k(p["codes"], p["scales"], p["mins"], dim).float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,m", [(5, 256, 128), (16, 512, 200), (40, 256, 384), (1, 256, 128), (17, 512, 200),
                                   (1, 512, 36)])
def test_q4k_matmul_twin_matches_pallas(dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    w = _w(rng, (), k, m)
    x = _x(rng, (n, k), dtype)
    want = jax_kq.q4k_matmul(_jx(x, dtype), _jplanes(jax_sq.quantize_plain(w, "q4_k")), interpret=True)
    p = sq.quantize_plain(_t(w), "q4_k")
    got = K.q4k_matmul(_tx(x, dtype), p["codes"], p["scales"], p["mins"])
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, x, _deq(p, -1).T)


@pytest.mark.parametrize("layer", [0, 2])
def test_q4k_matmul_twin_on_a_layer_matches_layered_pallas(layer):
    rng = np.random.default_rng(layer)
    w = _w(rng, (3,), 256, 128)  # [L, K, M]
    x = _x(rng, (7, 256), "f32")
    want = jax_kq.q4k_matmul_layered(jnp.asarray(x), _jplanes(jax_sq.quantize_plain(w, "q4_k")),
                                     jnp.int32(layer), interpret=True)
    p = sq.quantize_plain(_t(w), "q4_k")  # codes [L, M, K/2]
    got = K.q4k_matmul(_t(x), p["codes"][layer], p["scales"][layer], p["mins"][layer])
    _assert_close(got.numpy(), want, x, _deq(p, -1)[layer].T)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", [(4, 8, 256, 64), (3, 5, 512, 36), (8, 12, 256, 128)])
def test_q4k_gather_twin_matches_pallas(dtype, e, n, k, m):
    rng = np.random.default_rng(e * n + k)
    w = _w(rng, (1, e), k, m)
    x = _x(rng, (n, k), dtype)
    idx = rng.integers(0, e, size=n).astype(np.int32)
    planes = {key: v[0] for key, v in jax_sq.quantize_expert_stack(w, "q4_k").items()}
    want = jax_kq.q4k_gather_matmul(_jx(x, dtype), _jplanes(planes), jnp.asarray(idx), interpret=True)
    p = sq.quantize_expert_stack(_t(w[0]), "q4_k")  # [E, K/2, M]
    got = K.q4k_gather_matmul(_tx(x, dtype), p["codes"], p["scales"], p["mins"], _t(idx))
    deq = _deq(p, -2)[idx]  # [N, K, M]
    for row in range(n):
        _assert_close(got.numpy()[row : row + 1], np.asarray(want)[row : row + 1], x[row : row + 1], deq[row])


@pytest.mark.parametrize("layer", [0, 1])
def test_q4k_gather_twin_on_a_layer_matches_layered_pallas(layer):
    rng = np.random.default_rng(10 + layer)
    w = _w(rng, (2, 4), 256, 64)  # [L, E, K, M]
    x = _x(rng, (6, 256), "f32")
    idx = np.asarray([3, 0, 0, 2, 1, 3], np.int32)
    want = jax_kq.q4k_gather_matmul_layered(
        jnp.asarray(x), _jplanes(jax_sq.quantize_expert_stack(w, "q4_k")), jnp.asarray(idx),
        jnp.int32(layer), interpret=True,
    )
    p = sq.quantize_expert_stack(_t(w), "q4_k")  # [L, E, K/2, M]
    got = K.q4k_gather_matmul(_t(x), p["codes"][layer], p["scales"][layer], p["mins"][layer], _t(idx))
    deq = _deq(p, -2)[layer][idx]
    for row in range(len(idx)):
        _assert_close(got.numpy()[row : row + 1], np.asarray(want)[row : row + 1], x[row : row + 1], deq[row])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", [(4, 3, 256, 64), (5, 16, 512, 36), (3, 20, 256, 256)])
def test_q4k_dense_expert_twins_match_layered_pallas(dtype, e, n, k, m):
    rng = np.random.default_rng(e + n * k)
    w = _w(rng, (2, e), k, m)
    planes = _jplanes(jax_sq.quantize_expert_stack(w, "q4_k"))
    p = sq.quantize_expert_stack(_t(w), "q4_k")
    layer = 1
    codes, scales, mins = p["codes"][layer], p["scales"][layer], p["mins"][layer]
    deq = _deq(p, -2)[layer]
    x = _x(rng, (n, k), dtype)
    want = jax_kq.q4k_dense_experts_layered(_jx(x, dtype), planes, jnp.int32(layer), interpret=True)
    got = K.q4k_dense_experts(_tx(x, dtype), codes, scales, mins)
    _assert_close(got.numpy(), want, x[None], deq)
    xe = _x(rng, (e, n, k), dtype)
    want = jax_kq.q4k_dense_experts_perx_layered(_jx(xe, dtype), planes, jnp.int32(layer), interpret=True)
    got = K.q4k_dense_experts_perx(_tx(xe, dtype), codes, scales, mins)
    _assert_close(got.numpy(), want, xe, deq)


def test_cpu_tensors_never_reach_the_cuda_library(monkeypatch):
    from dsocr_tpu_torch.ops.kernels import _lib

    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_lib, "lib", refuse)
    rng = np.random.default_rng(0)
    rows = sq.quantize_plain(_t(_w(rng, (), 256, 64)), "q4_k")
    ex = sq.quantize_expert_stack(_t(_w(rng, (3,), 256, 64)), "q4_k")
    x = _t(rng.normal(size=(4, 256)).astype(np.float32))
    packed = (ex["codes"], ex["scales"], ex["mins"])
    before = K.launch_counts()
    assert K.q4k_matmul(x, rows["codes"], rows["scales"], rows["mins"]).shape == (4, 64)
    idx = torch.tensor([0, 2, 1, 1], dtype=torch.int32)
    assert K.q4k_gather_matmul(x, *packed, idx).shape == (4, 64)
    assert K.q4k_dense_experts(x, *packed).shape == (3, 4, 64)
    assert K.q4k_dense_experts_perx(torch.stack([x] * 3), *packed).shape == (3, 4, 64)
    assert K.launch_counts() == before  # the twins count nothing


# -- dequant, project and the decode tiers -----------------------------------------------


def test_dequant_q4k_stack_bit_exact():
    w = _w(np.random.default_rng(4), (1, 3), 512, 40)
    planes = {k: jnp.asarray(v[0]) for k, v in jax_sq.quantize_expert_stack(w, "q4_k").items()}
    p = sq.quantize_expert_stack(_t(w[0]), "q4_k")
    holder = PackedQ4K(p["codes"], p["scales"], p["mins"], in_major=True)
    want = jax_kq.dequant_q4k_planes(planes, axis=-2)
    got = holder.dequant()
    assert got.dtype == torch.bfloat16 and got.shape == (3, 512, 40)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_project_over_packed_q4k_weight_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    w = _w(rng, (), 256, 96)
    x = rng.normal(size=(*lead, 256)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    want = jax_project(jnp.asarray(x), _jplanes(jax_sq.quantize_plain(w, "q4_k")), jnp.asarray(bias))
    p = sq.quantize_plain(_t(w), "q4_k")
    holder = PackedQ4K(p["codes"], p["scales"], p["mins"], in_major=False)
    assert holder.float_shape == (256, 96)
    got = project(_t(x), holder, _t(bias))
    assert got.dtype == torch.float32 and got.shape == (*lead, 96)
    _assert_close(got.numpy() - bias, np.asarray(want) - bias, x, _deq(p, -1).T)


_EXPERT_KERNELS = ("q4k_gather_matmul", "q4k_dense_experts", "q4k_dense_experts_perx",
                   "q8_gather_matmul", "q8_dense_experts", "q8_dense_experts_perx")


def _stack(rng, k, m):
    """One layer's expert stack packed by both packages: (reference view
    of layer 1 of a 2-layer stack, port holder of that layer)."""
    w = _w(rng, (2, 4), k, m)
    ref = jax_sq.quantize_expert_stack(w, "q4_k")
    port = sq.quantize_expert_stack(_t(w[1]), "q4_k")
    if "codes" in ref:  # the Q8_0 fallback (k % 256)
        view = jax_moe.LayeredQ8(jnp.asarray(ref["codes"]), jnp.asarray(ref["scales"]), jnp.int32(1))
        return view, PackedQ8(port["codes"], port["scales"], in_major=True)
    view = jax_moe.LayeredKQuant(_jplanes(ref), jnp.int32(1), "q4_k")
    return view, PackedQ4K(port["codes"], port["scales"], port["mins"], in_major=True)


@pytest.mark.parametrize("inter,n,kernels", [
    (32, 2, {"q4k_gather_matmul", "q8_gather_matmul"}),
    (32, 5, {"q4k_dense_experts", "q8_dense_experts_perx"}),
    (32, 1, {"q4k_gather_matmul", "q8_gather_matmul"}),
    (256, 2, {"q4k_gather_matmul"}),
    (256, 5, {"q4k_dense_experts", "q4k_dense_experts_perx"}),
])
def test_moe_apply_quant_fused_matches_reference(inter, n, kernels, monkeypatch):
    """E = 4 experts at top-2: N·k ≤ 4 gathers, above that the dense sweep.
    inter 32: Q4_K gate+up with a Q8_0 down (in dim 32 misses 256)."""
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
def test_q4k_engine_packs_the_float_models_weights(init):
    """One seed: the Q4_K engine's random init holds the packed float
    engine's weights, as does a Q4_K engine given the float state; in dims
    that miss 256 (the down projections, in dim 32) pack as Q8_0, and the
    dense-prefix MLP, router, norms and embeddings stay float."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine
    from dsocr_tpu_torch.models.deepseek.quantize import quantize_decoder_params

    kw = dict(dtype=torch.float32, device="cpu", max_seq_len=64)
    float_state = DeepseekOcrEngine(_kq_tiny(), seed=5, **kw).model.state_dict()
    want = quantize_decoder_params(float_state, "q4_k")
    if init == "seed":
        engine = DeepseekOcrEngine(_kq_tiny(), seed=5, quantize="q4_k", **kw)
    else:
        engine = DeepseekOcrEngine(_kq_tiny(), state=float_state, quantize="q4_k", **kw)
    got = engine.model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    q4k = {k.rsplit(".", 1)[0] for k in got if k.endswith(".mins")}
    q8 = {k.rsplit(".", 1)[0] for k in got if k.endswith(".codes")} - q4k
    assert {"decoder.lm_head", "decoder.moe_layers.1.experts_gateup",
            "decoder.dense_layers.0.qkv_proj", "decoder.moe_layers.0.o_proj"} <= q4k
    assert q8 == {f"decoder.moe_layers.{i}.{key}" for i in (0, 1)
                  for key in ("experts_down", "shared_down")}
    assert not any("gateup_proj" in k or "gate_weight" in k or "norm" in k for k in q4k | q8)
    assert isinstance(engine.model.decoder.moe_layers[0].experts_gateup, PackedQ4K)
    assert isinstance(engine.model.decoder.moe_layers[0].experts_down, PackedQ8)
