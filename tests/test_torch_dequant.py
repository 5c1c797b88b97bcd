"""Packed Q8_0 serving pieces of the port against the reference, on the
CPU, with inputs from numpy.random.default_rng fed to both packages:

- the quantizer (dsq/serve_quant.py) is bit-exact with
  dsocr_tpu.dsq.serve_quant, including all-zero blocks and exact ties;
- each kernel twin (ops/kernels/dequant_matmul.py) matches the Pallas
  functions it replaces, run in interpret mode, in both weight layouts;
- PackedQ8.dequant, project over a packed weight and both decode tiers
  of moe_apply_quant_fused over Q8_0 stacks match the reference's
  (dequant_q8_stack and moe_apply_q8_fused);
- a CPU tensor never reaches the CUDA library;
- the engine's random init packs the float model's weights, and it
  refuses Q6_K (not ported yet) and unknown formats.

Tolerance of the matmuls: 1e-5 · max(|bf16 x| @ |W|). Both sides sum
exact bf16 × bf16 products in f32, in different orders; this bounds the
reassociation error with room to spare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.ops import moe as jax_moe
from dsocr_tpu.ops.linear import project as jax_project
from dsocr_tpu.ops.pallas import dequant_matmul as jax_dq
from dsocr_tpu_torch.dsq import serve_quant as sq
from dsocr_tpu_torch.ops import kernels as K
from dsocr_tpu_torch.ops.linear import PackedQ8, project
from dsocr_tpu_torch.ops.moe import moe_apply_quant_fused


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


def _rows_with_edges(rng, r, k):
    x = rng.normal(size=(r, k)).astype(np.float32)
    x[0, :32] = 0.0  # an all-zero block
    # amax 127 → scale 1 → codes are the values themselves: exact ties
    x[1, :32] = np.linspace(-15.5, 15.5, 32, dtype=np.float32)
    x[1, 0] = 127.0
    x[2, :32] = -x[1, :32]
    x[3, :32] = 1e-30  # scale rounds to 0 in f16, codes stay
    return x


@pytest.mark.parametrize("r,k", [(8, 64), (33, 96), (5, 32)])
def test_q8_rows_bit_exact(r, k):
    x = _rows_with_edges(np.random.default_rng(r * k), r, k)
    codes, scales = sq.q8_rows(_t(x))
    want_c, want_s = jax_sq.q8_rows(x)
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    assert codes[1, 1] == -15 and codes[1, 31] == 16  # -14.5 → -15, 15.5 → 16: half away from zero


@pytest.mark.parametrize("shape", [(96, 40), (2, 64, 24), (40, 8)])
def test_quantize_plain_bit_exact(shape):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = sq.quantize_plain(_t(w))
    want = jax_sq.quantize_plain(w)
    if shape[-2] % 32:  # stays float
        assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), w)
        return
    np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
    np.testing.assert_array_equal(got["scales"].numpy(), want["scales"])


@pytest.mark.parametrize("shape", [(2, 3, 64, 24), (1, 4, 32, 36), (1, 2, 16, 8)])
def test_quantize_expert_stack_bit_exact(shape):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    w[0, 0, :32, 0] = 0.0
    got = sq.quantize_expert_stack(_t(w))
    want = jax_sq.quantize_expert_stack(w)
    if shape[-2] % 32:
        assert isinstance(got, torch.Tensor)
        return
    np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
    np.testing.assert_array_equal(got["scales"].numpy(), want["scales"])


@pytest.mark.parametrize("packer", ["plain", "experts"])
def test_k_quants_raise(packer):
    """Both packers pack Q6_K at in % 256 == 0 (codes, highs, scales; the
    values in tests/test_torch_q6k.py) and fall back to Q8_0 below it, as
    the reference does; a method the port does not serve still raises."""
    method = "q6_k"
    pack = sq.quantize_plain if packer == "plain" else sq.quantize_expert_stack
    lead = () if packer == "plain" else (2,)
    assert sq.effective_method(method, 256) == jax_sq.effective_method(method, 256) == method
    assert sq.effective_method(method, 96) == jax_sq.effective_method(method, 96) == "q8_0"
    got = pack(torch.zeros((*lead, 256, 8)), method)
    assert set(got) == {"codes", "highs", "scales"} and got["highs"].dtype == torch.uint8
    assert pack(torch.zeros((*lead, 96, 8)), method)["codes"].dtype == torch.int8
    with pytest.raises(NotImplementedError):
        pack(torch.zeros((*lead, 256, 8)), "int4")


# -- the kernel twins against the Pallas kernels ---------------------------------------


def _packed(rng, lead, k, m, in_major):
    w = (rng.normal(size=(*lead, k, m)) * k ** -0.5).astype(np.float32)
    return (jax_sq.quantize_expert_stack if in_major else jax_sq.quantize_plain)(w)


def _x(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return x if dtype == "f32" else _f32_of_bf16(x)


def _jx(x, dtype):
    return jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)


def _tx(x, dtype):
    return _t(x) if dtype == "f32" else _t(x).to(torch.bfloat16)


def _deq_rows(p):
    return p["codes"].astype(np.float32) * np.repeat(p["scales"], 32, axis=-1)


def _deq_inmajor(p):
    return p["codes"].astype(np.float32) * np.repeat(p["scales"], 32, axis=-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,m", [(5, 32, 64), (16, 96, 200), (40, 64, 384), (1, 32, 64), (17, 96, 200),
                                   (1, 96, 36), (17, 32, 36)])
def test_q8_matmul_twin_matches_pallas(dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    p = _packed(rng, (), k, m, False)
    x = _x(rng, (n, k), dtype)
    want = jax_dq.q8_matmul(_jx(x, dtype), jnp.asarray(p["codes"]), jnp.asarray(p["scales"]),
                            interpret=True)
    got = K.q8_matmul(_tx(x, dtype), _t(p["codes"]), _t(p["scales"]))
    _assert_close(got.numpy(), want, x, _deq_rows(p).T)


@pytest.mark.parametrize("layer", [0, 2])
def test_q8_matmul_twin_on_a_layer_matches_layered_pallas(layer):
    rng = np.random.default_rng(layer)
    p = _packed(rng, (3,), 64, 96, False)  # codes [L, M, K]
    x = _x(rng, (7, 64), "f32")
    want = jax_dq.q8_matmul_layered(jnp.asarray(x), jnp.asarray(p["codes"]),
                                    jnp.asarray(p["scales"]), jnp.int32(layer), interpret=True)
    got = K.q8_matmul(_t(x), _t(p["codes"])[layer], _t(p["scales"])[layer])
    _assert_close(got.numpy(), want, x, _deq_rows(p)[layer].T)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", [(4, 8, 32, 64), (3, 5, 64, 36), (8, 12, 96, 128)])
def test_q8_gather_twin_matches_pallas(dtype, e, n, k, m):
    rng = np.random.default_rng(e * n + k)
    p = _packed(rng, (1, e), k, m, True)  # [1, E, K, M]
    x = _x(rng, (n, k), dtype)
    idx = rng.integers(0, e, size=n).astype(np.int32)
    codes, scales = p["codes"][0], p["scales"][0]
    want = jax_dq.q8_gather_matmul(_jx(x, dtype), jnp.asarray(codes), jnp.asarray(scales),
                                   jnp.asarray(idx), interpret=True)
    got = K.q8_gather_matmul(_tx(x, dtype), _t(codes), _t(scales), _t(idx))
    w = _deq_inmajor(p)[0][idx]  # [N, K, M]
    for row in range(n):
        _assert_close(got.numpy()[row : row + 1], np.asarray(want)[row : row + 1], x[row : row + 1], w[row])


@pytest.mark.parametrize("layer", [0, 1])
def test_q8_gather_twin_on_a_layer_matches_layered_pallas(layer):
    rng = np.random.default_rng(10 + layer)
    p = _packed(rng, (2, 4), 64, 64, True)  # [L, E, K, M]
    x = _x(rng, (6, 64), "f32")
    idx = np.asarray([3, 0, 0, 2, 1, 3], np.int32)
    want = jax_dq.q8_gather_matmul_layered(
        jnp.asarray(x), jnp.asarray(p["codes"]), jnp.asarray(p["scales"]), jnp.asarray(idx),
        jnp.int32(layer), interpret=True,
    )
    got = K.q8_gather_matmul(_t(x), _t(p["codes"])[layer], _t(p["scales"])[layer], _t(idx))
    w = _deq_inmajor(p)[layer][idx]
    for row in range(len(idx)):
        _assert_close(got.numpy()[row : row + 1], np.asarray(want)[row : row + 1], x[row : row + 1], w[row])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", [(4, 3, 32, 64), (5, 16, 64, 36), (3, 20, 96, 256)])
def test_q8_dense_expert_twins_match_layered_pallas(dtype, e, n, k, m):
    rng = np.random.default_rng(e + n * k)
    p = _packed(rng, (2, e), k, m, True)
    layer = 1
    codes, scales = _t(p["codes"])[layer], _t(p["scales"])[layer]
    w = _deq_inmajor(p)[layer]
    x = _x(rng, (n, k), dtype)
    want = jax_dq.q8_dense_experts_layered(_jx(x, dtype), jnp.asarray(p["codes"]),
                                           jnp.asarray(p["scales"]), jnp.int32(layer), interpret=True)
    got = K.q8_dense_experts(_tx(x, dtype), codes, scales)
    _assert_close(got.numpy(), want, x[None], w)
    xe = _x(rng, (e, n, k), dtype)
    want = jax_dq.q8_dense_experts_perx_layered(_jx(xe, dtype), jnp.asarray(p["codes"]),
                                                jnp.asarray(p["scales"]), jnp.int32(layer),
                                                interpret=True)
    got = K.q8_dense_experts_perx(_tx(xe, dtype), codes, scales)
    _assert_close(got.numpy(), want, xe, w)


def test_cpu_tensors_never_reach_the_cuda_library(monkeypatch):
    from dsocr_tpu_torch.ops.kernels import _lib

    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_lib, "lib", refuse)
    rng = np.random.default_rng(0)
    rows = _packed(rng, (), 32, 64, False)
    experts = _packed(rng, (1, 3), 32, 64, True)
    x = _t(rng.normal(size=(4, 32)).astype(np.float32))
    codes, scales = _t(experts["codes"][0]), _t(experts["scales"][0])
    before = K.launch_counts()
    assert K.q8_matmul(x, _t(rows["codes"]), _t(rows["scales"])).shape == (4, 64)
    assert K.q8_gather_matmul(x, codes, scales, torch.tensor([0, 2, 1, 1], dtype=torch.int32)).shape == (4, 64)
    assert K.q8_dense_experts(x, codes, scales).shape == (3, 4, 64)
    assert K.q8_dense_experts_perx(torch.stack([x] * 3), codes, scales).shape == (3, 4, 64)
    assert K.launch_counts() == before  # the twins count nothing


# -- dequant, project and the decode tiers -----------------------------------------------


def test_dequant_q8_stack_bit_exact():
    p = _packed(np.random.default_rng(4), (1, 3), 64, 40, True)
    holder = PackedQ8(_t(p["codes"][0]), _t(p["scales"][0]), in_major=True)
    want = jax_moe.dequant_q8_stack({"codes": jnp.asarray(p["codes"][0]), "scales": jnp.asarray(p["scales"][0])})
    got = holder.dequant()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_project_over_packed_weight_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    p = _packed(rng, (), 64, 96, False)
    x = rng.normal(size=(*lead, 64)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    want = jax_project(jnp.asarray(x), {"codes": jnp.asarray(p["codes"]), "scales": jnp.asarray(p["scales"])},
                       jnp.asarray(bias))
    got = project(_t(x), PackedQ8(_t(p["codes"]), _t(p["scales"]), in_major=False), _t(bias))
    assert got.dtype == torch.float32 and got.shape == (*lead, 96)
    _assert_close(got.numpy() - bias, np.asarray(want) - bias, x, _deq_rows(p).T)


@pytest.mark.parametrize("n,tier", [(2, "gather"), (5, "dense"), (1, "gather")])
def test_moe_apply_q8_fused_matches_reference(n, tier, monkeypatch):
    """E = 4 experts at top-2: N·k ≤ 4 gathers, above that the dense sweep;
    the reference's all-Q8_0 branch against the port's one function."""
    import dsocr_tpu_torch.ops.linear as port_linear

    rng = np.random.default_rng(n)
    E, k, H, I = 4, 2, 64, 32
    gu = _packed(rng, (2, E), H, 2 * I, True)
    dn = _packed(rng, (2, E), I, H, True)
    tokens = rng.normal(size=(n, H)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(n)]).astype(np.int32)
    layer = 1
    want = jax_moe.moe_apply_q8_fused(
        jnp.asarray(tokens), jnp.asarray(weights), jnp.asarray(idx),
        jax_moe.LayeredQ8(jnp.asarray(gu["codes"]), jnp.asarray(gu["scales"]), jnp.int32(layer)),
        jax_moe.LayeredQ8(jnp.asarray(dn["codes"]), jnp.asarray(dn["scales"]), jnp.int32(layer)),
    )
    ran = []
    for name in ("q8_gather_matmul", "q8_dense_experts"):
        orig = getattr(port_linear, name)
        monkeypatch.setattr(port_linear, name, lambda *a, _o=orig, _n=name: ran.append(_n) or _o(*a))
    got = moe_apply_quant_fused(
        _t(tokens), _t(weights), _t(idx).long(),
        PackedQ8(_t(gu["codes"][layer]), _t(gu["scales"][layer]), in_major=True),
        PackedQ8(_t(dn["codes"][layer]), _t(dn["scales"][layer]), in_major=True),
    )
    assert set(ran) == {"q8_gather_matmul" if tier == "gather" else "q8_dense_experts"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- the engine --------------------------------------------------------------------


def _q8_tiny():
    import dataclasses

    from dsocr_tpu_torch.models.deepseek import tiny_deepseek_config

    cfg = tiny_deepseek_config()
    return dataclasses.replace(cfg, language=dataclasses.replace(cfg.language, moe_intermediate_size=32))


@pytest.mark.parametrize("init", ["seed", "float_state"])
def test_q8_engine_packs_the_float_models_weights(init):
    """One seed: the Q8_0 engine's random init holds the packed float
    engine's weights, as does a Q8_0 engine given the float state (the
    reference's DeepseekOcrEngine(params=float, quantize="q8_0")); the
    dense-prefix MLP, router, norms and embeddings stay float."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine
    from dsocr_tpu_torch.models.deepseek.quantize import quantize_decoder_params

    kw = dict(dtype=torch.float32, device="cpu", max_seq_len=64)
    float_state = DeepseekOcrEngine(_q8_tiny(), seed=5, **kw).model.state_dict()
    want = quantize_decoder_params(float_state)
    if init == "seed":
        engine = DeepseekOcrEngine(_q8_tiny(), seed=5, quantize="q8_0", **kw)
    else:
        engine = DeepseekOcrEngine(_q8_tiny(), state=float_state, quantize="q8_0", **kw)
    got = engine.model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    packed = {k.rsplit(".", 1)[0] for k in got if k.endswith(".codes")}
    assert "decoder.lm_head" in packed and "decoder.moe_layers.1.experts_down" in packed
    assert "decoder.dense_layers.0.qkv_proj" in packed
    assert not any("gateup_proj" in k or "gate_weight" in k or "norm" in k for k in packed)
    assert engine.model.decoder.quantize_s >= 0.0


def test_engine_accepts_q8_0_only():
    """Q8_0 and both K-quants are served (Q4_K: tests/test_torch_kquant.py,
    Q6_K: tests/test_torch_q6k.py): a Q6_K engine at this config (in dims
    below 256) packs every eligible weight as Q8_0; other methods raise."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine
    from dsocr_tpu_torch.ops.linear import PackedQ8

    engine = DeepseekOcrEngine(_q8_tiny(), dtype=torch.float32, device="cpu", max_seq_len=64,
                               quantize="q6_k")
    assert engine.quantize == "q6_k"
    assert isinstance(engine.model.decoder.moe_layers[0].experts_gateup, PackedQ8)
    with pytest.raises(ValueError):
        DeepseekOcrEngine(_q8_tiny(), dtype=torch.float32, device="cpu", quantize="int4")
