"""The split-weight MoE tiers of the port against the reference's, on the
same inputs made from numpy seeds:

- ``gather_matmul_plain`` (the twin of the gather_matmul CUDA kernel)
  against the Pallas ``gather_matmul`` in interpret mode, with repeated and
  unused experts, bf16 and f32 for x and w, and at the kernel's edges
  (more than 16 selections of one expert, all on one, H 3000, I 130, N
  1); an index outside [0, E) gives a zero row, as the kernel writes;
- every ``moe_apply`` tier (single, gather through gather_matmul at
  ``gather_threshold=N``, dense, sorted grouped) against the reference's
  ``moe_apply``, and a spy that the gather tier calls gather_matmul three
  times (gate, up, down);
- ``moe_apply_quant`` on split packed stacks (Q8_0, Q4_K, Q6_K, and
  K-quant gate+up with a Q8_0 down) against the reference's
  ``moe_apply_quant`` over Layered views, in the gather tier (N·top_k ≤ E)
  and the dense sweep, each projection through its own format's kernel.

Tolerances: f32 sums in another order, atol = rtol = 1e-5 (1e-6 for the
gather twin, one [1, H] @ [H, I] product per row, at H 64; 1e-5 at H
3000). The bf16 tier cases run
the port in bf16 against the reference in f32 on the same bf16 values
(XLA's CPU backend has no bf16 x bf16 → f32 dot): 2^-6 of the largest
output, a few bf16 roundings of gate, up, inter and the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.ops import moe as jax_moe
from dsocr_tpu.ops.pallas.gather_matmul import gather_matmul as jax_gather_matmul
from dsocr_tpu_torch.dsq import serve_quant as sq
from dsocr_tpu_torch.ops import moe as port_moe
from dsocr_tpu_torch.ops.kernels import gather_matmul, gather_matmul_plain
from dsocr_tpu_torch.ops.linear import HOLDERS

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(a: np.ndarray, dtype: str, ref_f32: bool = False):
    """The same values for both packages: (jax array, torch tensor) in
    `dtype`; with ref_f32 the jax array holds them in f32 (XLA's CPU
    backend runs no bf16 x bf16 → f32 dot, so the reference computes the
    bf16 cases in f32 on the same bf16 values)."""
    j = jnp.asarray(a, _DT[dtype][0]).astype(jnp.float32)
    t = torch.from_numpy(np.array(j)).to(_DT[dtype][1])
    return (j if ref_f32 else j.astype(_DT[dtype][0])), t


# -- gather_matmul ---------------------------------------------------------------------


@pytest.mark.parametrize("x_dtype,w_dtype", [("bf16", "bf16"), ("f32", "f32"), ("bf16", "f32"),
                                             ("f32", "bf16")])
@pytest.mark.parametrize("i_dim", [48, 128])
@pytest.mark.parametrize("n", [1, 2, 7, 12])
def test_gather_twin_matches_pallas(n, i_dim, x_dtype, w_dtype):
    """E 8, H 64: experts drawn from the first five (three unused), so
    rows repeat experts from n = 2 on."""
    rng = np.random.default_rng(n * 1000 + i_dim)
    E, H = 8, 64
    xj, xt = _pair(rng.normal(size=(n, H)), x_dtype)
    wj, wt = _pair(rng.normal(size=(E, H, i_dim)) * H ** -0.5, w_dtype)
    idx = rng.integers(0, 5, size=n).astype(np.int32)
    want = np.asarray(jax_gather_matmul(xj, wj, jnp.asarray(idx), interpret=True))
    got = gather_matmul(xt, wt, torch.from_numpy(idx))  # a CPU tensor: the twin
    assert got.dtype == torch.float32 and got.shape == (n, i_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


# the kernel's edges: one expert taking 20 of 24 selections (tasks of 16 and
# 4), every selection on one expert, an H that is no multiple of a 64-row
# ring stage, an I that is no multiple of 128 or 4, one selection
_GATHER_EDGES = {  # case: (N, H, I)
    "20 on one expert": (24, 64, 48),
    "all on one expert": (12, 64, 48),
    "H 3000": (5, 3000, 48),
    "I 130": (5, 64, 130),
    "N 1": (1, 64, 48),
}


@pytest.mark.parametrize("x_dtype,w_dtype", [("bf16", "bf16"), ("f32", "f32"), ("bf16", "f32"),
                                             ("f32", "bf16")])
@pytest.mark.parametrize("case", list(_GATHER_EDGES))
def test_gather_twin_matches_pallas_at_the_kernel_edges(case, x_dtype, w_dtype):
    n, H, i_dim = _GATHER_EDGES[case]
    rng = np.random.default_rng(sorted(_GATHER_EDGES).index(case))
    E = 8
    xj, xt = _pair(rng.normal(size=(n, H)), x_dtype)
    wj, wt = _pair(rng.normal(size=(E, H, i_dim)) * H ** -0.5, w_dtype)
    if case == "20 on one expert":
        idx = rng.permutation(np.concatenate([np.full(20, 3), rng.choice([0, 1, 5, 7], size=4)]))
    elif case == "all on one expert":
        idx = np.full(n, 6)
    else:
        idx = rng.integers(0, 5, size=n)
    idx = idx.astype(np.int32)
    want = np.asarray(jax_gather_matmul(xj, wj, jnp.asarray(idx), interpret=True))
    got = gather_matmul(xt, wt, torch.from_numpy(idx))  # a CPU tensor: the twin
    assert got.dtype == torch.float32 and got.shape == (n, i_dim)
    tol = 1e-5 if H > 64 else 1e-6  # f32 sums of 3000 terms in another order
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_gather_twin_writes_zero_rows_outside_the_stack():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32))
    idx = torch.tensor([0, 3, -1, 2], dtype=torch.int32)
    out = gather_matmul_plain(x, w, idx)
    assert torch.equal(out[1], torch.zeros(8)) and torch.equal(out[2], torch.zeros(8))
    torch.testing.assert_close(out[0], x[0] @ w[0])
    torch.testing.assert_close(out[3], x[3] @ w[2])


# -- moe_apply (float split stacks) ---------------------------------------------------------


def _routing(rng, n, k, used):
    """top-k weights and distinct expert ids per token from the first `used`
    experts (the rest unused)."""
    idx = np.stack([rng.permutation(used)[:k] for _ in range(n)]).astype(np.int32)
    return rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32), idx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("threshold", [None, "n", 0])
@pytest.mark.parametrize("n", [1, 4, 40])
def test_moe_apply_tiers_match_reference(n, threshold, dtype):
    """E 8 at top-2 over experts 0..5 (6 and 7 unused); H 32, inter 16.
    N 1: single tier; N 4: the gather tier at gather_threshold=N, else
    dense; N 40: the sorted grouped tier (above the dense threshold)."""
    rng = np.random.default_rng(n)
    E, k, H, MI = 8, 2, 32, 16
    tok_j, tok_t = _pair(rng.normal(size=(n, H)), dtype, True)
    gate_j, gate_t = _pair(rng.normal(size=(E, H, MI)) * H ** -0.5, dtype, True)
    up_j, up_t = _pair(rng.normal(size=(E, H, MI)) * H ** -0.5, dtype, True)
    down_j, down_t = _pair(rng.normal(size=(E, MI, H)) * MI ** -0.5, dtype, True)
    weights, idx = _routing(rng, n, k, 6)
    kw = {} if threshold is None else {"gather_threshold": n if threshold == "n" else threshold}
    want = jax_moe.moe_apply(tok_j, jnp.asarray(weights), jnp.asarray(idx), gate_j, up_j, down_j, **kw)
    got = port_moe.moe_apply(tok_t, torch.from_numpy(weights), torch.from_numpy(idx).long(),
                             gate_t, up_t, down_t, **kw)
    assert got.dtype == tok_t.dtype and got.shape == (n, H)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        tol = 2.0 ** -6 * float(np.abs(want).max())
        assert float(np.abs(got.float().numpy() - want).max()) <= tol


@pytest.mark.parametrize("threshold,calls", [(None, 0), (4, 3), (3, 0)])
def test_gather_threshold_runs_the_gather_kernel(threshold, calls, monkeypatch):
    """At N = 4 the gather tier calls gather_matmul once each for gate, up
    and down; below the threshold it is not reached."""
    rng = np.random.default_rng(1)
    seen = []
    monkeypatch.setattr(port_moe, "gather_matmul",
                        lambda *a: seen.append(a[2].shape) or gather_matmul(*a))
    E, n, k, H, MI = 8, 4, 2, 32, 16

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    weights, idx = _routing(rng, n, k, E)
    kw = {} if threshold is None else {"gather_threshold": threshold}
    port_moe.moe_apply(t(n, H), torch.from_numpy(weights), torch.from_numpy(idx).long(),
                       t(E, H, MI), t(E, H, MI), t(E, MI, H), **kw)
    assert len(seen) == calls
    assert all(shape == (n * k,) for shape in seen)


# -- moe_apply_quant (packed split stacks) -------------------------------------------------


def _packed(rng, E, k_in, m, method):
    """One layer of an expert stack packed by both packages: (reference
    Layered view of layer 1 of a 2-layer stack, port holder of that
    layer). A K-quant whose in dim misses 256 packs as Q8_0 in both."""
    w = (rng.normal(size=(2, E, k_in, m)) * k_in ** -0.5).astype(np.float32)
    ref = jax_sq.quantize_expert_stack(w, method)
    port = sq.quantize_expert_stack(torch.from_numpy(w[1]), method)
    ref_method = "q8_0" if "codes" in ref else method
    if ref_method == "q8_0":
        view = jax_moe.LayeredQ8(jnp.asarray(ref["codes"]), jnp.asarray(ref["scales"]), jnp.int32(1))
    else:
        view = jax_moe.LayeredKQuant({key: jnp.asarray(v) for key, v in ref.items()}, jnp.int32(1),
                                     ref_method)
    holder = HOLDERS["q8_0" if "mins" not in port and "highs" not in port else method]
    return view, holder(*(port[name] for name, _, _ in holder.PARTS), in_major=True)


_EXPERT_KERNELS = tuple(f"{fmt}_{kind}" for fmt in ("q8", "q4k", "q6k")
                        for kind in ("gather_matmul", "dense_experts", "dense_experts_perx"))


@pytest.mark.parametrize("method,inter,n,kernels", [
    ("q8_0", 32, 2, {"q8_gather_matmul"}),
    ("q8_0", 32, 5, {"q8_dense_experts", "q8_dense_experts_perx"}),
    ("q4_k", 256, 2, {"q4k_gather_matmul"}),
    ("q4_k", 256, 5, {"q4k_dense_experts", "q4k_dense_experts_perx"}),
    ("q6_k", 256, 1, {"q6k_gather_matmul"}),
    ("q6_k", 256, 5, {"q6k_dense_experts", "q6k_dense_experts_perx"}),
    ("q4_k", 32, 2, {"q4k_gather_matmul", "q8_gather_matmul"}),  # mixed: Q8_0 down (in dim 32)
    ("q4_k", 32, 5, {"q4k_dense_experts", "q8_dense_experts_perx"}),
    ("q6_k", 32, 2, {"q6k_gather_matmul", "q8_gather_matmul"}),
    ("q6_k", 32, 5, {"q6k_dense_experts", "q8_dense_experts_perx"}),
])
def test_moe_apply_quant_split_matches_reference(method, inter, n, kernels, monkeypatch):
    """E 4 at top-2, H 256: N·k ≤ 4 gathers, above it the dense sweep.
    (The reference keeps an all-Q8_0 split group on its gather kernels at
    every N; the port's sweep computes the same sums in another order.)"""
    import dsocr_tpu_torch.ops.linear as port_linear

    rng = np.random.default_rng(n + inter)
    E, k, H = 4, 2, 256
    gate_ref, gate = _packed(rng, E, H, inter, method)
    up_ref, up = _packed(rng, E, H, inter, method)
    down_ref, down = _packed(rng, E, inter, H, method)
    tokens = rng.normal(size=(n, H)).astype(np.float32)
    weights, idx = _routing(rng, n, k, E)
    want = jax_moe.moe_apply_quant(jnp.asarray(tokens), jnp.asarray(weights), jnp.asarray(idx),
                                   gate_ref, up_ref, down_ref)
    ran = []
    for name in _EXPERT_KERNELS:
        orig = getattr(port_linear, name)
        monkeypatch.setattr(port_linear, name, lambda *a, _o=orig, _n=name: ran.append(_n) or _o(*a))
    got = port_moe.moe_apply_quant(torch.from_numpy(tokens), torch.from_numpy(weights),
                                   torch.from_numpy(idx).long(), gate, up, down)
    assert set(ran) == kernels
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
