"""The hand-written CUDA kernels against their plain PyTorch twins, on a
card. Every test here needs CUDA (marker `cuda`) and skips without it.

This file imports neither jax nor the reference package, so it also runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(tests/conftest.py sets up JAX, hence --noconftest there.)

Tolerances: f32 outputs atol = rtol = 1e-4 (the kernels sum in another
order than cuBLAS); bf16 outputs one bf16 ulp at the largest magnitude;
the KV write is bit-exact.
"""

import numpy as np
import pytest
import torch

from dsocr_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, *shape, std=1.0):
    return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32))


def _close(got, want):
    if got.dtype == torch.bfloat16:
        tol = float(want.float().abs().max()) * 2.0 ** -7 + 1e-5
        assert float((got.float() - want.float()).abs().max()) <= tol
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("BH,qh,qw,D", [(4, 40, 40, 64), (2, 5, 7, 16), (1, 64, 64, 64)])
def test_sam_kernel_matches_twin(dev, BH, qh, qw, D):
    rng = np.random.default_rng(BH + qh)
    S = qh * qw
    q, k, v = (_randn(rng, BH, S, D, std=s).to(dev) for s in (D ** -0.5, 1.0, 1.0))
    bh, bw = _randn(rng, BH, S, qh, std=0.3).to(dev), _randn(rng, BH, S, qw, std=0.3).to(dev)
    before = K.sam_flash_attention.launches
    got = K.sam_flash_attention(q, k, v, bh, bw, width=qw)
    assert K.sam_flash_attention.launches == before + 1
    _close(got, K.sam_flash_attention_plain(q, k, v, bh, bw, width=qw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,pads", [
    (3, 4, 2, 200, 128, [0, 5, 77]),  # GQA, ragged last tile, fully masked rows
    (2, 10, 10, 256, 128, [0, 0]),
    (2, 4, 4, 40, 8, [0, 39]),  # tiny head dim, a row with one live key
])
def test_prefill_kernel_matches_twin(dev, dtype, B, H, Hkv, S, D, pads):
    rng = np.random.default_rng(S + D)
    q = _randn(rng, B, H, S, D, std=0.5).to(dev, dtype)
    k = _randn(rng, B, Hkv, S, D, std=0.5).to(dev, dtype)
    v = _randn(rng, B, Hkv, S, D).to(dev, dtype)
    pad = torch.tensor(pads, dtype=torch.int32, device=dev)
    got = K.flash_prefill_attention(q, k, v, pad, scale=D ** -0.5)
    assert got.dtype == dtype and got.shape == (B, S, H * D)
    _close(got, K.flash_prefill_attention_plain(q, k, v, pad, scale=D ** -0.5))


def _slot_caches(rng, L, B, NKV, S, D, kind, dev):
    if kind == "int8":
        codes = lambda: torch.from_numpy(rng.integers(-127, 128, size=(L, B, NKV, S, D)).astype(np.int8))  # noqa: E731
        scales = lambda: torch.from_numpy(rng.uniform(0.01, 0.1, size=(L, B, NKV, S)).astype(np.float32))  # noqa: E731
        return [t.to(dev) for t in (codes(), codes(), scales(), scales())]
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return [_randn(rng, L, B, NKV, S, D).to(dev, dtype), _randn(rng, L, B, NKV, S, D).to(dev, dtype),
            None, None]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("B,NH,NKV,S,D", [(5, 10, 10, 300, 128), (3, 8, 2, 130, 16)])
def test_slot_decode_kernel_matches_twin(dev, kind, B, NH, NKV, S, D):
    rng = np.random.default_rng(B * 7 + D)
    caches = _slot_caches(rng, 3, B, NKV, S, D, kind, dev)
    lengths = torch.from_numpy(rng.integers(0, S, size=B).astype(np.int32))
    lengths[0], lengths[-1] = 0, S - 1
    lengths = lengths.to(dev)
    for q_dtype in (torch.float32, torch.bfloat16):
        q = _randn(rng, B, NH, 1, D).to(dev, q_dtype)
        got = K.slot_decode_attention(q, *caches, 1, lengths, scale=D ** -0.5)
        assert got.dtype == q_dtype
        _close(got, K.slot_decode_attention_plain(q, *caches, 1, lengths, scale=D ** -0.5))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_slot_kv_update_kernel_bit_exact(dev, kind):
    rng = np.random.default_rng(5)
    L, B, NKV, S, D = 3, 4, 2, 64, 128
    caches = _slot_caches(rng, L, B, NKV, S, D, kind, dev)
    twins = [None if c is None else c.clone() for c in caches]
    new = [None if c is None else c[0, :, :, 5].contiguous() for c in caches]  # [B, NKV(, D)]
    lengths = torch.tensor([0, S - 1, S, 9], dtype=torch.int32, device=dev)  # S: dropped
    before = K.slot_kv_update.launches
    K.slot_kv_update(*caches, *new, 2, lengths)
    assert K.slot_kv_update.launches == before + 1
    K.slot_kv_update_plain(*twins, *new, 2, lengths)
    for got, want in zip(caches, twins):
        assert got is None or torch.equal(got, want)


def test_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros((1, 2, 64, 8), device=dev)
    with pytest.raises(ValueError):  # mixed devices
        K.flash_prefill_attention(q, q.cpu(), q, torch.zeros(1, dtype=torch.int32, device=dev), scale=1.0)
    with pytest.raises(ValueError):  # int64 pad_start
        K.flash_prefill_attention(q, q, q, torch.zeros(1, dtype=torch.int64, device=dev), scale=1.0)
