"""The hand-written CUDA kernels against their plain PyTorch twins, on a
card. Every test here needs CUDA (marker `cuda`) and skips without it.

This file imports neither jax nor the reference package, so it also runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(tests/conftest.py sets up JAX, hence --noconftest there.)

Tolerances: f32 outputs atol = rtol = 1e-4 (the kernels sum in another
order than cuBLAS); bf16 outputs one bf16 ulp at the largest magnitude;
the KV writes are bit-exact. The Q8_0, Q4_K and Q6_K matmuls: 1e-5 ·
max(|bf16 x| @ |W|), f32 reassociation of exact bf16 products; the three
quantizers are bit-exact with their CPU runs. The megafused Q8_0 chain:
chip_smoke.megafused_tol per element (reassociation, and one bf16 ulp of
an inter element whose rounding another order could flip), and two
launches give the same bits. gather_matmul: 1e-5 · max(|x| @ |W|), f32
sums in another order, and two launches give the same bits.
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


@pytest.mark.parametrize("BH,qh,qw,D", [
    (4, 40, 40, 64), (2, 5, 7, 16), (1, 64, 64, 64),
    (48, 64, 64, 64),  # the engine's launch: 4 global views x 12 heads
    (192, 40, 40, 64),  # the engine's launch: 16 tiles x 12 heads
    (2, 56, 40, 64),  # W 40: key tiles of 64 cross key rows; kh != kw
    (2, 12, 12, 128),  # D > 64 (the mma.sync body), a ragged key tile
    (3, 9, 11, 96),  # D 96, padded to 128
])
def test_sam_kernel_matches_twin(dev, BH, qh, qw, D):
    rng = np.random.default_rng(BH + qh)
    S = qh * qw
    q, k, v = (_randn(rng, BH, S, D, std=s).to(dev) for s in (D ** -0.5, 1.0, 1.0))
    bh, bw = _randn(rng, BH, S, qh, std=0.3).to(dev), _randn(rng, BH, S, qw, std=0.3).to(dev)
    before = K.sam_flash_attention.launches
    got = K.sam_flash_attention(q, k, v, bh, bw, width=qw)
    assert K.sam_flash_attention.launches == before + 1
    _close(got, K.sam_flash_attention_plain(q, k, v, bh, bw, width=qw))


@pytest.mark.parametrize("BH,qh,qw,D", [
    (12, 80, 80, 64),  # the 1280 view: S 6400, bias rows staged (80.5 KB)
    (2, 60, 96, 64),  # kw > 64: key tiles cross rows of 96
    (2, 128, 128, 64),  # past the staged budget: the bias read per score
    (2, 2, 100, 64),  # tiny S, one side large
    (2, 100, 2, 64),
    (2, 4, 240, 64),  # S 960 past the staged budget (wgmma body)
    (1, 8, 400, 80),  # S 3200 past the staged budget (mma.sync body)
    (2, 96, 96, 128),  # the mma.sync body, staged, kh and kw > 64
])
def test_sam_kernel_takes_every_grid(dev, BH, qh, qw, D):
    """Grids above 64 x 64 and past the staged bias's shared-memory budget,
    on both bias sources and both bodies: the twin within 1e-4, two
    launches bit-equal."""
    rng = np.random.default_rng(BH * qh + qw)
    S = qh * qw
    q, k, v = (_randn(rng, BH, S, D, std=s).to(dev) for s in (D ** -0.5, 1.0, 1.0))
    bh, bw = _randn(rng, BH, S, qh, std=0.3).to(dev), _randn(rng, BH, S, qw, std=0.3).to(dev)
    got = K.sam_flash_attention(q, k, v, bh, bw, width=qw)
    assert torch.equal(got, K.sam_flash_attention(q, k, v, bh, bw, width=qw))
    _close(got, K.sam_flash_attention_plain(q, k, v, bh, bw, width=qw))


def test_sam_kernel_large_scores(dev):
    """Scores of large magnitude (q std 1, bias std 3, S 1600): the online
    softmax's running max must keep exp from overflowing."""
    rng = np.random.default_rng(11)
    BH, qh, qw, D = 6, 40, 40, 64
    S = qh * qw
    q, k, v = (_randn(rng, BH, S, D).to(dev) for _ in range(3))
    bh, bw = _randn(rng, BH, S, qh, std=3.0).to(dev), _randn(rng, BH, S, qw, std=3.0).to(dev)
    got = K.sam_flash_attention(q, k, v, bh, bw, width=qw)
    assert torch.isfinite(got).all()
    _close(got, K.sam_flash_attention_plain(q, k, v, bh, bw, width=qw))


def test_sam_kernel_is_deterministic(dev):
    rng = np.random.default_rng(12)
    BH, qh, qw, D = 12, 64, 64, 64
    S = qh * qw
    q, k, v = (_randn(rng, BH, S, D, std=s).to(dev) for s in (0.125, 1.0, 1.0))
    bh, bw = _randn(rng, BH, S, qh, std=0.3).to(dev), _randn(rng, BH, S, qw, std=0.3).to(dev)
    first = K.sam_flash_attention(q, k, v, bh, bw, width=qw)
    assert torch.equal(first, K.sam_flash_attention(q, k, v, bh, bw, width=qw))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,pads", [
    (3, 4, 4, 130, 16, 16, [63, 64, 65]),  # pads at the tile boundaries, S not a multiple of 64
    (2, 6, 2, 97, 8, 8, [0, 96]),  # GQA, D 8 padded to the tensor-core depth
    (1, 2, 1, 1, 128, 128, [0]),  # one position
    (2, 10, 10, 320, 128, 128, [0, 129]),
    (2, 4, 2, 200, 128, 64, [0, 70]),  # Dv below D
])
def test_prefill_kernel_edges_and_repeats(dev, dtype, B, H, Hkv, S, D, Dv, pads):
    """The bf16 kernel's tile schedule at its edges (dead tiles skipped from
    the pad's tile, full walks for fully masked rows, ragged tiles, padded
    head dims), the f32 body at the same shapes; two launches bit-equal."""
    rng = np.random.default_rng(S + D + Dv)
    q = _randn(rng, B, H, S, D, std=0.5).to(dev, dtype)
    k = _randn(rng, B, Hkv, S, D, std=0.5).to(dev, dtype)
    v = _randn(rng, B, Hkv, S, Dv).to(dev, dtype)
    pad = torch.tensor(pads, dtype=torch.int32, device=dev)
    before = K.flash_prefill_attention.launches
    got = K.flash_prefill_attention(q, k, v, pad, scale=D ** -0.5)
    again = K.flash_prefill_attention(q, k, v, pad, scale=D ** -0.5)
    assert K.flash_prefill_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == (B, S, H * Dv)
    assert torch.equal(got, again)
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
@pytest.mark.parametrize("NH,NKV,D", [(10, 10, 128), (8, 2, 16), (4, 4, 8)])
def test_slot_decode_kernel_split_edges_and_repeats(dev, kind, NH, NKV, D):
    """Rows that end on either side of a split boundary (splits of
    _lib.DECODE_SPLIT positions), a row of one position, a full row; two
    launches bit-equal."""
    from dsocr_tpu_torch.ops.kernels import _lib

    n = _lib.DECODE_SPLIT
    rng = np.random.default_rng(NH + D)
    S = 2 * n + 88
    lengths = torch.tensor([0, n - 2, n - 1, n, n + 1, 2 * n - 1, 2 * n, S - 1], dtype=torch.int32)
    B = len(lengths)
    caches = _slot_caches(rng, 2, B, NKV, S, D, kind, dev)
    lengths = lengths.to(dev)
    for q_dtype in (torch.float32, torch.bfloat16):
        q = _randn(rng, B, NH, 1, D).to(dev, q_dtype)
        before = K.slot_decode_attention.launches
        got = K.slot_decode_attention(q, *caches, 1, lengths, scale=D ** -0.5)
        again = K.slot_decode_attention(q, *caches, 1, lengths, scale=D ** -0.5)
        assert K.slot_decode_attention.launches == before + 2
        assert got.dtype == q_dtype and torch.equal(got, again)
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


# The writes from the decoder's token (csrc/kv_attention.cuh, quantized or
# converted in the kernel) against their twins on the CPU tensors' copies:
# quantize_kv_int8 (or the cast) and the plain write, bit for bit, ties and
# an all-zero row included (chip_smoke.kv_tokens).
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("token", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [128, 64])
def test_slot_kv_write_kernel_bit_exact(dev, kind, token, D):
    import chip_smoke

    rng = np.random.default_rng(D + len(kind))
    L, B, NKV, S = 3, 5, 2, 64
    caches = _slot_caches(rng, L, B, NKV, S, D, kind, dev)
    twins = [None if c is None else c.cpu() for c in caches]
    k, v = chip_smoke.kv_tokens(torch, _randn(rng, B, 1, 3 * NKV * D).to(dev, token), NKV, D)
    lengths = torch.tensor([0, S - 1, 9, S, 30], dtype=torch.int32, device=dev)  # S: dropped
    before = K.slot_kv_write.launches
    K.slot_kv_write(*caches, k, v, 2, lengths)
    assert K.slot_kv_write.launches == before + 1
    K.slot_kv_write_plain(*twins, k.cpu(), v.cpu(), 2, lengths.cpu())
    for got, want in zip(caches, twins):
        assert got is None or torch.equal(got.cpu(), want)


def test_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros((1, 2, 64, 8), device=dev)
    with pytest.raises(ValueError):  # mixed devices
        K.flash_prefill_attention(q, q.cpu(), q, torch.zeros(1, dtype=torch.int32, device=dev), scale=1.0)
    with pytest.raises(ValueError):  # int64 pad_start
        K.flash_prefill_attention(q, q, q, torch.zeros(1, dtype=torch.int64, device=dev), scale=1.0)
    # the row matmuls: x 2 bytes past a 16-byte boundary (TMA and the GEMV's
    # 16-byte loads cannot take it), at the GEMV's N and the GEMM's
    for method, fn in (("q8_0", K.q8_matmul), ("q4_k", K.q4k_matmul), ("q6_k", K.q6k_matmul)):
        packed = _row_packed(np.random.default_rng(0), method, (), 256, 64, dev)
        for n in (16, 64):
            x = torch.zeros(n * 256 + 1, dtype=torch.bfloat16, device=dev)[1:].view(n, 256)
            with pytest.raises(ValueError, match="16-byte"):
                fn(x, *packed)


# -- Q8_0 dequantize-matmul ------------------------------------------------------


def _q8_weights(rng, lead, k, m, in_major):
    """Packed weights of a random float [*lead, k, m] stack (the quantizer
    makes the f16-origin scales the kernels assume)."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    w = _randn(rng, *lead, k, m, std=k ** -0.5)
    packed = (quantize_expert_stack if in_major else quantize_plain)(w)
    return packed["codes"], packed["scales"]


def _q8_close(got, want, bound):
    """bound = |bf16 x| @ |W|, the largest sum of term magnitudes."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(bound.max())


def _abs_bound(x, w):
    return torch.matmul(x.to(torch.bfloat16).float().abs(), w.abs())


# The row matmuls (csrc/row_matmul.cu): the main path's K and M (qkv, o and
# shared down) at N 1 and 16 (the GEMV) and 17, 300, 1024 (the dequant pass
# and the wgmma GEMM), and the lm_head at N 16
_ROW_MAIN = [(n, k, m) for n in (1, 16, 17, 300, 1024) for k, m in ((1280, 3840), (1792, 1280))]
_ROW_MAIN += [(16, 1280, 129280)]


def _row_cases(existing, tails):
    return existing + [c for c in _ROW_MAIN + tails if c not in existing]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m", _row_cases([(16, 1280, 3840), (3, 32, 96), (300, 96, 200), (17, 1792, 1280)],
                                             [(1, 32, 36), (16, 96, 36), (17, 32, 200), (1024, 96, 200)]))
def test_q8_matmul_kernel_matches_twin(dev, x_dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    codes, scales = (t.to(dev) for t in _q8_weights(rng, (), k, m, False))
    x = _randn(rng, n, k).to(dev, x_dtype)
    before = K.q8_matmul.launches
    got = K.q8_matmul(x, codes, scales)
    assert K.q8_matmul.launches == before + 1
    w = (codes.float() * scales.repeat_interleave(32, dim=1)).t()
    _q8_close(got, K.q8_matmul_plain(x, codes, scales), _abs_bound(x, w))



# The gather tier (csrc/expert_sweep.cu groups the selections by expert
# from idx in the kernel). idx kinds: "uniform" draws; "routed" as a router
# makes them, each token's top-6 distinct (6, 24 and 60 selections: one
# request's decode step, 4 serving slots, the largest gather launch);
# "shared", tokens that share one top-6, as identical requests route;
# "one", every selection on one expert (more than 8 rows: several n-tiles;
# more than 16: several passes over the expert); "oob", two indices
# outside [0, E), whose rows are zeros. `offset` moves x off a 16-byte
# boundary. Two launches must give the same bits.
def _gather_idx(rng, kind, n, e):
    if kind == "uniform":
        return rng.integers(0, e, size=n).astype(np.int32)
    if kind == "one":
        return np.full(n, e // 2, dtype=np.int32)
    if kind == "shared":
        return np.tile(rng.permutation(e)[:6], -(-n // 6))[:n].astype(np.int32)
    idx = np.concatenate([rng.permutation(e)[:6] for _ in range(-(-n // 6))])[:n].astype(np.int32)
    if kind == "oob":
        idx[[1, n // 2]] = [-1, e]
    return idx


def _check_gather(dev, fn, plain, packed, w, x_dtype, kind, n, offset, rng):
    """fn (a gather wrapper) against its twin; w the dequantized stack [E, K, M] f32."""
    e, k, _ = w.shape
    idx_np = _gather_idx(rng, kind, n, e)
    idx = torch.from_numpy(idx_np).to(dev)
    x = _randn(rng, n * k + offset).to(dev, x_dtype)[offset:].view(n, k)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = fn.launches
    got = fn(x, *packed, idx)
    assert fn.launches == before + 1
    assert torch.equal(got, fn(x, *packed, idx))
    live = torch.from_numpy((idx_np >= 0) & (idx_np < e)).to(dev)
    safe = torch.where(live, idx, torch.zeros_like(idx))
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    bound = torch.bmm(x.to(torch.bfloat16).float().abs()[:, None], w[safe.long()].abs())[:, 0]
    _q8_close(got[live], plain(x, *packed, safe)[live], bound[live])


# (kind, e, n, k, m, offset) for K a multiple of `k_unit`: uniform draws at
# the earlier (e, n, k, m) cases, the full-width stacks (gate+up 1280 →
# 1792; down 896 → 1280, for the K-quants the stand-in 1792 → 1280) at 6,
# 24 and 60 routed selections and at 24 and 60 that share one top-6, then
# small stacks
def _gather_cases(k_unit):
    down_k = 896 if k_unit == 32 else 1792
    earlier = ([(64, 60, 1280, 1792), (64, 24, 896, 1280), (4, 5, 32, 64), (3, 7, 96, 36)] if k_unit == 32
               else [(64, 60, 1280, 1792), (4, 5, 256, 64), (3, 7, 512, 36)])
    return [("uniform", *case, 0) for case in earlier] + [
        ("routed", 64, n, k, m, 0) for n in (6, 24, 60) for k, m in ((1280, 1792), (down_k, 1280))] + [
        ("shared", 64, n, k, m, 0) for n in (24, 60) for k, m in ((1280, 1792), (down_k, 1280))] + [
        ("one", 8, 12, 2 * k_unit, 36, 0), ("one", 8, 20, 256, 64, 0), ("one", 8, 60, 256, 128, 0),
        ("oob", 16, 24, 256, 128, 0), ("routed", 8, 4096, 256, 64, 0), ("routed", 8, 12, 256, 36, 1),
        ("routed", 64, 6, 1280, 1792, 1)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,e,n,k,m,offset", _gather_cases(32))
def test_q8_gather_kernel_matches_twin(dev, x_dtype, kind, e, n, k, m, offset):
    rng = np.random.default_rng(e + n + k)
    codes, scales = (t.to(dev) for t in _q8_weights(rng, (e,), k, m, True))
    w = codes.float() * scales.repeat_interleave(32, dim=1)
    _check_gather(dev, K.q8_gather_matmul, K.q8_gather_matmul_plain, (codes, scales), w, x_dtype, kind, n,
                  offset, rng)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,k,m", [(64, 16, 1280, 1792), (64, 16, 896, 1280), (4, 3, 32, 64), (5, 20, 64, 36),
                                     (4, 1, 96, 256), (3, 33, 128, 132)])
def test_q8_dense_expert_kernels_match_twins(dev, x_dtype, e, n, k, m):
    rng = np.random.default_rng(e * n + k)
    codes, scales = (t.to(dev) for t in _q8_weights(rng, (e,), k, m, True))
    w = codes.float() * scales.repeat_interleave(32, dim=1)
    x = _randn(rng, n, k).to(dev, x_dtype)
    before = K.q8_dense_experts.launches
    got = K.q8_dense_experts(x, codes, scales)
    assert K.q8_dense_experts.launches == before + 1
    assert torch.equal(got, K.q8_dense_experts(x, codes, scales))
    _q8_close(got, K.q8_dense_experts_plain(x, codes, scales), _abs_bound(x[None], w))
    xe = _randn(rng, e, n, k).to(dev, x_dtype)
    before = K.q8_dense_experts_perx.launches
    got = K.q8_dense_experts_perx(xe, codes, scales)
    assert K.q8_dense_experts_perx.launches == before + 1
    assert torch.equal(got, K.q8_dense_experts_perx(xe, codes, scales))
    _q8_close(got, K.q8_dense_experts_perx_plain(xe, codes, scales), _abs_bound(xe, w))


def test_q8_quantizer_on_card_is_bit_exact_with_cpu(dev):
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack

    rng = np.random.default_rng(9)
    w = _randn(rng, 8, 1280, 1792, std=1280 ** -0.5).to(torch.bfloat16)
    w[0, :32, :5] = 0.0  # all-zero blocks
    got = quantize_expert_stack(w.to(dev))
    want = quantize_expert_stack(w)
    assert torch.equal(got["codes"].cpu(), want["codes"])
    assert torch.equal(got["scales"].cpu(), want["scales"])


# -- Q4_K dequantize-matmul ------------------------------------------------------


def _q4k_weights(rng, lead, k, m, in_major, dev):
    """Packed weights of a random float [*lead, k, m] stack, packed on the
    card (the f16-origin scales and mins the kernels assume)."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    w = _randn(rng, *lead, k, m, std=k ** -0.5).to(dev)
    packed = (quantize_expert_stack if in_major else quantize_plain)(w, "q4_k")
    return packed["codes"], packed["scales"], packed["mins"]


def _q4k_deq(packed, dim):
    from dsocr_tpu_torch.ops.kernels.kquant_matmul import dequant_q4k

    return dequant_q4k(*packed, dim).float()


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m", _row_cases([(16, 1280, 3840), (3, 256, 96), (300, 512, 200), (17, 1792, 1280)],
                                             [(1, 256, 36), (16, 512, 200), (1024, 256, 36)]))
def test_q4k_matmul_kernel_matches_twin(dev, x_dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    packed = _q4k_weights(rng, (), k, m, False, dev)
    x = _randn(rng, n, k).to(dev, x_dtype)
    before = K.q4k_matmul.launches
    got = K.q4k_matmul(x, *packed)
    assert K.q4k_matmul.launches == before + 1
    _q8_close(got, K.q4k_matmul_plain(x, *packed), _abs_bound(x, _q4k_deq(packed, -1).t()))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,e,n,k,m,offset", _gather_cases(256))
def test_q4k_gather_kernel_matches_twin(dev, x_dtype, kind, e, n, k, m, offset):
    rng = np.random.default_rng(e + n + k)
    packed = _q4k_weights(rng, (e,), k, m, True, dev)
    _check_gather(dev, K.q4k_gather_matmul, K.q4k_gather_matmul_plain, packed, _q4k_deq(packed, -2), x_dtype,
                  kind, n, offset, rng)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,k,m", [(64, 16, 1280, 1792), (64, 16, 1792, 1280), (4, 3, 256, 64), (5, 20, 512, 36),
                                     (4, 1, 256, 256), (3, 33, 512, 132)])
def test_q4k_dense_expert_kernels_match_twins(dev, x_dtype, e, n, k, m):
    rng = np.random.default_rng(e * n + k)
    packed = _q4k_weights(rng, (e,), k, m, True, dev)
    w = _q4k_deq(packed, -2)
    x = _randn(rng, n, k).to(dev, x_dtype)
    before = K.q4k_dense_experts.launches
    got = K.q4k_dense_experts(x, *packed)
    assert K.q4k_dense_experts.launches == before + 1
    assert torch.equal(got, K.q4k_dense_experts(x, *packed))
    _q8_close(got, K.q4k_dense_experts_plain(x, *packed), _abs_bound(x[None], w))
    xe = _randn(rng, e, n, k).to(dev, x_dtype)
    before = K.q4k_dense_experts_perx.launches
    got = K.q4k_dense_experts_perx(xe, *packed)
    assert K.q4k_dense_experts_perx.launches == before + 1
    assert torch.equal(got, K.q4k_dense_experts_perx(xe, *packed))
    _q8_close(got, K.q4k_dense_experts_perx_plain(xe, *packed), _abs_bound(xe, w))


def test_q4k_wrappers_raise_on_bad_shapes(dev):
    packed = _q4k_weights(np.random.default_rng(1), (2,), 256, 64, True, dev)
    with pytest.raises(ValueError):  # K misses a 256-value super-block
        K.q4k_dense_experts(torch.zeros((3, 128), device=dev), *packed)
    with pytest.raises(ValueError):  # int64 idx
        K.q4k_gather_matmul(torch.zeros((3, 256), device=dev), *packed,
                            torch.zeros(3, dtype=torch.int64, device=dev))


def test_q4k_quantizer_on_card_is_bit_exact_with_cpu(dev):
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    rng = np.random.default_rng(9)
    w = _randn(rng, 8, 1280, 1792, std=1280 ** -0.5).to(torch.bfloat16)
    w[0, :32, :5] = 0.0  # all-zero sub-blocks
    w[1, :256, :3] = 0.5  # flat super-blocks: max scale 0
    for pack in (quantize_expert_stack, quantize_plain):
        got = pack(w.to(dev), "q4_k")
        want = pack(w, "q4_k")
        for key in ("codes", "scales", "mins"):
            assert torch.equal(got[key].cpu(), want[key]), key


# -- Q6_K dequantize-matmul ------------------------------------------------------


def _q6k_weights(rng, lead, k, m, in_major, dev):
    """Packed weights of a random float [*lead, k, m] stack, packed on the
    card: (codes, highs, scales)."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    w = _randn(rng, *lead, k, m, std=k ** -0.5).to(dev)
    packed = (quantize_expert_stack if in_major else quantize_plain)(w, "q6_k")
    return packed["codes"], packed["highs"], packed["scales"]


def _q6k_deq(packed, dim):
    from dsocr_tpu_torch.ops.kernels.kquant_matmul import dequant_q6k

    return dequant_q6k(*packed, dim).float()


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m", _row_cases([(16, 1280, 3840), (3, 256, 96), (300, 512, 200), (17, 1792, 1280)],
                                             [(1, 256, 36), (16, 512, 200), (1024, 256, 36)]))
def test_q6k_matmul_kernel_matches_twin(dev, x_dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    packed = _q6k_weights(rng, (), k, m, False, dev)
    x = _randn(rng, n, k).to(dev, x_dtype)
    before = K.q6k_matmul.launches
    got = K.q6k_matmul(x, *packed)
    assert K.q6k_matmul.launches == before + 1
    _q8_close(got, K.q6k_matmul_plain(x, *packed), _abs_bound(x, _q6k_deq(packed, -1).t()))


# -- the row matmuls of all three formats (csrc/row_matmul.cu) ------------------------


def _row_packed(rng, method, lead, k, m, dev):
    """Row-layout packed weights of a random float [*lead, k, m] stack:
    [*lead, M, ..] parts in the kernel's argument order."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_plain

    keys = {"q8_0": ("codes", "scales"), "q4_k": ("codes", "scales", "mins"),
            "q6_k": ("codes", "highs", "scales")}[method]
    w = _randn(rng, *lead, k, m, std=k ** -0.5).to(dev)
    packed = quantize_plain(w, method)
    return tuple(packed[key] for key in keys)


def _row_fns(method):
    fmt = {"q8_0": "q8", "q4_k": "q4k", "q6_k": "q6k"}[method]
    return getattr(K, f"{fmt}_matmul"), getattr(K, f"{fmt}_matmul_plain")


def _row_weight(method, packed):
    """f32 [M, K] holding each weight's bf16 value, from the twin's dequant."""
    from dsocr_tpu_torch.ops.kernels.dequant_matmul import _dequant_rows
    from dsocr_tpu_torch.ops.kernels.kquant_matmul import dequant_q4k, dequant_q6k

    if method == "q8_0":
        return _dequant_rows(*packed)
    return (dequant_q4k if method == "q4_k" else dequant_q6k)(*packed, -1).float()


@pytest.mark.parametrize("method", ["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("n", [16, 1024])
def test_row_matmul_repeats_and_dequants_bit_exact(dev, method, n):
    """Two launches give the same bits (GEMV at N 16, dequant pass + GEMM at
    N 1024), and x = rows of the identity reads the weights back exactly:
    1 · w plus zeros is exact in any order, so the kernels' weights equal
    the twin's dequant (_dequant_rows, dequant_q4k, dequant_q6k) bit for
    bit, in the GEMV's permuted K slots and through the dequant pass."""
    fn, _ = _row_fns(method)
    k, m = 1280, 1280
    packed = _row_packed(np.random.default_rng(n), method, (), k, m, dev)
    x = _randn(np.random.default_rng(1), n, k).to(dev, torch.bfloat16)
    got = fn(x, *packed)
    assert torch.equal(got, fn(x, *packed))
    w = _row_weight(method, packed)
    for r0 in range(0, k, n):  # every K column once
        eye = torch.eye(k, device=dev, dtype=torch.bfloat16)[r0 : r0 + n]
        assert torch.equal(fn(eye, *packed), w.t()[r0 : r0 + n])


@pytest.mark.parametrize("method", ["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 16, 300])
def test_row_matmul_on_a_layer_view(dev, method, x_dtype, n):
    """W[layer] of a [L, M, K] stack at layer 1: a view, no copy."""
    fn, plain = _row_fns(method)
    stack = _row_packed(np.random.default_rng(n), method, (3,), 1280, 1280, dev)
    layer = tuple(t[1] for t in stack)
    assert all(t.data_ptr() == s.data_ptr() + s.stride(0) * s.element_size() for t, s in zip(layer, stack))
    x = _randn(np.random.default_rng(2), n, 1280).to(dev, x_dtype)
    _q8_close(fn(x, *layer), plain(x, *layer), _abs_bound(x, _row_weight(method, layer).t()))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,e,n,k,m,offset", _gather_cases(256))
def test_q6k_gather_kernel_matches_twin(dev, x_dtype, kind, e, n, k, m, offset):
    rng = np.random.default_rng(e + n + k)
    packed = _q6k_weights(rng, (e,), k, m, True, dev)
    _check_gather(dev, K.q6k_gather_matmul, K.q6k_gather_matmul_plain, packed, _q6k_deq(packed, -2), x_dtype,
                  kind, n, offset, rng)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,k,m", [(64, 16, 1280, 1792), (64, 16, 1792, 1280), (4, 3, 256, 64), (5, 20, 512, 36),
                                     (4, 1, 256, 256), (3, 33, 512, 132)])
def test_q6k_dense_expert_kernels_match_twins(dev, x_dtype, e, n, k, m):
    rng = np.random.default_rng(e * n + k)
    packed = _q6k_weights(rng, (e,), k, m, True, dev)
    w = _q6k_deq(packed, -2)
    x = _randn(rng, n, k).to(dev, x_dtype)
    before = K.q6k_dense_experts.launches
    got = K.q6k_dense_experts(x, *packed)
    assert K.q6k_dense_experts.launches == before + 1
    assert torch.equal(got, K.q6k_dense_experts(x, *packed))
    _q8_close(got, K.q6k_dense_experts_plain(x, *packed), _abs_bound(x[None], w))
    xe = _randn(rng, e, n, k).to(dev, x_dtype)
    before = K.q6k_dense_experts_perx.launches
    got = K.q6k_dense_experts_perx(xe, *packed)
    assert K.q6k_dense_experts_perx.launches == before + 1
    assert torch.equal(got, K.q6k_dense_experts_perx(xe, *packed))
    _q8_close(got, K.q6k_dense_experts_perx_plain(xe, *packed), _abs_bound(xe, w))


def test_q6k_wrappers_raise_on_bad_shapes(dev):
    packed = _q6k_weights(np.random.default_rng(1), (2,), 256, 64, True, dev)
    with pytest.raises(ValueError):  # K misses a 256-value super-block
        K.q6k_dense_experts(torch.zeros((3, 128), device=dev), *packed)
    with pytest.raises(ValueError):  # highs in the place of scales
        K.q6k_dense_experts(torch.zeros((3, 256), device=dev), packed[0], packed[2], packed[1])
    with pytest.raises(ValueError):  # int64 idx
        K.q6k_gather_matmul(torch.zeros((3, 256), device=dev), *packed,
                            torch.zeros(3, dtype=torch.int64, device=dev))


def test_q6k_quantizer_on_card_is_bit_exact_with_cpu(dev):
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    rng = np.random.default_rng(9)
    w = _randn(rng, 8, 1280, 1792, std=1280 ** -0.5).to(torch.bfloat16)
    w[0, :256, :5] = 0.0  # dead super-blocks
    w[1, :16, :3] = 1e-20  # near-zero sub-blocks: their 8-bit scales round to 0
    for pack in (quantize_expert_stack, quantize_plain):
        got = pack(w.to(dev), "q6_k")
        want = pack(w, "q6_k")
        for key in ("codes", "highs", "scales"):
            assert torch.equal(got[key].cpu(), want[key]), key


# -- paged KV and the megafused Q8_0 expert chain ------------------------------------


def _paged_pools(rng, L, P, NKV, page, D, kind, dev):
    return _slot_caches(rng, L, P, NKV, page, D, kind, dev)  # [L, P, NKV, page(, D)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_paged_kv_update_kernel_bit_exact(dev, kind):
    rng = np.random.default_rng(7)
    L, P, NKV, page, D, P_max = 3, 9, 2, 16, 128, 2
    pools = _paged_pools(rng, L, P, NKV, page, D, kind, dev)
    twins = [None if c is None else c.clone() for c in pools]
    new = [None if c is None else c[0, :5, :, 3].contiguous() for c in pools]  # [B = 5, NKV(, D)]
    tables = torch.tensor([[4, 1], [0, 7], [-1, -1], [2, -1], [8, 3]], dtype=torch.int32, device=dev)
    # a page, the second page, no page, one past the last page, past the table
    lengths = torch.tensor([3, page + 5, 0, page, page * P_max], dtype=torch.int32, device=dev)
    before = K.paged_kv_update.launches
    K.paged_kv_update(*pools, *new, tables, lengths, 1)
    assert K.paged_kv_update.launches == before + 1
    K.paged_kv_update_plain(*twins, *new, tables, lengths, 1)
    for got, want in zip(pools, twins):
        assert got is None or torch.equal(got, want)


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("token", [torch.bfloat16, torch.float32])
def test_paged_kv_write_kernel_bit_exact(dev, kind, token):
    import chip_smoke

    rng = np.random.default_rng(11 + len(kind))
    L, P, NKV, page, D, P_max = 3, 9, 2, 16, 128, 2
    pools = _paged_pools(rng, L, P, NKV, page, D, kind, dev)
    twins = [None if c is None else c.cpu() for c in pools]
    k, v = chip_smoke.kv_tokens(torch, _randn(rng, 5, 1, 3 * NKV * D).to(dev, token), NKV, D)
    tables = torch.tensor([[4, 1], [0, 7], [2, -1], [-1, -1], [8, 3]], dtype=torch.int32, device=dev)
    # a page, the second page, a page, no page, past the table
    lengths = torch.tensor([3, page + 5, 0, 0, page * P_max], dtype=torch.int32, device=dev)
    before = K.paged_kv_write.launches
    K.paged_kv_write(*pools, k, v, tables, lengths, 1)
    assert K.paged_kv_write.launches == before + 1
    K.paged_kv_write_plain(*twins, k.cpu(), v.cpu(), tables.cpu(), lengths.cpu(), 1)
    for got, want in zip(pools, twins):
        assert got is None or torch.equal(got.cpu(), want)


def test_quantize_kv_int8_on_card_is_bit_exact_with_cpu(dev):
    """The join-time quantizer (and the write kernels' twin) on CUDA
    tensors: PyTorch's CUDA division by a Python number would multiply by
    its reciprocal; the port divides by a tensor, as the CPU and the
    reference do."""
    from dsocr_tpu_torch.ops.attention import quantize_kv_int8

    x = _randn(np.random.default_rng(8), 512, 10, 128)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        codes, scales = quantize_kv_int8(xd.to(dev))
        want_codes, want_scales = quantize_kv_int8(xd)
        assert torch.equal(codes.cpu(), want_codes) and torch.equal(scales.cpu(), want_scales)


def test_kv_write_wrappers_raise_on_bad_inputs(dev):
    rng = np.random.default_rng(4)
    caches = _slot_caches(rng, 1, 2, 2, 8, 256, "int8", dev)
    token = torch.zeros((2, 2, 1, 256), device=dev)
    lengths = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="128"):  # the quantizing write holds D ≤ 128 in a warp
        K.slot_kv_write(*caches, token, token, 0, lengths)
    caches = _slot_caches(rng, 1, 2, 2, 8, 16, "int8", dev)
    codes = torch.zeros((2, 2, 1, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # the token comes unquantized
        K.slot_kv_write(*caches, codes, codes, 0, lengths)
    pools = _paged_pools(rng, 1, 3, 2, 8, 16, "bf16", dev)
    with pytest.raises(ValueError):  # scale planes without an int8 pool
        K.paged_kv_write(pools[0], pools[1], caches[2][0], caches[3][0], token[..., :16], token[..., :16],
                         torch.zeros((2, 1), dtype=torch.int32, device=dev), lengths, 0)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("B,NH,NKV,D,page,P_max", [(5, 10, 10, 128, 128, 3), (4, 8, 2, 16, 8, 5)])
def test_paged_decode_kernel_matches_twin(dev, kind, B, NH, NKV, D, page, P_max):
    rng = np.random.default_rng(B * 7 + D)
    P = B * P_max + 2
    pools = _paged_pools(rng, 2, P, NKV, page, D, kind, dev)
    tables = torch.from_numpy(rng.permutation(P)[: B * P_max].reshape(B, P_max).astype(np.int32))
    tables[1] = -1  # a row that holds no page: zeros
    lengths = torch.from_numpy(rng.integers(0, page * P_max, size=B).astype(np.int32))
    lengths[0], lengths[-1] = page * P_max - 1, 0
    tables, lengths = tables.to(dev), lengths.to(dev)
    if kind != "int8":  # what no row attends must not reach the output
        used = torch.zeros(P, page, dtype=torch.bool)
        for b in range(B):
            for t in range(int(lengths[b]) + 1):
                if tables[b, t // page] >= 0:
                    used[tables[b, t // page], t % page] = True
        for pool in pools[:2]:
            pool[1].transpose(1, 2)[~used.to(dev)] = float("nan")  # [P, page, NKV, D]
    q = _randn(rng, B, NH, D).to(dev)
    got = K.paged_decode_attention(q, *pools, tables, lengths, 1, scale=D ** -0.5)
    assert got.dtype == torch.float32 and got.shape == (B, NH * D)
    assert torch.isfinite(got).all() and torch.equal(got[1], torch.zeros_like(got[1]))
    _close(got, K.paged_decode_attention_plain(q, *pools, tables, lengths, 1, scale=D ** -0.5))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("page,NH,NKV,D", [(8, 4, 2, 16), (16, 10, 10, 128), (128, 4, 4, 8)])
def test_paged_decode_kernel_split_edges_and_repeats(dev, kind, page, NH, NKV, D):
    """Pages smaller than a split (a split's tiles end at page boundaries),
    rows ending on either side of a split boundary, a page missing in the
    middle of a row; two launches bit-equal."""
    from dsocr_tpu_torch.ops.kernels import _lib

    n = _lib.DECODE_SPLIT
    rng = np.random.default_rng(page + D)
    P_max = -(-(2 * n + 100) // page)
    lengths = torch.tensor([0, n - 2, n - 1, n, n + 1, P_max * page - 1], dtype=torch.int32)
    B = len(lengths)
    P = B * P_max
    pools = _paged_pools(rng, 2, P, NKV, page, D, kind, dev)
    tables = torch.from_numpy(rng.permutation(P).reshape(B, P_max).astype(np.int32))
    tables[5, 1] = -1  # no page holds positions [page, 2 page) of the last row
    tables, lengths = tables.to(dev), lengths.to(dev)
    q = _randn(rng, B, NH, D).to(dev)
    before = K.paged_decode_attention.launches
    got = K.paged_decode_attention(q, *pools, tables, lengths, 1, scale=D ** -0.5)
    again = K.paged_decode_attention(q, *pools, tables, lengths, 1, scale=D ** -0.5)
    assert K.paged_decode_attention.launches == before + 2
    assert torch.equal(got, again)
    _close(got, K.paged_decode_attention_plain(q, *pools, tables, lengths, 1, scale=D ** -0.5))


def _megafused_close(got, want, x, w, gu, dn):
    import chip_smoke

    tol = chip_smoke.megafused_tol(torch, x, w, *gu, *dn)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,h,mi", [(64, 16, 1280, 896), (64, 11, 1280, 896), (64, 32, 1280, 896),
                                      (4, 16, 768, 256), (4, 4, 32, 32), (5, 20, 64, 96), (3, 9, 96, 448),
                                      (8, 32, 256, 128)])
def test_q8_megafused_kernel_matches_twin_and_repeats(dev, x_dtype, e, n, h, mi):
    rng = np.random.default_rng(e + n + h + mi)
    gu = tuple(t.to(dev) for t in _q8_weights(rng, (e,), h, 2 * mi, True))
    dn = tuple(t.to(dev) for t in _q8_weights(rng, (e,), mi, h, True))
    x = _randn(rng, n, h).to(dev, x_dtype)
    w = torch.from_numpy(rng.random((e, n)).astype(np.float32) * (rng.random((e, n)) < 0.4)).to(dev)
    before = K.q8_moe_megafused.launches
    got = K.q8_moe_megafused(x, w, *gu, *dn)
    again = K.q8_moe_megafused(x, w, *gu, *dn)
    assert K.q8_moe_megafused.launches == before + 2
    assert torch.equal(got, again)  # expert order fixed: the same bits every launch
    _megafused_close(got, K.q8_moe_megafused_plain(x, w, *gu, *dn), x, w, gu, dn)


def test_new_wrappers_raise_on_bad_inputs(dev):
    x = torch.zeros((40, 64), device=dev)  # N > 32
    gu = tuple(t.to(dev) for t in _q8_weights(np.random.default_rng(0), (2,), 64, 64, True))
    dn = tuple(t.to(dev) for t in _q8_weights(np.random.default_rng(1), (2,), 32, 64, True))
    with pytest.raises(ValueError):
        K.q8_moe_megafused(x, torch.zeros((2, 40), device=dev), *gu, *dn)
    pools = _paged_pools(np.random.default_rng(2), 1, 3, 2, 8, 16, "f32", dev)
    q = torch.zeros((2, 4, 16), device=dev, dtype=torch.bfloat16)  # the attend takes f32 q
    tables = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        K.paged_decode_attention(q, *pools, tables, tables[:, 0], 0, scale=1.0)


# -- gather_matmul (the split layout's expert gather) ---------------------------------


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,h,i", [(64, 12, 1280, 896), (64, 96, 896, 1280), (8, 7, 64, 48),
                                     (3, 5, 3000, 130)])
def test_gather_matmul_kernel_matches_twin_and_repeats(dev, x_dtype, w_dtype, e, n, h, i):
    """Repeated experts, an I that is no multiple of 128, an H longer than
    the kernel's x staging, and an index outside [0, E): a zero row.
    Tolerance 1e-5 · max(|x| @ |W|): f32 sums in another order."""
    rng = np.random.default_rng(e + n + h + i)
    x = _randn(rng, n, h).to(dev, x_dtype)
    w = _randn(rng, e, h, i, std=h ** -0.5).to(dev, w_dtype)
    idx = torch.from_numpy(rng.integers(0, min(e, 5), size=n).astype(np.int32)).to(dev)
    idx[-1] = e  # outside the stack
    before = K.gather_matmul.launches
    got = K.gather_matmul(x, w, idx)
    again = K.gather_matmul(x, w, idx)
    assert K.gather_matmul.launches == before + 2
    assert torch.equal(got, again)  # a fixed summation order: the same bits every launch
    want = K.gather_matmul_plain(x, w, idx)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    bound = torch.bmm(x.float().abs()[:, None], w[idx.long().clamp(max=e - 1)].float().abs())[:, 0]
    assert float((got - want).abs().max()) <= 1e-5 * float(bound.max())


def test_gather_matmul_raises_on_bad_inputs(dev):
    x = torch.zeros((4, 32), device=dev)
    w = torch.zeros((3, 32, 48), device=dev)
    idx = torch.zeros((4,), dtype=torch.int32, device=dev)
    for bad in ((x[:, :16], w, idx), (x, w, idx.long()), (x, w.to(torch.float16), idx),
                (x, w.transpose(1, 2), idx), (x, w[0], idx)):
        with pytest.raises(ValueError):
            K.gather_matmul(*bad)


@pytest.mark.parametrize("method", ["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_dense_sweeps_take_x_off_a_16_byte_boundary(dev, method, x_dtype):
    """x one element past a 16-byte boundary (a view): the sweep copies it
    with plain loads instead of cp.async; the twin within tolerance, two
    launches bit-equal."""
    rng = np.random.default_rng(7)
    e, n, k, m = 4, 16, 256, 128
    if method == "q8_0":
        codes, scales = (t.to(dev) for t in _q8_weights(rng, (e,), k, m, True))
        packed = (codes, scales)
        w = codes.float() * scales.repeat_interleave(32, dim=1)
    elif method == "q4_k":
        packed = _q4k_weights(rng, (e,), k, m, True, dev)
        w = _q4k_deq(packed, -2)
    else:
        packed = _q6k_weights(rng, (e,), k, m, True, dev)
        w = _q6k_deq(packed, -2)
    fmt = method.replace("_", "").replace("q80", "q8")
    dense, perx = getattr(K, f"{fmt}_dense_experts"), getattr(K, f"{fmt}_dense_experts_perx")
    x = torch.zeros(n * k + 1, dtype=x_dtype, device=dev)[1:].view(n, k)
    x.copy_(_randn(rng, n, k).to(dev, x_dtype))
    got = dense(x, *packed)
    assert torch.equal(got, dense(x, *packed))
    _q8_close(got, getattr(K, f"{fmt}_dense_experts_plain")(x, *packed), _abs_bound(x[None], w))
    xe = torch.zeros(e * n * k + 1, dtype=x_dtype, device=dev)[1:].view(e, n, k)
    xe.copy_(_randn(rng, e, n, k).to(dev, x_dtype))
    got = perx(xe, *packed)
    assert torch.equal(got, perx(xe, *packed))
    _q8_close(got, getattr(K, f"{fmt}_dense_experts_perx_plain")(xe, *packed), _abs_bound(xe, w))


# DotsOCR's and GLM-OCR's decoders: 12 query heads over 2 KV heads (ratio
# 6) and 16 over 8 (ratio 2), D 128, the prefill with left pads and the
# slot step's write and attend; two launches bit-equal.
@pytest.mark.parametrize("H,Hkv", [(12, 2), (16, 8)])
@pytest.mark.parametrize("B,S,pads", [(1, 700, [0]), (3, 517, [0, 130, 516])])
def test_prefill_kernel_at_the_new_head_ratios(dev, H, Hkv, B, S, pads):
    rng = np.random.default_rng(H * S)
    q = _randn(rng, B, H, S, 128, std=0.5).to(dev, torch.bfloat16)
    k = _randn(rng, B, Hkv, S, 128, std=0.5).to(dev, torch.bfloat16)
    v = _randn(rng, B, Hkv, S, 128).to(dev, torch.bfloat16)
    pad = torch.tensor(pads, dtype=torch.int32, device=dev)
    got = K.flash_prefill_attention(q, k, v, pad, scale=128 ** -0.5)
    assert torch.equal(got, K.flash_prefill_attention(q, k, v, pad, scale=128 ** -0.5))
    _close(got, K.flash_prefill_attention_plain(q, k, v, pad, scale=128 ** -0.5))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("NH,NKV,L", [(12, 2, 28), (16, 8, 24)])
def test_slot_write_and_attend_at_the_new_head_ratios(dev, kind, NH, NKV, L):
    import chip_smoke

    rng = np.random.default_rng(NH + NKV)
    B, S, D = 16, 600, 128
    caches = _slot_caches(rng, L, B, NKV, S, D, kind, dev)
    twins = [None if c is None else c.clone() for c in caches]
    lengths = torch.from_numpy(rng.integers(0, S - 1, size=B).astype(np.int32))
    lengths[0], lengths[1] = 0, S - 1
    lengths = lengths.to(dev)
    k, v = chip_smoke.kv_tokens(torch, _randn(rng, B, 1, 3 * NKV * D).to(dev, torch.bfloat16), NKV, D)
    K.slot_kv_write(*caches, k, v, L - 1, lengths)
    K.slot_kv_write_plain(*twins, k, v, L - 1, lengths)
    assert all(a is None or torch.equal(a, b) for a, b in zip(caches, twins))
    q = _randn(rng, B, NH, 1, D).to(dev, torch.bfloat16)
    got = K.slot_decode_attention(q, *caches, L - 1, lengths, scale=D ** -0.5)
    assert torch.equal(got, K.slot_decode_attention(q, *caches, L - 1, lengths, scale=D ** -0.5))
    _close(got, K.slot_decode_attention_plain(q, *caches, L - 1, lengths, scale=D ** -0.5))


# DotsOCR's packed linears: qkv 1536 → 2048 and down 8960 → 1536 (35
# K-quant super-blocks, an odd count) at the GEMV's N 1 and 16 and the
# GEMM's 1024, and the untied lm_head 1536 → 151936 at one row.
@pytest.mark.parametrize("method", ["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("n,k,m", [(n, k, m) for n in (1, 16, 1024) for k, m in ((1536, 2048), (8960, 1536))]
                         + [(1, 1536, 151936)])
def test_row_matmul_at_the_dots_shapes(dev, method, n, k, m):
    fn, plain = _row_fns(method)
    packed = _row_packed(np.random.default_rng(n + k), method, (), k, m, dev)
    x = _randn(np.random.default_rng(2), n, k).to(dev, torch.bfloat16)
    got = fn(x, *packed)
    assert torch.equal(got, fn(x, *packed))
    want = plain(x, *packed)
    bound = _abs_bound(x, _row_weight(method, packed).t())
    assert float((got - want).abs().max()) <= 1e-5 * float(bound.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_attention_on_the_card_matches_the_cpu(dev, dtype):
    """The towers' frame attention: SDPA on the fused backends on the card
    against the CPU's plain attention, frames of mixed lengths."""
    from dsocr_tpu_torch.ops.packed_attention import segment_attention

    rng = np.random.default_rng(0)
    seg = np.repeat(np.arange(4), [300, 128, 300, 77])
    q, k, v = (_randn(rng, len(seg), 4, 128) for _ in range(3))
    want = segment_attention(q.to(dtype), k.to(dtype), v.to(dtype), seg)
    got = segment_attention(*(t.to(dev, dtype) for t in (q, k, v)), seg)
    assert got.dtype == dtype
    _close(got.cpu(), want)
