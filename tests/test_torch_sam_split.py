"""The SAM attention kernel's 3xTF32 arithmetic (csrc/sam_attention.cu),
emulated in torch on the CPU, against the reference's Pallas kernel in
interpret mode.

The kernel splits every f32 operand x into hi = tf32(x) and lo =
tf32(x - hi), rounding to nearest with ties away from zero (cvt.rna), and
computes a product as lo·hi + hi·lo + hi·hi with f32 sums. A product of two
TF32 values (11 significant bits each) is exact in f32, so torch's f32
matmul of the split parts gives the tensor cores' products; the f32 sums
differ in order, and on the card they round toward zero, which the kernel
confines to one tile's sums (each tile's P·V in fresh accumulators, merged
by FFMA), as the emulation's per-tile matmuls are. The emulation also
follows the kernel's online softmax over key tiles of 64 in log2 units (q
and the bias scaled by log2 e).

Tolerance against the Pallas kernel: atol = rtol = 1e-5 at the main
path's magnitudes, the one the port's plain twin meets
(tests/test_torch_kernels.py). hi + lo is within 2^-22 of x and lo·lo is
dropped, so a product is within about 3·2^-22 of its f32 value, and a
score's error grows with Σ|q·k|: at scores of large magnitude (q std 1,
bias std 3, Σ|q·k| ~ 50) the emulation reads up to 1.5e-5 from the
reference where the plain f32 twin reads 4e-6, so that case allows 4e-5,
still under the card's 1e-4. TF32 alone (hi·hi) misses 1e-4 by 50x,
which the second test shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.ops.pallas.sam_attention import sam_flash_attention as jax_sam

LOG2E = 1.4426950408889634
TILE = 64  # keys per tile (csrc/sam_attention.cu: SA_BK)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit operations: add half a TF32 ulp (bit 12) to
    the magnitude's bits and clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def emulate(q, k, v, bias_h, bias_w, width, mm=mm_3xtf32):
    """The kernel's arithmetic on [BH, S, D] f32 tensors."""
    s = q.shape[1]
    j = torch.arange(s)
    bias = (bias_h * LOG2E)[..., j // width] + (bias_w * LOG2E)[..., j % width]
    q2 = q * LOG2E
    m = torch.full(q.shape[:2], -torch.inf)
    l = torch.zeros(q.shape[:2])
    o = torch.zeros_like(q)
    for k0 in range(0, s, TILE):  # the last tile is ragged: its missing keys weigh 0
        sc = mm(q2, k[:, k0:k0 + TILE].transpose(1, 2)) + bias[..., k0:k0 + TILE]
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(sc - mx[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, v[:, k0:k0 + TILE])
        m = mx
    return o / l[..., None]


def _case(seed, BH, qh, qw, D, q_std, bias_std):
    rng = np.random.default_rng(seed)
    S = qh * qw
    q = (rng.normal(size=(BH, S, D)) * q_std).astype(np.float32)
    k = rng.normal(size=(BH, S, D)).astype(np.float32)
    v = rng.normal(size=(BH, S, D)).astype(np.float32)
    bh = (rng.normal(size=(BH, S, qh)) * bias_std).astype(np.float32)
    bw = (rng.normal(size=(BH, S, qw)) * bias_std).astype(np.float32)
    return q, k, v, bh, bw


def _pallas(args, qw):
    return np.asarray(jax_sam(*map(jnp.asarray, args), width=qw, block_q=16, interpret=True))


@pytest.mark.parametrize("qh,qw,D,q_std,bias_std,tol", [
    (8, 8, 64, 0.125, 0.3, 1e-5),  # S 64: one key tile
    (5, 7, 16, 0.25, 0.3, 1e-5),  # S 35: one ragged tile
    (12, 12, 32, 64 ** -0.5, 0.3, 1e-5),  # S 144: tiles of 64 cross key rows of 12; ragged last
    (8, 8, 64, 1.0, 3.0, 4e-5),  # scores of large magnitude
    (2, 100, 64, 0.125, 0.3, 1e-5),  # S 200: a tile of 64 keys within one key row of 100
    (100, 2, 64, 0.125, 0.3, 1e-5),  # S 200: a tile spans 32 key rows of 2
])
def test_3xtf32_emulation_matches_pallas(qh, qw, D, q_std, bias_std, tol):
    args = _case(qh * 97 + D, 2, qh, qw, D, q_std, bias_std)
    got = emulate(*map(torch.from_numpy, args), width=qw)
    np.testing.assert_allclose(got.numpy(), _pallas(args, qw), atol=tol, rtol=tol)


def test_tf32_alone_misses_the_f32_tolerance():
    """One TF32 product per f32 product (about three decimal digits) is
    not the reference's function at the card's 1e-4; three are."""
    args = _case(5, 2, 8, 8, 64, 1.0, 3.0)
    want = _pallas(args, 8)
    tensors = list(map(torch.from_numpy, args))
    plain_tf32 = emulate(*tensors, width=8, mm=mm_tf32).numpy()
    split3 = emulate(*tensors, width=8).numpy()
    assert np.abs(plain_tf32 - want).max() > 1e-4
    assert np.abs(split3 - want).max() < 4e-5


def test_split_parts_are_tf32_and_rebuild_x():
    rng = np.random.default_rng(0)
    mags = 10.0 ** rng.uniform(-30, 30, size=100_000)
    x = torch.from_numpy((rng.choice([-1.0, 1.0], size=mags.size) * mags).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0  # low 13 bits clear
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()  # hi: within half a TF32 ulp
    rebuilt = hi.double() + lo.double()
    assert ((rebuilt - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


def test_tf32_rounding_ties_away_from_zero():
    one_up = 1.0 + 2.0 ** -10  # the next TF32 value above 1
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [one_up, -one_up]
    below = torch.tensor([1.0 + 2.0 ** -11 - 2.0 ** -23], dtype=torch.float32)
    assert tf32_rna(below).tolist() == [1.0]
    # a carry out of the mantissa moves the exponent: 2 - 2^-12 rounds to 2
    assert tf32_rna(torch.tensor([2.0 - 2.0 ** -12])).tolist() == [2.0]


def test_emulated_split_products_are_exact_in_f32():
    """hi·hi, hi·lo and lo·hi of TF32 parts need at most 22 significant
    bits, so an f32 product of them is exact (what the emulation relies on)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    (ah, al), (bh, bl) = split(a), split(b)
    for x, y in ((ah, bh), (ah, bl), (al, bh)):
        assert torch.equal((x * y).double(), x.double() * y.double())
