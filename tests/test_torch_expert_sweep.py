"""The expert sweep's fragment mapping (csrc/expert_sweep.cu over
csrc/expert_sweep.cuh), emulated in torch on the CPU, against the
reference's Pallas kernels in interpret mode: the dense sweeps, and the
gather tier's plan (gather_plan: the kernel's leader test, row lists and
n-tiles) on the same body.

The kernel cannot run here, so this file transcribes what it does with
each byte: a task (expert, slab of 128 · WN columns, 16 rows of x) walks
K in ring stages of BK rows; the copies place every 16-byte piece of a
code row at the XOR-swizzled position `piece` gives it, and x's pieces at
`x_piece`'s; chunk c of 16 K rows goes to warp c % WK, whose lane (g, t)
reads its code rows (K rows 4t .. 4t + 3 of the chunk, columns 16 g ..
16 g + 15), decodes each value with the kernel's bit operations, rounds
it to bf16 and packs mma.sync.m16n8k16 A fragments (tile j: rows g, g + 8
= the lane's columns 2j, 2j + 1; K rows 4t + i in slots 2t + i % 2 +
8 (i // 2)); its B fragment is x's 4 values at the same K rows. The
emulated mma places every fragment register in its matrix by the PTX
layout, multiplies, and hands each lane its C registers, which the
epilogue writes as the kernel does (float4s of 16 consecutive columns,
summed over the WK warps of a column in warp order). Constants (BK, WN,
WK) are read from the source, so the emulation follows the kernel's.

Tolerance against the Pallas kernels: 1e-5 of the largest sum of term
magnitudes (|bf16 x| @ |W|), the one the plain twins meet
(tests/test_torch_dequant.py): the weights and x are the reference's
bf16 values bit for bit and bf16 products are exact in f32, so only the
order of the f32 sums differs. A wrong lane, slot, swizzle or bit field
moves whole products and misses it by orders of magnitude.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.ops.pallas import dequant_matmul as jax_dq
from dsocr_tpu.ops.pallas import kquant_matmul as jax_kq
from dsocr_tpu_torch.dsq import serve_quant as sq

CSRC = pathlib.Path(__file__).resolve().parents[1] / "dsocr_tpu_torch" / "csrc"
SRC = CSRC / "expert_sweep.cu"  # the kernels; the body they share: expert_sweep.cuh


def _const(name, path=None):
    text = path.read_text() if path else SRC.read_text() + (CSRC / "expert_sweep.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BK, WN, WK = _const("BK"), _const("WN"), _const("WK")
BN = 128 * WN
CHUNKS = BK // 16
# each format's in-major planes: (name, K values a row holds, bytes a column holds)
PLANES = {
    "q8_0": (("codes", 1, 1), ("scales", 32, 4)),
    "q4_k": (("codes", 2, 1), ("scales", 32, 4), ("mins", 32, 4)),
    "q6_k": (("codes", 2, 1), ("highs", 4, 1), ("scales", 16, 4)),
}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("DSOCR_NO_NATIVE", "1")  # the NumPy quantizer, as the other K-quant tests
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def piece(r, kpr, cc):
    """csrc/expert_sweep.cu: piece — where piece cc of code row r sits."""
    return cc ^ (2 * (((r * kpr) >> 2) & 3))


def x_piece(esize, n, cc):
    """csrc/expert_sweep.cu: x_piece — where piece cc of x's row n sits."""
    return cc ^ (2 * (n & 3)) if esize == 2 else cc ^ (4 * (n & 1))


def _bytes(t):
    return t.contiguous().view(torch.uint8)


def _words(b):
    """[..., 16] bytes → [..., 4] little-endian 32-bit words (int64)."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], 4, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _stage_plane(plane, e, m0, k0, kpr, es, M, K):
    """The ring stage's bytes of one plane ([E, K/kpr, M] in-major) as the
    copies leave them: rows BK/kpr of BN·es bytes, byte planes swizzled,
    zeros past K and M."""
    rows = BK // kpr
    img = torch.zeros(rows, BN * es, dtype=torch.uint8)
    live_r = max(0, min(rows, (K - k0) // kpr))
    live_c = max(0, min(BN, M - m0))
    if live_r and live_c:
        src = _bytes(plane[e, k0 // kpr: k0 // kpr + live_r, m0: m0 + live_c])
        img[:live_r, : live_c * es] = src.reshape(live_r, live_c * es)
    if es == 1:
        r = torch.arange(rows)[:, None]
        cc = torch.arange(BN // 16)[None, :]
        at = piece(r, kpr, cc)
        out = torch.zeros_like(img).reshape(rows, BN // 16, 16)
        out[r.expand_as(at), at] = img.reshape(rows, BN // 16, 16)
        img = out.reshape(rows, BN)
    return img.reshape(-1)


def _stage_x(x_e, r0, k0, br, K):
    """x's stage: rows br of BK values in x's dtype, pieces swizzled, zeros
    past the rows and K."""
    es = x_e.element_size()
    xb = BK * es
    img = torch.zeros(br, xb, dtype=torch.uint8)
    rows = max(0, min(br, x_e.shape[0] - r0))
    cols = max(0, min(BK, K - k0))
    if rows and cols:
        img[:rows, : cols * es] = _bytes(x_e[r0: r0 + rows, k0: k0 + cols]).reshape(rows, cols * es)
    n = torch.arange(br)[:, None]
    cc = torch.arange(xb // 16)[None, :]
    out = torch.zeros(br, xb // 16, 16, dtype=torch.uint8)
    out[n.expand(br, xb // 16), x_piece(es, n, cc)] = img.reshape(br, xb // 16, 16)
    return out.reshape(-1)


G = torch.arange(8)[:, None]  # a lane's g (rows of the lane grid)
T = torch.arange(4)[None, :]  # its t


def _read16(img, row_bytes, rows, pieces):
    """16-byte reads: rows [8, 4, ...] and pieces broadcast with them."""
    off = rows * row_bytes + 16 * pieces
    return img[off[..., None] + torch.arange(16)]


def _lane_values(fmt, planes_img, c, wn):
    """Each lane's decoded weights of chunk c: [8 g, 4 t, 4 i, 16 j] f32,
    K row 16c + 4t + i, column 128 wn + 16 g + j, as Fmt<P>::load and
    Fmt<P>::value compute them: the codes brought to one byte a value
    (u[i][w], columns 4w .. 4w + 3), each byte permuted into the mantissa
    of 2^23 (quant_decode.cuh's arithmetic)."""
    cc = 8 * wn + G  # [8, 1]
    col = 128 * wn + 16 * G  # first column of the lane

    def f32_row(img, row):  # the lane's 16 floats of a row of an f32 plane
        off = row * BN * 4 + 4 * col  # [8, 1]
        return img[off + torch.arange(64)].contiguous().view(torch.float32).reshape(8, 1, 1, 16)

    def magic_bytes(u):  # u [8, 4, 4 i, 4 w] → [8, 4, 4, 16 j]: 2^23 + byte j % 4 of word j // 4
        j = torch.arange(16)
        byte = (u[..., j // 4] >> (8 * (j % 4))) & 0xFF
        return (0x4B000000 | byte).to(torch.int32).view(torch.float32)

    if fmt == "q8_0":
        codes, scales = planes_img
        r = 16 * c + 4 * T[..., None] + torch.arange(4)  # [1, 4, 4]
        u = _words(_read16(codes, BN, r.expand(8, 4, 4), piece(r, 1, cc[..., None]))) ^ 0x80808080
        return (magic_bytes(u) - 8388736.0) * f32_row(scales, c // 2)
    r = 8 * c + 2 * T[..., None] + torch.arange(2)  # byte rows 2t, 2t + 1
    q = _words(_read16(planes_img[0], BN, r.expand(8, 4, 2), piece(r, 2, cc[..., None])))  # [8, 4, 2 h, 4 w]
    u = torch.stack([q[:, :, 0] & 0x0F0F0F0F, (q[:, :, 0] >> 4) & 0x0F0F0F0F,
                     q[:, :, 1] & 0x0F0F0F0F, (q[:, :, 1] >> 4) & 0x0F0F0F0F], dim=2)  # K rows 4t + i
    if fmt == "q4_k":
        _, scales, mins = planes_img
        s, b = f32_row(scales, c // 2).double(), f32_row(mins, c // 2).double()
        return ((magic_bytes(u) - 8388608.0).double() * s - b).float()  # fmaf: q·s exact, one rounding
    _, highs, scales = planes_img
    rh = 4 * c + T  # [1, 4]: highs row t, K rows 4t + i at bits 2i
    hw = _words(_read16(highs, BN, rh.expand(8, 4), piece(rh, 4, cc)))  # [8, 4, 4 w]
    hi = torch.stack([(hw << 4) & 0x30303030, (hw << 2) & 0x30303030, hw & 0x30303030,
                      (hw >> 2) & 0x30303030], dim=2)
    return (magic_bytes(u | hi) - (8388608.0 + 32.0)) * f32_row(scales, c)  # q − 32 exactly, one rounding


def _slot(t, i):
    """The mma K slot of lane t's K row 4t + i."""
    return 2 * t + (i % 2) + 8 * (i // 2)


def _lane_x(x_img, xes, c, nt):
    """Each lane's B values of n-tile nt: [8 g, 4 t, 4 i] f32 of bf16, x row
    8 nt + g at K 16c + 4t + i."""
    xb = BK * xes
    n = 8 * nt + G
    if xes == 2:
        off = n * xb + 16 * x_piece(2, n, 2 * c + (T >> 1)) + 8 * (T & 1)
        raw = x_img[off[..., None] + torch.arange(8)].contiguous().view(torch.bfloat16)
    else:
        off = n * xb + 16 * x_piece(4, n, 4 * c + T)
        raw = x_img[off[..., None] + torch.arange(16)].contiguous().view(torch.float32)
    return raw.to(torch.bfloat16).float().reshape(8, 4, 4)


def _task(fmt, planes, e, m0, x_src, r0, br, stages):
    """One block's sums over its WK warps, [br, BN] f32: expert e, the slab
    at column m0, x rows r0 .. r0 + br - 1 of x_src (zeros past its rows),
    the ring stages `stages` of BK K rows."""
    K = x_src.shape[-1]
    nt_count = br // 8
    kinds = PLANES[fmt]
    xes = x_src.element_size()
    # accumulators in the C matrices' form: [WK][WN][8 j][NT][16][8]
    acc = torch.zeros(WK, WN, 8, nt_count, 16, 8)
    for k0 in (BK * kt for kt in stages):
        imgs = [_stage_plane(p, e, m0, k0, kpr, es, planes[0].shape[-1], K)
                for p, (_, kpr, es) in zip(planes, kinds)]
        x_img = _stage_x(x_src, r0, k0, br, K)
        for c in range(CHUNKS):
            if k0 + 16 * c >= K:
                break
            wk = c % WK
            for wn in range(WN):
                w = _lane_values(fmt, imgs, c, wn).to(torch.bfloat16).float()  # [8, 4, 4, 16]
                A = torch.zeros(8, 16, 16)  # tile j: [row, K slot]
                for t in range(4):
                    for i in range(4):
                        A[:, 0:8, _slot(t, i)] = w[:, t, i, 0::2].t()  # row g: column 2j
                        A[:, 8:16, _slot(t, i)] = w[:, t, i, 1::2].t()  # row g + 8: 2j + 1
                for nt in range(nt_count):
                    xv = _lane_x(x_img, xes, c, nt)
                    B = torch.zeros(16, 8)
                    for t in range(4):
                        for i in range(4):
                            B[_slot(t, i), :] = xv[:, t, i]  # column g
                    acc[wk, wn, :, nt] += A @ B
    # each lane's C registers, written as the epilogue does
    red = torch.zeros(WK, br, BN)
    for wk in range(WK):
        for wn in range(WN):
            for nt in range(nt_count):
                C = acc[wk, wn, :, nt]  # [8 j, 16, 8]
                for t in range(4):
                    for h in range(2):
                        n = 8 * nt + 2 * t + h
                        for g in range(8):
                            # c_i = C[g + 8 (i // 2)][2t + i % 2]
                            reg = [C[:, g + 8 * (i // 2), 2 * t + (i % 2)] for i in range(4)]
                            for u in range(4):
                                col = 128 * wn + 16 * g + 4 * u
                                red[wk, n, col: col + 4] = torch.stack(
                                    [reg[h][2 * u], reg[2 + h][2 * u], reg[h][2 * u + 1],
                                     reg[2 + h][2 * u + 1]])
    total = red[0].clone()
    for wk in range(1, WK):
        total += red[wk]
    return total


def emulate(fmt, x, planes, per_expert):
    """out [E, N, M] f32 as csrc/expert_sweep.cu computes it: x [N, K]
    (dense) or [E, N, K] (perx), f32 or bf16; `planes` the format's
    in-major tensors."""
    E, _, M = planes[0].shape
    K = x.shape[-1]
    N = x.shape[-2]
    br = 8 if N <= 8 else 16
    out = torch.zeros(E, N, M)
    for e in range(E):
        x_e = x[e] if per_expert else x
        for m0 in range(0, M, BN):
            for r0 in range(0, N, br):
                total = _task(fmt, planes, e, m0, x_e, r0, br, range(-(-K // BK)))
                rows, cols = min(br, N - r0), min(BN, M - m0)
                out[e, r0: r0 + rows, m0: m0 + cols] = total[:rows, :cols]
    return out


def gather_plan(idx, E, br):
    """The gather launch's tasks as its blocks build them from idx
    (csrc/expert_sweep.cu: plan_rows): (expert, selections whose x rows the
    task reads, selections whose output rows it writes), one for each
    leader g, a selection of an expert in [0, E) below which that expert
    has a multiple of br selections; its list is the next br selections
    g'' >= g of that expert in ascending order."""
    idx = [int(v) for v in idx]
    tasks = []
    for g, e in enumerate(idx):
        if 0 <= e < E and idx[:g].count(e) % br == 0:
            sel = [j for j in range(g, len(idx)) if idx[j] == e][:br]
            tasks.append((e, sel, sel))
    return tasks


def emulate_gather(fmt, x, planes, idx, ks=1):
    """out [G, M] f32 as csrc/expert_sweep.cu's gather launch computes it:
    x [G, K] (one row a selection), idx [G]; tasks of BR rows (8 when G <=
    8, else 16: NT n-tiles), each task's K stages split over a cluster of
    ks blocks whose sums add in rank order; rows of an index outside
    [0, E) are zeros."""
    E, _, M = planes[0].shape
    G, K = x.shape
    br = 8 if G <= 8 else 16
    ktiles = -(-K // BK)
    per = -(-ktiles // ks)
    out = torch.zeros(G, M)
    for e, rows_x, rows_o in gather_plan(idx, E, br):
        x_task = x[rows_x]
        for m0 in range(0, M, BN):
            total = None
            for rank in range(ks):
                part = _task(fmt, planes, e, m0, x_task, 0, br,
                             range(min(ktiles, rank * per), min(ktiles, rank * per + per)))
                total = part if total is None else total + part
            cols = min(BN, M - m0)
            out[rows_o, m0: m0 + cols] = total[: len(rows_o), :cols]
    return out


def _f32_of_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _assert_close(got, want, x, w):
    """w: the dequantized weight [E, K, M], x [.., N, K]."""
    bound = np.abs(_f32_of_bf16(x)) @ np.abs(np.asarray(w, np.float32))
    assert got.shape == want.shape
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= 1e-5 * float(bound.max())


def _case(fmt, e, n, k, m, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(2, e, k, m)) * k ** -0.5).astype(np.float32)
    x = rng.normal(size=(n, k)).astype(np.float32)
    xe = rng.normal(size=(e, n, k)).astype(np.float32)
    if dtype == "bf16":
        x, xe = _f32_of_bf16(x), _f32_of_bf16(xe)
    return w, x, xe


def _tx(x, dtype):
    t = torch.from_numpy(x)
    return t if dtype == "f32" else t.to(torch.bfloat16)


def _jx(x, dtype):
    return jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)


# (e, n, k, m): a ragged last stage (K 96 of BK 64) and M 36 (4-byte code
# copies, a dead tail of the slab); two slabs and two row tiles (N 20); N
# 1 (one n-tile); the main path's N 16
_Q8_CASES = [(3, 3, 96, 36), (2, 20, 64, 256), (2, 1, 128, 128), (2, 16, 128, 132)]
_KQ_CASES = [(3, 3, 256, 36), (2, 20, 256, 256), (2, 1, 256, 128), (2, 16, 512, 132)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", _Q8_CASES)
def test_q8_sweep_emulation_matches_layered_pallas(dtype, e, n, k, m):
    w, x, xe = _case("q8_0", e, n, k, m, dtype, e * 100 + n + k)
    planes = jax_sq.quantize_expert_stack(w, "q8_0")
    layer = 1
    p = sq.quantize_expert_stack(torch.from_numpy(w), "q8_0")
    codes, scales = p["codes"][layer], p["scales"][layer]
    deq = (codes.float() * scales.repeat_interleave(32, dim=1)).to(torch.bfloat16).float().numpy()
    want = jax_dq.q8_dense_experts_layered(_jx(x, dtype), jnp.asarray(planes["codes"]),
                                           jnp.asarray(planes["scales"]), jnp.int32(layer), interpret=True)
    _assert_close(emulate("q8_0", _tx(x, dtype), (codes, scales), False).numpy(), want, x[None], deq)
    want = jax_dq.q8_dense_experts_perx_layered(_jx(xe, dtype), jnp.asarray(planes["codes"]),
                                                jnp.asarray(planes["scales"]), jnp.int32(layer),
                                                interpret=True)
    _assert_close(emulate("q8_0", _tx(xe, dtype), (codes, scales), True).numpy(), want, xe, deq)


@pytest.mark.parametrize("method", ["q4_k", "q6_k"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,n,k,m", _KQ_CASES)
def test_kquant_sweep_emulation_matches_layered_pallas(method, dtype, e, n, k, m):
    from dsocr_tpu_torch.ops.kernels import kquant_matmul

    fmt = method.replace("_", "")
    w, x, xe = _case(method, e, n, k, m, dtype, e * 100 + n + k + len(method))
    planes = {key: jnp.asarray(v) for key, v in jax_sq.quantize_expert_stack(w, method).items()}
    layer = 1
    p = sq.quantize_expert_stack(torch.from_numpy(w), method)
    packed = tuple(p[name][layer] for name, _, _ in PLANES[method])
    deq = getattr(kquant_matmul, f"dequant_{fmt}")(*packed, -2).float().numpy()
    want = getattr(jax_kq, f"{fmt}_dense_experts_layered")(_jx(x, dtype), planes, jnp.int32(layer),
                                                           interpret=True)
    _assert_close(emulate(method, _tx(x, dtype), packed, False).numpy(), want, x[None], deq)
    want = getattr(jax_kq, f"{fmt}_dense_experts_perx_layered")(_jx(xe, dtype), planes, jnp.int32(layer),
                                                                interpret=True)
    _assert_close(emulate(method, _tx(xe, dtype), packed, True).numpy(), want, xe, deq)


def test_a_wrong_slot_misses_the_tolerance(monkeypatch):
    """The check can fail: B fragments whose K rows 4t + 1 and 4t + 2 sit in
    each other's slots (A keeping the kernel's) miss the reference by far."""
    import sys

    w, x, _ = _case("q8_0", 2, 16, 64, 128, "f32", 3)
    p = sq.quantize_expert_stack(torch.from_numpy(w[1]), "q8_0")
    planes = jax_sq.quantize_expert_stack(w, "q8_0")
    want = np.asarray(jax_dq.q8_dense_experts_layered(jnp.asarray(x), jnp.asarray(planes["codes"]),
                                                      jnp.asarray(planes["scales"]), jnp.int32(1),
                                                      interpret=True))
    scale = float(np.abs(want).max())
    right = _lane_x

    def swapped(x_img, xes, c, nt):
        return right(x_img, xes, c, nt)[:, :, [0, 2, 1, 3]]

    monkeypatch.setattr(sys.modules[__name__], "_lane_x", swapped)
    bad = emulate("q8_0", torch.from_numpy(x), (p["codes"], p["scales"]), False).numpy()
    assert np.abs(bad - want).max() > 1e-2 * scale


# -- the gather tier: the plan the kernel builds from idx, on the same body --


def _routed(rng, tokens, topk, e):
    """A router's selections: each token's top-k experts, distinct."""
    return np.concatenate([rng.permutation(e)[:topk] for _ in range(tokens)]).astype(np.int32)


# (case, E, idx maker): every selection distinct (one token's top-6); repeats
# across tokens (four tokens' top-3 of 5); every selection on one expert
# (20 rows: a task of 16 and one of 4); one selection
_GATHER = {
    "distinct": (8, lambda rng: _routed(rng, 1, 6, 8)),
    "repeats": (5, lambda rng: _routed(rng, 4, 3, 5)),
    "one_expert": (3, lambda rng: np.full(20, 1, np.int32)),
    "single": (4, lambda rng: np.array([2], np.int32)),
}


def _gather_inputs(method, case, dtype, k, m, seed):
    """A [2, E, k, m] stack (layer 1 is used), x [G, k] and idx [G]."""
    rng = np.random.default_rng(seed)
    e, make_idx = _GATHER[case]
    idx = make_idx(rng)
    w = (rng.normal(size=(2, e, k, m)) * k ** -0.5).astype(np.float32)
    x = rng.normal(size=(len(idx), k)).astype(np.float32)
    if dtype == "bf16":
        x = _f32_of_bf16(x)
    return w, x, idx


def _gather_bound(x, deq, idx):
    """|bf16 x[g]| @ |W[idx[g]]| for every selection: [G, M]."""
    return np.einsum("gk,gkm->gm", np.abs(_f32_of_bf16(x)), np.abs(deq[idx]))


def _gather_pallas(method, x, dtype, w, idx, layer):
    """The reference's gather function and its _layered form, interpret mode."""
    if method == "q8_0":
        planes = jax_sq.quantize_expert_stack(w, "q8_0")
        codes, scales = jnp.asarray(planes["codes"]), jnp.asarray(planes["scales"])
        one = jax_dq.q8_gather_matmul(_jx(x, dtype), codes[layer], scales[layer], jnp.asarray(idx),
                                      interpret=True)
        layered = jax_dq.q8_gather_matmul_layered(_jx(x, dtype), codes, scales, jnp.asarray(idx),
                                                  jnp.int32(layer), interpret=True)
        return one, layered
    fmt = method.replace("_", "")
    planes = {key: jnp.asarray(v) for key, v in jax_sq.quantize_expert_stack(w, method).items()}
    one = getattr(jax_kq, f"{fmt}_gather_matmul")(_jx(x, dtype), {key: v[layer] for key, v in planes.items()},
                                                   jnp.asarray(idx), interpret=True)
    layered = getattr(jax_kq, f"{fmt}_gather_matmul_layered")(_jx(x, dtype), planes, jnp.asarray(idx),
                                                               jnp.int32(layer), interpret=True)
    return one, layered


def _packed_layer(method, w, layer):
    """The port's packed planes of layer `layer` and its dequantized [E, K, M] weight."""
    from dsocr_tpu_torch.ops.kernels import kquant_matmul

    p = sq.quantize_expert_stack(torch.from_numpy(w), method)
    packed = tuple(p[name][layer] for name, _, _ in PLANES[method])
    if method == "q8_0":
        codes, scales = packed
        deq = (codes.float() * scales.repeat_interleave(32, dim=1)).to(torch.bfloat16).float()
    else:
        deq = getattr(kquant_matmul, f"dequant_{method.replace('_', '')}")(*packed, -2).float()
    return packed, deq.numpy()


@pytest.mark.parametrize("method", ["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,ks", [("distinct", 1), ("repeats", 1), ("repeats", 2), ("one_expert", 1),
                                     ("one_expert", 2), ("single", 1)])
def test_gather_emulation_matches_pallas(method, dtype, case, ks):
    """K 256 (4 ring stages: ks 2 gives each block of the cluster two), M 132
    (a second slab with 4 live columns)."""
    k, m, layer = 256, 132, 1
    w, x, idx = _gather_inputs(method, case, dtype, k, m, len(case) + 7 * ks + len(method))
    packed, deq = _packed_layer(method, w, layer)
    got = emulate_gather(method, _tx(x, dtype), packed, idx, ks).numpy()
    bound = _gather_bound(x, deq, idx)
    for want in _gather_pallas(method, x, dtype, w, idx, layer):
        assert got.shape == want.shape
        assert float(np.abs(got - np.asarray(want)).max()) <= 1e-5 * float(bound.max())


def test_gather_plan_leaders_lists_and_tiles():
    """A block leads where its expert's earlier selections number a multiple
    of the task's rows; its list is the next selections of that expert in
    order; out-of-range indices have no task."""
    idx = [3, 1, 3, -1, 1, 7, 3, 9]
    assert gather_plan(idx, 8, 8) == [(3, [0, 2, 6], [0, 2, 6]), (1, [1, 4], [1, 4]), (7, [5], [5])]
    assert gather_plan([2] * 20, 4, 16) == [(2, list(range(16)), list(range(16))), (2, [16, 17, 18, 19], [16, 17, 18, 19])]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_row_bits_do_not_depend_on_its_tile(dtype):
    """Selection 3's row gives the same bits alone in its tile (row 0) as
    shared with three other selections of its expert (row 2 of 4)."""
    k, m = 256, 128
    w, x, _ = _gather_inputs("q8_0", "repeats", dtype, k, m, 11)
    packed, _ = _packed_layer("q8_0", w, 1)
    shared = np.array([1, 0, 1, 1, 2, 1], np.int32)
    alone = np.array([2, 0, 3, 1, 2, 4], np.int32)
    a = emulate_gather("q8_0", _tx(x[:6], dtype), packed, shared)
    b = emulate_gather("q8_0", _tx(x[:6], dtype), packed, alone)
    assert torch.equal(a[3], b[3])
    assert torch.equal(a[1], b[1]) and not torch.equal(a[0], b[0])


def test_a_wrong_row_mapping_misses_the_tolerance(monkeypatch):
    """The check can fail: a plan that scatters each task's outputs one row
    off its x rows misses the reference by far."""
    import sys

    k, m, layer = 256, 128, 1
    w, x, idx = _gather_inputs("q8_0", "repeats", "f32", k, m, 5)
    packed, deq = _packed_layer("q8_0", w, layer)
    want, _ = _gather_pallas("q8_0", x, "f32", w, idx, layer)
    right = gather_plan

    def rotated(idx, E, br):
        return [(e, rows_x, rows_o[1:] + rows_o[:1]) for e, rows_x, rows_o in right(idx, E, br)]

    monkeypatch.setattr(sys.modules[__name__], "gather_plan", rotated)
    bad = emulate_gather("q8_0", torch.from_numpy(x), packed, idx).numpy()
    assert np.abs(bad - np.asarray(want)).max() > 1e-2 * float(_gather_bound(x, deq, idx).max())


# -- the shared-memory layout: every piece has one place, and the reads of a
# phase of a warp hit distinct banks ---------------------------------------


@pytest.mark.parametrize("kpr", [1, 2, 4])
def test_code_swizzle_is_a_permutation_of_each_row(kpr):
    for r in range(BK // kpr):
        assert sorted(piece(r, kpr, cc) for cc in range(BN // 16)) == list(range(BN // 16))


@pytest.mark.parametrize("esize", [2, 4])
def test_x_swizzle_is_a_permutation_of_each_row(esize):
    pieces = BK * esize // 16
    for n in range(16):
        assert sorted(x_piece(esize, n, cc) for cc in range(pieces)) == list(range(pieces))


def _code_rows(kpr, c, t):
    """The rows of a byte plane that lane t reads for chunk c."""
    first, last = (16 * c + 4 * t) // kpr, (16 * c + 4 * t + 3) // kpr
    return list(range(first, last + 1))


@pytest.mark.parametrize("kpr", [1, 2, 4])
def test_code_reads_of_a_quarter_warp_hit_distinct_banks(kpr):
    """16-byte reads run in phases of 8 lanes (lane = 4 g + t): each phase's
    pieces must fall in 8 distinct 16-byte bank groups of 128 bytes."""
    for c in range(CHUNKS):
        for wn in range(WN):
            for k in range(len(_code_rows(kpr, c, 0))):
                for q in range(4):
                    groups = set()
                    for lane in range(8 * q, 8 * q + 8):
                        g, t = lane // 4, lane % 4
                        r = _code_rows(kpr, c, t)[k]
                        addr = r * BN + 16 * piece(r, kpr, 8 * wn + g)
                        groups.add((addr % 128) // 16)
                    assert len(groups) == 8, (kpr, c, k, q)


@pytest.mark.parametrize("esize", [2, 4])
def test_x_reads_hit_distinct_banks(esize):
    """bf16 x: 8-byte reads in phases of 16 lanes must take 16 distinct
    8-byte slots of 128 bytes; f32 x: 16-byte reads in phases of 8 lanes,
    8 distinct 16-byte groups."""
    xb = BK * esize
    width, phase = (8, 16) if esize == 2 else (16, 8)
    for c in range(CHUNKS):
        for nt in range(2):
            for q in range(32 // phase):
                slots = set()
                for lane in range(phase * q, phase * q + phase):
                    g, t = lane // 4, lane % 4
                    n = 8 * nt + g
                    if esize == 2:
                        addr = n * xb + 16 * x_piece(2, n, 2 * c + (t >> 1)) + 8 * (t & 1)
                    else:
                        addr = n * xb + 16 * x_piece(4, n, 4 * c + t)
                    slots.add((addr % 128) // width)
                assert len(slots) == phase, (esize, c, nt, q)
