"""The megafused Q8_0 chain's split (csrc/moe_megafused.cu on the sweep's
body, csrc/expert_sweep.cuh), emulated in torch on the CPU against the
reference's q8_moe_megafused_layered in interpret mode.

The kernel cannot run here, so this file transcribes what it does with
each byte, on tests/test_torch_expert_sweep.py's transcription of the
sweep's body (piece and x_piece swizzles, the Q8_0 decode, the mma
fragments):

- the columns over the cluster: rank r of CLUSTER blocks (read from the
  source) takes inter chunks [share(nq, r), share(nq, r + 1)) of 64 gate
  columns and their 64 up columns, then an equal share of the down
  stages (phase2_units: 128-column output slabs × K stages of 64, a slab
  split between two blocks at most), each item's sums a partial piece;
- the gate/up pairing in a lane: a phase-1 stage's code row holds the
  chunk's gate columns in pieces 0..3 and its up columns in 4..7; lane g
  reads 8 bytes of each half (GateUp::load), so its lane columns j < 8
  are gate column 8g + j and j ≥ 8 the matching up column, and
  bf16(silu(g)·u) is formed from its own sums;
- the exchange: phase 2's stage kt reads its B rows from inter chunk kt
  of the block that owns it, as that block wrote it (x_piece's layout);
- the down columns, each output slab's sums weighted by w[e, n];
- the sums: each item's four K-split warps added (w0 + w2) + (w1 + w3),
  an expert's two pieces added, then the experts in expert order from
  zero.

Tolerance against the Pallas function: chip_smoke.megafused_tol per
element plus rtol = atol = 2e-5, as tests/test_torch_paged.py holds the
twin: both sum gate+up in f32 in their own order and compute silu their
own way, and where that moves an inter element across a bf16 rounding
boundary the element differs by one bf16 ulp. A wrong piece, lane,
owner or pairing moves whole products and misses it by far
(test_a_wrong_pairing_misses_the_tolerance).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_expert_sweep as sweep
from dsocr_tpu.dsq import serve_quant as jax_sq
from dsocr_tpu.ops.pallas import dequant_matmul as jax_dq

SRC = pathlib.Path(__file__).resolve().parents[1] / "dsocr_tpu_torch" / "csrc" / "moe_megafused.cu"
CLUSTER = sweep._const("CLUSTER", SRC)
BK, BN, WK, CHUNKS = sweep.BK, sweep.BN, sweep.WK, sweep.CHUNKS
GW = BN // 2  # gate columns of a phase-1 item


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def share(n, r):
    """moe_megafused.cu: share — the first of n items rank r takes."""
    return n * r // CLUSTER


def phase2_units(ns, nq, r):
    """moe_megafused.cu: phase2_units — rank r's down stages [u0, u1) of
    ns · nq (slab u // nq, K stage u % nq)."""
    if ns >= CLUSTER:
        return share(ns * nq, r), share(ns * nq, r + 1)
    return (r * nq, r * nq + nq) if r < ns else (0, 0)


def _gateup_stage(codes, scales, e, q, k0, H, MI, pair=True):
    """A phase-1 stage's code and scale planes as the copies leave them:
    code row r holds gate columns 64q + 16cc in piece cc < 4 and the
    matching up columns in piece cc + 4, each at piece(r, 1, cc); the
    scale rows hold the 64 gate scales, then the 64 up scales. With pair
    False the up half is the next 64 gate columns instead (a wrong
    pairing)."""
    img = torch.zeros(BK, 8, 16, dtype=torch.uint8)
    sc = torch.zeros(2, BN, dtype=torch.float32)
    rows = max(0, min(BK, H - k0))
    for cc in range(8):
        col = GW * q + 16 * (cc & 3)
        base = (MI if cc >= 4 else 0) if pair else 16 * (cc & 4)
        width = max(0, min(16, MI - col))
        if rows and width:
            src = sweep._bytes(codes[e, k0: k0 + rows, base + col: base + col + width]).reshape(rows, width)
            r = torch.arange(rows)
            img[r, sweep.piece(r, 1, cc), :width] = src
    for sr in range(2):
        if 32 * sr < rows:
            for half in range(2):
                col = GW * q
                width = max(0, min(GW, MI - col))
                base = (MI if half else 0) if pair else GW * half
                sc[sr, GW * half: GW * half + width] = scales[e, k0 // 32 + sr, base + col: base + col + width]
    return img.reshape(-1), sc.reshape(-1).view(torch.uint8)


def _gateup_lane_values(codes_img, scales_img, c):
    """GateUp::load and Fmt<Q8>::value: [8 g, 4 t, 4 i, 16 j] f32, K row
    16c + 4t + i; j < 8 gate column 8g + j, j ≥ 8 up column 8g + j − 8."""
    g = sweep.G[..., None]  # [8, 1, 1]
    r = 16 * c + 4 * sweep.T[..., None] + torch.arange(4)  # [1, 4, 4]
    rows = r.expand(8, 4, 4)
    words = []
    for half in (g >> 1, 4 + (g >> 1)):  # gate, up: 8 bytes of each
        off = rows * BN + 16 * sweep.piece(r, 1, half) + 8 * (g & 1)
        b = codes_img[off[..., None] + torch.arange(8)]  # [8, 4, 4, 8]
        words.append(sweep._words(torch.cat([b, torch.zeros_like(b)], -1))[..., :2])
    u = torch.cat(words, -1) ^ 0x80808080  # [8, 4, 4, 4 w]
    j = torch.arange(16)
    byte = (u[..., j // 4] >> (8 * (j % 4))) & 0xFF
    values = (0x4B000000 | byte).to(torch.int32).view(torch.float32) - 8388736.0
    s = scales_img.view(torch.float32).reshape(2, BN)[c // 2]
    lane_scales = torch.stack([torch.cat([s[8 * gg: 8 * gg + 8], s[GW + 8 * gg: GW + 8 * gg + 8]])
                               for gg in range(8)])  # [8, 16]
    return values * lane_scales[:, None, None, :]


def _mma(acc, w, b_of, nt_count, wk):
    """Adds one chunk's products to warp wk's sums acc [WK, br, BN]: lane
    values w [8 g, 4 t, 4 i, 16 j] as tile j's A (rows g, g + 8 = lane
    columns 2j, 2j + 1), b_of(nt) the lanes' B values."""
    w = w.to(torch.bfloat16).float()
    for j in range(8):
        A = torch.zeros(16, 16)
        for t in range(4):
            for i in range(4):
                A[0:8, sweep._slot(t, i)] = w[:, t, i, 2 * j]
                A[8:16, sweep._slot(t, i)] = w[:, t, i, 2 * j + 1]
        for nt in range(nt_count):
            xv = b_of(nt)
            B = torch.zeros(16, 8)
            for t in range(4):
                for i in range(4):
                    B[sweep._slot(t, i), :] = xv[:, t, i]
            C = A @ B  # [16 rows: lane g's columns, 8 x rows]
            cols = 16 * torch.arange(8) + 2 * j
            acc[wk, 8 * nt: 8 * nt + 8][:, cols] += C[0:8].t()
            acc[wk, 8 * nt: 8 * nt + 8][:, cols + 1] += C[8:16].t()


def _item_sums(acc):
    """The end of an item: (w0 + w2) + (w1 + w3)."""
    return (acc[0] + acc[2]) + (acc[1] + acc[3])


def _inter_chunk(sums, br):
    """Warp 0's epilogue of a phase-1 item: bf16(silu(g)·u) of its lane
    columns, row n's piece g = inter columns 8g .. 8g + 7, x_piece's
    layout (the B rows of phase 2's stage)."""
    lanes = sums.reshape(br, 8, 16)
    gate, up = lanes[..., :8], lanes[..., 8:]
    inter = (gate / (1 + torch.exp(-gate)) * up).to(torch.bfloat16).reshape(br, 64)
    img = torch.zeros(br, 8, 16, dtype=torch.uint8)
    n = torch.arange(br)[:, None]
    cc = torch.arange(8)[None, :]
    img[n.expand(br, 8), sweep.x_piece(2, n, cc)] = sweep._bytes(inter).reshape(br, 8, 16)
    return img.reshape(-1)


def emulate(x, w, gu, dn, pair=True):
    """out [N, H] f32 as csrc/moe_megafused.cu computes it: x [N, H] (f32
    or bf16), w [E, N] f32, gu / dn the in-major (codes, scales) stacks."""
    (guc, gus), (dnc, dns) = gu, dn
    E, H, MI2 = guc.shape
    MI, N = MI2 // 2, x.shape[0]
    nt_count = 1 if N <= 8 else 2 if N <= 16 else 4
    br = 8 * nt_count
    nq, ns, kt1 = -(-MI // GW), -(-H // BN), -(-H // BK)
    xes = x.element_size()
    partial = torch.zeros(E, 2, N, H)
    for e in range(E):
        chunks = {}  # inter chunk q → the image its owner wrote
        for rank in range(CLUSTER):  # phase 1 of every block of the cluster
            for q in range(share(nq, rank), share(nq, rank + 1)):
                acc = torch.zeros(WK, br, BN)
                for kt in range(kt1):
                    k0 = kt * BK
                    codes_img, scales_img = _gateup_stage(guc, gus, e, q, k0, H, MI, pair)
                    x_img = sweep._stage_x(x, 0, k0, br, H)
                    for c in range(CHUNKS):
                        if k0 + 16 * c >= H:
                            break
                        _mma(acc, _gateup_lane_values(codes_img, scales_img, c),
                             lambda nt: sweep._lane_x(x_img, xes, c, nt), nt_count, c % WK)
                chunks[q] = _inter_chunk(_item_sums(acc), br)
        for rank in range(CLUSTER):  # phase 2, B rows through the exchange
            u0, u1 = phase2_units(ns, nq, rank)
            u = u0
            while u < u1:  # an item: the block's stages of one slab
                s = u // nq
                end = min(u1, (s + 1) * nq)
                m0, piece = BN * s, 1 if s * nq < u0 else 0
                acc = torch.zeros(WK, br, BN)
                for kt in (v % nq for v in range(u, end)):
                    k0 = kt * BK
                    imgs = [sweep._stage_plane(dnc, e, m0, k0, 1, 1, H, MI),
                            sweep._stage_plane(dns, e, m0, k0, 32, 4, H, MI)]
                    for c in range(CHUNKS):
                        if k0 + 16 * c >= MI:
                            break
                        _mma(acc, sweep._lane_values("q8_0", imgs, c, 0),
                             lambda nt: sweep._lane_x(chunks[kt], 2, c, nt), nt_count, c % WK)
                cols = min(BN, H - m0)
                partial[e, piece, :, m0: m0 + cols] = w[e][:, None] * _item_sums(acc)[:N, :cols]
                u = end
    out = torch.zeros(N, H)
    for e in range(E):  # a slab's piece 1 is zeros unless it is split
        out = out + (partial[e, 0] + partial[e, 1])
    return out


def _inputs(N, seed=31, E=8, H=256, MI=128, top_k=3):
    rng = np.random.default_rng(seed + N)
    gu = jax_sq.quantize_expert_stack(rng.normal(size=(1, E, H, 2 * MI)).astype(np.float32) * 0.3)
    dn = jax_sq.quantize_expert_stack(rng.normal(size=(1, E, MI, H)).astype(np.float32) * 0.3)
    x = rng.normal(size=(N, H)).astype(np.float32) * 0.3
    idx = np.stack([rng.permutation(E)[:top_k] for _ in range(N)])
    w = np.zeros((E, N), np.float32)
    np.add.at(w, (idx.reshape(-1), np.repeat(np.arange(N), top_k)), rng.random(N * top_k).astype(np.float32))
    return x, w, gu, dn


def _reference(x, w, gu, dn):
    return np.asarray(jax_dq.q8_moe_megafused_layered(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gu["codes"]), jnp.asarray(gu["scales"]),
        jnp.asarray(dn["codes"]), jnp.asarray(dn["scales"]), jnp.asarray(0, jnp.int32), interpret=True))


def _torch_stacks(gu, dn):
    t = lambda a: torch.from_numpy(np.array(a[0]))  # noqa: E731
    return (t(gu["codes"]), t(gu["scales"])), (t(dn["codes"]), t(dn["scales"]))


def _outside(got, want, x, w, gu_t, dn_t):
    tol = chip_smoke.megafused_tol(torch, torch.from_numpy(x), torch.from_numpy(w), *gu_t, *dn_t).numpy()
    return np.abs(np.asarray(got) - want) > 2e-5 + 2e-5 * np.abs(want) + tol


@pytest.mark.parametrize("N", [11, 16, 32])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_megafused_emulation_matches_pallas(N, dtype):
    """E 8, H 256, MI 128 (the cluster's surplus blocks idle in phase 1);
    H 1024 splits slabs between blocks."""
    x, w, gu, dn = _inputs(N, H=1024 if N == 16 else 256)
    gu_t, dn_t = _torch_stacks(gu, dn)
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
        x = xt.float().numpy()
    got = emulate(xt, torch.from_numpy(w), gu_t, dn_t)
    want = _reference(x, w, gu, dn)
    assert got.shape == want.shape
    assert not _outside(got, want, x, w, gu_t, dn_t).any()


@pytest.mark.parametrize("MI,H", [(896, 1280), (128, 256), (32, 32), (96, 64), (128, 1024)])
def test_megafused_split_covers_every_column_once(MI, H):
    """share and phase2_units: the cluster's blocks take every inter chunk
    and every down stage once, and a slab spans at most two blocks, at the
    main path's widths and the emulated ones."""
    nq, ns = -(-MI // GW), -(-H // BN)
    assert [q for r in range(CLUSTER) for q in range(share(nq, r), share(nq, r + 1))] == list(range(nq))
    units = [u for r in range(CLUSTER) for u in range(*phase2_units(ns, nq, r))]
    assert units == list(range(ns * nq))
    for s in range(ns):
        owners = {r for r in range(CLUSTER) if set(range(*phase2_units(ns, nq, r))) & set(range(s * nq, s * nq + nq))}
        assert 1 <= len(owners) <= 2


def test_gateup_reads_of_a_half_warp_hit_distinct_banks():
    """GateUp::load's 8-byte reads: a half-warp (g 0..3 or 4..7, t 0..3)
    covers the 32 banks of its rows once, for the gate half and the up
    half alike."""
    for c in range(CHUNKS):
        for i in range(4):
            for half in (0, 1):
                for g0 in (0, 4):
                    banks = []
                    for g in range(g0, g0 + 4):
                        for t in range(4):
                            r = 16 * c + 4 * t + i
                            off = r * BN + 16 * sweep.piece(r, 1, 4 * half + (g >> 1)) + 8 * (g & 1)
                            banks += [(off // 4 + b) % 32 for b in (0, 1)]
                    assert sorted(banks) == list(range(32))


def test_a_wrong_pairing_misses_the_tolerance():
    """The emulation is sharp: pairing each gate column with the wrong up
    column (the next gate columns) fails the tolerance."""
    x, w, gu, dn = _inputs(16, seed=5)
    gu_t, dn_t = _torch_stacks(gu, dn)
    got = emulate(torch.from_numpy(x), torch.from_numpy(w), gu_t, dn_t, pair=False)
    assert _outside(got, _reference(x, w, gu, dn), x, w, gu_t, dn_t).mean() > 0.5
