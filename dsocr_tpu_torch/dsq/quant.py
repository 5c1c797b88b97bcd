"""Q4_K and Q6_K row quantization in torch (dsocr_tpu/dsq/quant.py:
quantize_q4_k with _make_qkx2_quants, quantize_q6_k with _make_qx_quants).

``q4k_rows`` and ``q6k_rows`` are ``quantize_q4_k`` / ``quantize_q6_k``
followed by the reference's payload decode
(dsocr_tpu/ops/pallas/kquant_matmul.py: _q4k_decode_payload,
_q6k_decode_payload), without the byte payload in between, on any device.
Their results are bit-exact with the NumPy quantizers, which takes care
in these places:

- every 32- or 16-wide sum is written out in NumPy's pairwise order
  (eight strided partial sums, then a fixed tree; ``_sum32``, ``_sum16``):
  ``torch.sum`` adds in another order, and the scale searches keep or
  drop candidates on ``mad < best_mad`` (Q4_K) or
  ``slx·slx > best·sl2`` (Q6_K) of such sums;
- every division has a tensor divisor: torch computes ``c / t`` and, on
  the card, ``t / c`` for a Python scalar c through a reciprocal, which
  is not the correctly rounded quotient. A Python-float numerator is
  rounded to f32 first, as NumPy's weak scalar is (``_rdiv``): Q6_K's
  ``-(nmax + 0.1·step) / max`` rounds the f64 sum to f32, then divides;
- NumPy promotes f32 × int32 to f64: Q4_K's first candidate's error sum
  and its final re-quantization against the f16-rounded scales run in
  f64 (Q6_K casts its codes and scales to f32 first and stays in f32);
- rounding is half to even (``torch.round`` is ``np.rint``), and a value
  that ``astype(np.int32)`` cannot hold becomes INT32_MIN as on x86, so
  the clip that follows sends it to 0 (``_nearest_int``);
- the square root runs in f64 and is rounded once to f32: torch's f32
  sqrt on the CPU is vectorized and not always correctly rounded;
- Q6_K: ``argmax`` of ``|x|`` and of ``|scales|`` takes the first index
  of a tie, as NumPy's does, and keeps the signed value there; ``d`` is
  rounded through f16; ``astype(np.int8)`` of the 8-bit scales wraps
  modulo 256; a group whose largest magnitude is below GROUP_MAX_EPS is
  dead (codes and scale 0); and where ``d·sc == 0`` in a live super-block
  the scale search's own codes are kept, so ``_make_qx_quants`` returns
  codes as well as scales.
"""

from __future__ import annotations

import torch

QK_K = 256  # values per super-block (one f16 d, and dmin for Q4_K)
Q4K_SUB = 32  # values per Q4_K sub-block (one 6-bit scale and min)
Q6K_SUB = 16  # values per Q6_K sub-block (one 8-bit scale)
GROUP_MAX_EPS = 1e-15
_INT32_MIN = -2.0 ** 31


def _sum32(t: torch.Tensor) -> torch.Tensor:
    """[.., 32] → [..]: NumPy's float add-reduce of 32 contiguous values,
    r_j = ((a_j + a_j+8) + a_j+16) + a_j+24, then
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))."""
    r = t[..., 0:8] + t[..., 8:16]
    r = r + t[..., 16:24]
    r = r + t[..., 24:32]
    p = r[..., 0::2] + r[..., 1::2]
    q = p[..., 0::2] + p[..., 1::2]
    return q[..., 0] + q[..., 1]


def _sum16(t: torch.Tensor) -> torch.Tensor:
    """[.., 16] → [..]: NumPy's float add-reduce of 16 contiguous values,
    r_j = a_j + a_j+8, then ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))."""
    r = t[..., 0:8] + t[..., 8:16]
    p = r[..., 0::2] + r[..., 1::2]
    q = p[..., 0::2] + p[..., 1::2]
    return q[..., 0] + q[..., 1]


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t with num rounded to t's dtype first, divided by a tensor."""
    return torch.div(torch.full_like(t, num), t)


def _nearest_int(t: torch.Tensor) -> torch.Tensor:
    """np.rint(t).astype(np.int32), as float values."""
    r = torch.round(t)
    return torch.where((r >= _INT32_MIN) & (r < -_INT32_MIN), r, _INT32_MIN)


def _make_qkx2_quants(x, weights, nmax: int, rmin: float = -1.0, rdelta: float = 0.1,
                      nstep: int = 20):
    """ggml make_qkx2_quants (use_mad=False) over [S, 32] sub-blocks →
    (scale [S] f32, the_min [S] f32). The codes it also finds are
    recomputed by the caller against the packed scales, so none are kept."""
    vmin = torch.minimum(x.amin(dim=1), torch.zeros((), dtype=x.dtype, device=x.device))
    vmax = x.amax(dim=1)
    sum_w = _sum32(weights)
    sum_x = _sum32(weights * x)
    flat = vmax == vmin

    span0 = torch.where(flat, 1.0, vmax - vmin)
    iscale = _rdiv(float(nmax), span0)
    scale = _rdiv(1.0, iscale)
    L = _nearest_int(iscale[:, None] * (x - vmin[:, None])).clamp(0, nmax)
    # NumPy: f32 scale × int32 codes is f64, and so is the first error sum
    diff = scale.double()[:, None] * L.double() + vmin.double()[:, None] - x.double()
    best_mad = _sum32(weights.double() * diff * diff)
    cur_min = vmin.clone()

    for step in range(nstep + 1):
        span = torch.where(flat, 1.0, vmax - cur_min)
        isc = _rdiv(rmin + rdelta * step + nmax, span)
        lf = _nearest_int(isc[:, None] * (x - cur_min[:, None])).clamp(0, nmax)
        sum_l = _sum32(weights * lf)
        sum_l2 = _sum32(weights * lf * lf)
        sum_xl = _sum32(weights * lf * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
        pos_min = this_min > 0
        this_min = torch.where(pos_min, 0.0, this_min)
        alt_scale = torch.where(sum_l2 != 0, sum_xl / torch.where(sum_l2 == 0, 1.0, sum_l2), 0.0)
        this_scale = torch.where(pos_min, alt_scale, this_scale)
        diff = this_scale[:, None] * lf + this_min[:, None] - x
        mad = _sum32(weights * diff * diff)
        improve = (D > 0) & (mad.double() < best_mad)
        best_mad = torch.where(improve, mad.double(), best_mad)
        scale = torch.where(improve, this_scale, scale)
        cur_min = torch.where(improve, this_min, cur_min)

    scale = torch.where(flat, 0.0, scale)
    the_min = torch.where(flat, -vmin, -cur_min)
    return scale, the_min


def q4k_rows(rows: torch.Tensor):
    """[R, K] float, K % 256 == 0 → (codes [R, K] uint8 in 0..15,
    scales [R, K/32] f32 = d·sc, mins [R, K/32] f32 = dmin·m); the
    dequantized weight is codes · scales − mins per 32 values."""
    r, k = rows.shape
    if k % QK_K:
        raise ValueError(f"Q4_K rows need K % {QK_K} == 0, got K = {k}")
    x = rows.float().reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb * 8, Q4K_SUB)
    # 1/32 is exact either way; torch's f32 sqrt on the CPU is not
    # correctly rounded, its f64 sqrt rounded once to f32 is
    av_x = torch.sqrt((_sum32(sub * sub) / 32.0).double()).float()
    weights = av_x[:, None] + sub.abs()
    scales, mins = _make_qkx2_quants(sub, weights, 15)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)

    max_scale = scales.amax(dim=1)
    max_min = mins.amax(dim=1)
    inv_scale = torch.where(max_scale > 0, _rdiv(63.0, torch.where(max_scale <= 0, 1.0, max_scale)), 0.0)
    inv_min = torch.where(max_min > 0, _rdiv(63.0, torch.where(max_min <= 0, 1.0, max_min)), 0.0)
    # np.minimum(63, ·).astype(np.uint8) wraps modulo 256, and ggml's
    # 12-byte scale/min packing keeps the low 6 bits of each: its
    # pack-unpack round trip is the mask & 63
    sc = torch.clamp(_nearest_int(inv_scale[:, None] * scales), max=63).long() & 63
    m = torch.clamp(_nearest_int(inv_min[:, None] * mins), max=63).long() & 63
    sixty3 = torch.full_like(max_scale, 63.0)
    d = torch.div(max_scale, sixty3).to(torch.float16).float()
    dmin = torch.div(max_min, sixty3).to(torch.float16).float()

    dd = d.double()[:, None] * sc.double()  # f64, as NumPy's f32 × int32
    mmf = dmin.double()[:, None] * m.double()
    safe_dd = torch.where(dd == 0.0, 1.0, dd)
    codes = _nearest_int((x.reshape(nb, 8, Q4K_SUB).double() + mmf[..., None]) / safe_dd[..., None])
    codes = torch.where((dd == 0.0)[..., None], 0.0, codes.clamp(0, 15))
    # f16 d or dmin (11 bits) times a 6-bit integer is exact in f32
    s = (d[:, None] * sc.float()).reshape(r, k // Q4K_SUB)
    b = (dmin[:, None] * m.float()).reshape(r, k // Q4K_SUB)
    return codes.to(torch.uint8).reshape(r, k), s, b


def _signed_absmax(t: torch.Tensor) -> torch.Tensor:
    """[S, n] → [S]: the entry of largest magnitude, the first one of a
    tie (np.argmax), with its sign."""
    return t.gather(1, t.abs().argmax(dim=1, keepdim=True))[:, 0]


def _make_qx_quants(x, nmax: int):
    """ggml make_qx_quants (rmse_type=1, weight x²) over [S, 16] sub-blocks
    → (codes [S, 16] in -nmax..nmax-1 as f32, scale [S] f32)."""
    maxv = _signed_absmax(x)
    dead = maxv.abs() < GROUP_MAX_EPS
    safe_max = torch.where(dead, 1.0, maxv)
    w = x * x

    def trial(num: float):
        lf = _nearest_int(_rdiv(num, safe_max)[:, None] * x).clamp(-nmax, nmax - 1)
        return lf, _sum16(w * x * lf), _sum16(w * lf * lf)

    L, sumlx, suml2 = trial(-float(nmax))
    scale = torch.where(suml2 != 0.0, sumlx / torch.where(suml2 == 0.0, 1.0, suml2), 0.0)
    best = scale * sumlx
    for step in range(-9, 10):
        if step == 0:
            continue
        lf, slx, sl2 = trial(-(nmax + 0.1 * step))
        improve = (sl2 > 0) & (slx * slx > best * sl2)
        new_scale = slx / torch.where(sl2 == 0.0, 1.0, sl2)
        L = torch.where(improve[:, None], lf, L)
        scale = torch.where(improve, new_scale, scale)
        best = torch.where(improve, new_scale * slx, best)
    return torch.where(dead[:, None], 0.0, L), torch.where(dead, 0.0, scale)


def q6k_rows(rows: torch.Tensor):
    """[R, K] float, K % 256 == 0 → (codes [R, K] uint8 in 0..63,
    scales [R, K/16] f32 = d·sc); the dequantized weight is
    (codes − 32) · scales per 16 values."""
    r, k = rows.shape
    if k % QK_K:
        raise ValueError(f"Q6_K rows need K % {QK_K} == 0, got K = {k}")
    x = rows.float().reshape(-1, QK_K)
    nb = x.shape[0]
    L0, scales = _make_qx_quants(x.reshape(nb * 16, Q6K_SUB), 32)
    L0 = (L0 + 32).reshape(nb, 16, Q6K_SUB)
    scales = scales.reshape(nb, 16)
    max_scale = _signed_absmax(scales)
    dead = max_scale.abs() < GROUP_MAX_EPS
    iscale = torch.where(dead, 0.0, _rdiv(-128.0, torch.where(dead, 1.0, max_scale)))
    d = _rdiv(1.0, torch.where(iscale == 0.0, 1.0, iscale)).to(torch.float16).float()
    d = torch.where(dead, 0.0, d)
    sc = torch.clamp(_nearest_int(iscale[:, None] * scales), max=127)
    sc = torch.remainder(sc + 128.0, 256.0) - 128.0  # astype(np.int8) wraps
    # f16 d (11 bits) times an 8-bit integer is exact in f32; a dead
    # super-block has d = 0, so its scales come out 0 as the payload's do
    dd = d[:, None] * sc
    safe_dd = torch.where(dd == 0.0, 1.0, dd)
    codes = _nearest_int(x.reshape(nb, 16, Q6K_SUB) / safe_dd[..., None]).clamp(-32, 31) + 32
    codes = torch.where((dd == 0.0)[..., None], L0, codes)  # ggml skips those sub-blocks
    codes = torch.where(dead[:, None, None], 0.0, codes)  # and zeroes dead super-blocks
    return codes.to(torch.uint8).reshape(r, k), dd.reshape(r, k // Q6K_SUB)
