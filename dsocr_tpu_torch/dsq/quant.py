"""ggml quantization in torch (dsocr_tpu/dsq/quant.py): the Q4_K and Q6_K
row quantizers (quantize_q4_k with _make_qkx2_quants, quantize_q6_k with
_make_qx_quants), Q8_0's ``q8_rows``, and the byte codecs of all three.

The byte codecs (``quantize_q8_0`` / ``q4_k`` / ``q6_k``, their
``dequantize_*``, ``quantize``, ``dequantize``, ``block_size``) write and
read the reference's ggml payloads, byte for byte, on any device: the
quantizers hand their block parts (``q4k_blocks``, ``q6k_blocks``: f16
``d``/``dmin``, 6-bit scales and mins, 8-bit scales, codes) to the
encoders, and ``*_rows_from_payload`` decode a payload into what the row
quantizers return, which the serving packers lay out
(dsq/serve_quant.py). ``dequantize_q4_k`` returns f64, as NumPy computes
it; the others f32. The reference's native quantizer (native/quant.cpp)
is not carried over: these run on the card.

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


def q4k_blocks(rows: torch.Tensor):
    """[R, K] float, K % 256 == 0 → a Q4_K super-block's parts, one row of
    each per 256 values: (codes [nb, 256] uint8 in 0..15, d [nb] and dmin
    [nb] f32 holding f16 values, sc [nb, 8] and m [nb, 8] int64 in 0..63)."""
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
    return codes.to(torch.uint8).reshape(nb, QK_K), d, dmin, sc, m


def _q4k_decoded(r: int, k: int, codes, d, dmin, sc, m):
    """Q4_K parts → (codes [R, K], scales = d·sc, mins = dmin·m [R, K/32])."""
    # f16 d or dmin (11 bits) times a 6-bit integer is exact in f32
    s = (d[:, None] * sc.float()).reshape(r, k // Q4K_SUB)
    b = (dmin[:, None] * m.float()).reshape(r, k // Q4K_SUB)
    return codes.reshape(r, k), s, b


def q4k_rows(rows: torch.Tensor):
    """[R, K] float, K % 256 == 0 → (codes [R, K] uint8 in 0..15,
    scales [R, K/32] f32 = d·sc, mins [R, K/32] f32 = dmin·m); the
    dequantized weight is codes · scales − mins per 32 values."""
    return _q4k_decoded(*rows.shape, *q4k_blocks(rows))


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


def q6k_blocks(rows: torch.Tensor):
    """[R, K] float, K % 256 == 0 → a Q6_K super-block's parts, one row of
    each per 256 values: (codes [nb, 256] uint8 in 0..63, d [nb] f32
    holding f16 values, sc [nb, 16] f32 holding the int8 scales)."""
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
    sc = torch.where(dead[:, None], 0.0, sc)
    # f16 d (11 bits) times an 8-bit integer is exact in f32
    dd = d[:, None] * sc
    safe_dd = torch.where(dd == 0.0, 1.0, dd)
    codes = _nearest_int(x.reshape(nb, 16, Q6K_SUB) / safe_dd[..., None]).clamp(-32, 31) + 32
    codes = torch.where((dd == 0.0)[..., None], L0, codes)  # ggml skips those sub-blocks
    codes = torch.where(dead[:, None, None], 0.0, codes)  # and zeroes dead super-blocks
    return codes.to(torch.uint8).reshape(nb, QK_K), d, sc


def _q6k_decoded(r: int, k: int, codes, d, sc):
    """Q6_K parts → (codes [R, K], scales = d·sc [R, K/16])."""
    return codes.reshape(r, k), (d[:, None] * sc).reshape(r, k // Q6K_SUB)


def q6k_rows(rows: torch.Tensor):
    """[R, K] float, K % 256 == 0 → (codes [R, K] uint8 in 0..63,
    scales [R, K/16] f32 = d·sc); the dequantized weight is
    (codes − 32) · scales per 16 values."""
    return _q6k_decoded(*rows.shape, *q6k_blocks(rows))


# ---------------------------------------------------------------------------
# Q8_0, and the ggml byte codecs (dsocr_tpu/dsq/quant.py:44-378)
# ---------------------------------------------------------------------------

Q8_BLOCK = 32  # values per Q8_0 block (one f16 scale)
Q8_BLOCK_BYTES = 34  # f16 scale + 32 int8 codes
Q4K_BLOCK_BYTES = 144  # f16 d + f16 dmin + 12 B of 6-bit scales and mins + 128 B of nibbles
Q6K_BLOCK_BYTES = 210  # 128 B low nibbles + 64 B 2-bit highs + 16 int8 scales + f16 d


def q8_rows(rows: torch.Tensor):
    """[R, K] float, K % 32 == 0 → (codes [R, K] int8, scales [R, K/32]
    f32): amax/127 in f32, codes from the f32 scale's inverse rounded half
    away from zero (Rust's f32::round) and clipped, an all-zero block
    coded 0; the returned scale is rounded through f16, as a Q8_0 payload
    stores it (the reference's serve_quant.q8_rows)."""
    r, k = rows.shape
    x = rows.float().reshape(r, k // Q8_BLOCK, Q8_BLOCK)
    amax = x.abs().amax(dim=-1)
    zero = torch.zeros_like(amax)
    # a tensor divisor: CUDA divides by a scalar as a product with its
    # reciprocal, which is not the correctly rounded quotient
    scale = torch.where(amax > 0.0, amax / torch.full_like(amax, 127.0), zero)
    nonzero = scale != 0.0
    inv = torch.where(nonzero, torch.div(torch.ones_like(scale), torch.where(nonzero, scale, 1.0)), zero)
    t = x * inv[..., None]
    # round half away from zero (Rust f32::round), not torch.round's half-to-even
    q = torch.where(t >= 0.0, torch.floor(t + 0.5), torch.ceil(t - 0.5)).clamp_(-128, 127)
    codes = torch.where(nonzero[..., None], q, 0.0).to(torch.int8)
    return codes.reshape(r, k), scale.to(torch.float16).float()


def _check_cols(cols: int, block: int) -> None:
    if cols % block:
        raise ValueError(f"cols {cols} not a multiple of {block}")


def as_payload(payload, device=None) -> torch.Tensor:
    """A payload (bytes-like, or a uint8 tensor) as a 1-D uint8 tensor on
    `device` (None: where it is; the CPU for bytes)."""
    if not isinstance(payload, torch.Tensor):
        payload = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if len(payload) else (
            torch.empty(0, dtype=torch.uint8))
    return payload.to(device) if device is not None else payload


def _blocks(payload, block_bytes: int, device=None) -> torch.Tensor:
    return as_payload(payload, device).reshape(-1, block_bytes)


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """[n] f32 holding f16 values → [n, 2] uint8, little-endian."""
    return x.to(torch.float16).view(torch.uint8).reshape(-1, 2)


def _f16_of(b: torch.Tensor) -> torch.Tensor:
    """[n, 2] uint8 → [n] f32."""
    return b.contiguous().view(torch.float16).reshape(-1).float()


def to_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes (its data, wherever it lies)."""
    return t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()


def quantize_q8_0(weights: torch.Tensor, rows: int, cols: int) -> bytes:
    """Row-major [rows, cols] float → Q8_0 payload bytes, the reference's
    bytes (quantized where the weights lie)."""
    _check_cols(cols, Q8_BLOCK)
    codes, scales = q8_rows(weights.reshape(rows, cols))
    return to_bytes(torch.cat([_f16_bytes(scales.reshape(-1)),
                               codes.reshape(-1, Q8_BLOCK).view(torch.uint8)], dim=1))


def q8_rows_from_payload(payload, rows: int, cols: int, device=None):
    """A Q8_0 payload → (codes [rows, cols] int8, scales [rows, cols/32]
    f32), what q8_rows returns for the weights it was made from."""
    blocks = _blocks(payload, Q8_BLOCK_BYTES, device)
    codes = blocks[:, 2:].contiguous().view(torch.int8).reshape(rows, cols)
    return codes, _f16_of(blocks[:, :2]).reshape(rows, cols // Q8_BLOCK)


def dequantize_q8_0(payload, rows: int, cols: int, device=None) -> torch.Tensor:
    """[rows, cols] f32: code × the f16 scale."""
    codes, scales = q8_rows_from_payload(payload, rows, cols, device)
    return (codes.float().reshape(-1, Q8_BLOCK) * scales.reshape(-1, 1)).reshape(rows, cols)


def _pack_q4k_scales(sc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[nb, 8] 6-bit scales + [nb, 8] 6-bit mins → [nb, 12] uint8 (ggml's
    packing: sub-blocks 0-3 in the low 6 bits of bytes 0-3 and 4-7, 4-7 as
    nibbles in bytes 8-11 with their high 2 bits in the top of bytes 0-7)."""
    sc, m = sc.long() & 63, m.long() & 63
    out = torch.cat([sc[:, :4] | ((sc[:, 4:] >> 4) << 6),
                     m[:, :4] | ((m[:, 4:] >> 4) << 6),
                     (sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)], dim=1)
    return out.to(torch.uint8)


def _unpack_q4k_scales(packed: torch.Tensor):
    """[nb, 12] uint8 → (sc [nb, 8], m [nb, 8]) int64 (ggml get_scale_min_k4)."""
    p = packed.long()
    sc = torch.cat([p[:, 0:4] & 63, (p[:, 8:12] & 0xF) | ((p[:, 0:4] >> 6) << 4)], dim=1)
    m = torch.cat([p[:, 4:8] & 63, (p[:, 8:12] >> 4) | ((p[:, 4:8] >> 6) << 4)], dim=1)
    return sc, m


def quantize_q4_k(weights: torch.Tensor, rows: int, cols: int) -> bytes:
    """Row-major [rows, cols] float → Q4_K payload bytes (144 a block)."""
    _check_cols(cols, QK_K)
    codes, d, dmin, sc, m = q4k_blocks(weights.reshape(rows, cols))
    pairs = codes.reshape(-1, 4, 2, 32)  # per 64 values: the low 32, then the high 32
    qs = (pairs[:, :, 0] | (pairs[:, :, 1] << 4)).reshape(-1, 128)
    return to_bytes(torch.cat([_f16_bytes(d), _f16_bytes(dmin), _pack_q4k_scales(sc, m), qs], dim=1))


def q4k_parts_from_payload(payload, device=None):
    """A Q4_K payload → q4k_blocks' parts (codes, d, dmin, sc, m)."""
    blocks = _blocks(payload, Q4K_BLOCK_BYTES, device)
    qs = blocks[:, 16:].reshape(-1, 4, 1, 32)
    codes = torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(-1, QK_K)
    sc, m = _unpack_q4k_scales(blocks[:, 4:16])
    return codes, _f16_of(blocks[:, 0:2]), _f16_of(blocks[:, 2:4]), sc, m


def q4k_rows_from_payload(payload, rows: int, cols: int, device=None):
    """A Q4_K payload → what q4k_rows returns for its weights."""
    return _q4k_decoded(rows, cols, *q4k_parts_from_payload(payload, device))


def dequantize_q4_k(payload, rows: int, cols: int, device=None) -> torch.Tensor:
    """[rows, cols] f64, as NumPy computes it (f32 × int32 promotes to
    f64): d·sc·q − dmin·m."""
    codes, s, b = q4k_rows_from_payload(payload, rows, cols, device)
    vals = codes.double().reshape(-1, Q4K_SUB) * s.double().reshape(-1, 1) - b.double().reshape(-1, 1)
    return vals.reshape(rows, cols)


def quantize_q6_k(weights: torch.Tensor, rows: int, cols: int) -> bytes:
    """Row-major [rows, cols] float → Q6_K payload bytes (210 a block)."""
    _check_cols(cols, QK_K)
    codes, d, sc = q6k_blocks(weights.reshape(rows, cols))
    a = codes.reshape(-1, 2, 4, 32)  # per 128 values, four runs of 32
    low, high = a & 0xF, a >> 4
    ql = torch.stack([low[:, :, 0] | (low[:, :, 2] << 4), low[:, :, 1] | (low[:, :, 3] << 4)], dim=2)
    qh = high[:, :, 0] | (high[:, :, 1] << 2) | (high[:, :, 2] << 4) | (high[:, :, 3] << 6)
    scales = sc.to(torch.int8).view(torch.uint8)
    return to_bytes(torch.cat([ql.reshape(-1, 128), qh.reshape(-1, 64), scales, _f16_bytes(d)], dim=1))


def q6k_parts_from_payload(payload, device=None):
    """A Q6_K payload → q6k_blocks' parts (codes, d, sc)."""
    blocks = _blocks(payload, Q6K_BLOCK_BYTES, device)
    ql = blocks[:, :128].reshape(-1, 2, 2, 32)
    qh = blocks[:, 128:192].reshape(-1, 2, 32)
    lo = [ql[:, :, 0] & 0xF, ql[:, :, 1] & 0xF, ql[:, :, 0] >> 4, ql[:, :, 1] >> 4]
    codes = torch.stack([lo[i] | (((qh >> (2 * i)) & 3) << 4) for i in range(4)], dim=2).reshape(-1, QK_K)
    sc = blocks[:, 192:208].contiguous().view(torch.int8).float()
    return codes, _f16_of(blocks[:, 208:210]), sc


def q6k_rows_from_payload(payload, rows: int, cols: int, device=None):
    """A Q6_K payload → what q6k_rows returns for its weights."""
    return _q6k_decoded(rows, cols, *q6k_parts_from_payload(payload, device))


def dequantize_q6_k(payload, rows: int, cols: int, device=None) -> torch.Tensor:
    """[rows, cols] f32: (d·sc)·(q − 32)."""
    codes, s = q6k_rows_from_payload(payload, rows, cols, device)
    vals = s.reshape(-1, 1) * (codes.float() - 32.0).reshape(-1, Q6K_SUB)
    return vals.reshape(rows, cols)


_CODECS = {
    "Q8_0": (quantize_q8_0, dequantize_q8_0, Q8_BLOCK),
    "Q4_K": (quantize_q4_k, dequantize_q4_k, QK_K),
    "Q6_K": (quantize_q6_k, dequantize_q6_k, QK_K),
}


def quantize(dtype: str, weights: torch.Tensor, rows: int, cols: int) -> bytes:
    """ggml payload bytes of `weights`, quantized where they lie (the
    reference's native/quant.cpp path is not carried over: the card runs
    these on the device)."""
    return _CODECS[dtype][0](weights, rows, cols)


def dequantize(dtype: str, payload, rows: int, cols: int, device=None) -> torch.Tensor:
    return _CODECS[dtype][1](payload, rows, cols, device)


def block_size(dtype: str) -> int:
    return _CODECS[dtype][2]
