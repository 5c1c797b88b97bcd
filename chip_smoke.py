#!/usr/bin/env python3
"""Drive the PyTorch port (dsocr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (nothing is caught):

1. env      torch/CUDA versions and the card's name and power limit;
2. build    nvcc of dsocr_tpu_torch/csrc/*.cu into one shared library;
3. kernels  each hand-written kernel against its plain PyTorch twin at
            the main path's shapes: max abs error against the stated
            tolerance, kernel, plain and library device milliseconds per
            call (CUDA events around 10 calls queued behind a GPU sleep,
            median of 3; the library call is one PyTorch call computing the
            same function, timed here and used nowhere in the port), and
            the bound: the larger of the bytes the call must move over
            3.35 TB/s and its operations over the peak rate of their type;
            sam_flash_attention at one page's views (BH 12 at S 4096, BH 72
            at S 1600), at the engine's launches (BH 48, BH 192) and at
            the 1280 view's 80 × 80 grid (S 6400, BH 12 and 48) and a
            128 × 128 grid past the staged bias's shared-memory budget (BH
            2), two launches bit-equal, bound 3xTF32 on the tensor cores
            with the f32 FMA bound beside it;
            flash_prefill_attention also at the profile's wave (B 16, S
            1024, no pads) and with pads at the tile boundaries 63/64/65,
            slot_decode_attention also at the serving step (16 rows of
            904-1031 positions in a 1536-position cache) and with rows
            ending on either side of a split boundary, bf16 and int8; two
            launches of either attention, and of the paged attend, must
            give the same bits;
            the dense expert sweeps of the three formats (gate+up and down
            of one MoE layer at N 16) and their gather tier at
            GATHER_DRAWS (6, 24 and 60 routed selections, 24 and 60 that
            share one top-6; bound: the distinct experts' bytes), two
            launches bit-equal;
            q8_matmul, q4k_matmul and q6k_matmul at ROW_CASES (the lm_head
            at N 16; qkv at N 1, 16, 1024 and 16384: the decode GEMV and
            the dequant pass + wgmma GEMM; shared down at N 16), two
            launches bit-equal, library time torch.matmul on the bf16
            weights dequantized outside the timing;
            the Q8_0 quantizer on the card bit for bit against its CPU run
            on a full-width expert stack, and the Q4_K and Q6_K quantizers
            on 8 experts of one; the paged KV write and attend (16 rows of
            ~968 tokens in 9 pages of 128 each, int8 and bf16 pools; the
            library time of the attend is SDPA over the rows' pages gathered
            outside the timing); the KV writes from the decoder's token,
            slot_kv_write and paged_kv_write (int8 and bf16 caches, bf16
            and f32 tokens with an all-zero row and rounding ties from
            kv_tokens, every plane torch.equal to the twin's, beside them
            route_ms: quantize_kv_int8 and the codes-in write, as the step
            wrote before); the megafused Q8_0 chain (one MoE layer at 16,
            11 and 32 rows, tolerance megafused_tol per element, two
            launches bit-equal, beside it the two-kernel sweep it replaces,
            sweep_ms) and
            gather_matmul (the split layout's expert gather, gate/up and
            down stacks at 96 and 12 rows, bf16 and f32, two launches
            bit-equal; library time index_select + bmm);
    host_prep  host image prep of the seeded page (below) on the card's
            host: engine.prepare_vision_input with the native resampler and
            with its NumPy twin, the global view and every tile bit-equal,
            and seeded images at a few sizes resized both ways bit-equal;
            seconds a page of each (median of 3), a 16-page prep wave
            through the engine's prefill (its thread pool), os.cpu_count();
4. serve    DeepSeek-OCR v1 at full width (DeepseekOcrConfig(), bf16
            weights from a seeded torch.Generator, int8 KV): 16 requests
            of 128 new tokens through ContinuousScheduler.submit over 16
            slots at the scheduler's defaults (speculative chunk dispatch
            on), 128-step chunks, on a seeded 1756×2852 page in 1024/640
            crop mode, after a warm-up of 2 requests × 8 tokens (the
            process's one: later bursts, each engine's first included, run
            warm). The launch counters are zeroed just before and read
            just after; every kernel of the bf16 path must have launched,
            the codes-in writes (slot_kv_update, paged_kv_update) not:
            every burst's decode step quantizes its token in the write.
            Every serving line (4-4h) gives the scheduler's
            speculated_chunks and stage_ms (the stage totals of a
            BenchRecorder installed for the burst).
            Then the profile of that engine at 16 rows (profile_phase):
            a prefill wave and decode steps, their host and device time,
            the kernel launches a decode step, the largest kernels, and
            the host time spent in the kernel
            wrappers against the rest of the step; and its tower line
            (tower_profile): the vision towers of 16 pages, device ms, the
            SAM attention's share, host ms around the synchronized call;
    serve_spec  the same burst in 32-step chunks, where the speculation
            gate opens (at 128-step chunks of 128 tokens it cannot):
            speculated_chunks must be > 0;
    sched   the same engine, 4 requests of 32 tokens in 8-step chunks:
            streamed against plain (equal tokens, each callback extending
            the last), the page twice with DSOCR_PREFIX_CACHE=4 (one hit,
            equal tokens, the hit's TTFT beside the miss's), max_inflight=2
            with 4 submitted (2 shed, 2 complete), one injected chunk fault
            (recoveries 1, tokens equal to the plain burst's), and the same
            with DSOCR_PAGED_KV=1 (every page back afterwards);
    split   the same engine's decoder in the reference's split layout (its
            state split; fusing it gives the engine's weights) over a
            contiguous KVCache: the page's 904-token packet prefilled, then
            32 greedy steps fed the fused decoder's tokens: logits
            bit-equal to the fused decoder's and the same greedy tokens;
            then moe_apply(gather_threshold=N), N = 2, 4, 16, at
            layer 1's experts against the same call on the CPU:
            gather_matmul must launch;
    decode  single-request decode, engine.decode of the page with 128 new
            greedy tokens: prompt tokens, prefill seconds, ms per step,
            tok/s, peak memory, with the card's name and power limit; for
            this bf16 engine, and again after 4c for the Q8_0 one;
4b. serve_q8         the same with packed Q8_0 decoder weights (quantized
            on the card from the same seed): 16 requests × 128 tokens over
            16 slots, 16·6 = 96 selections > 64 experts, so decode runs the
            dense all-expert tier: q8_matmul, q8_dense_experts and
            q8_dense_experts_perx must launch, with the attention kernels;
            then its profile;
4c. serve_q8_gather  the same Q8_0 engine, 4 requests × 32 tokens over 4
            slots (24 selections ≤ 64): q8_gather_matmul must launch;
            then the same burst again under torch.profiler with every
            gather launch's idx kept (`_trace` line: the gather tier's
            device ms and launches, and the distinct experts of the
            launches of each selection count);
4d. serve_q4k        packed Q4_K decoder weights from the same seed (the
            routed experts' down projection, in dim 896, packs as Q8_0):
            16 requests × 128 tokens over 16 slots, the dense tier:
            q4k_matmul, q4k_dense_experts and q8_dense_experts_perx must
            launch; then its profile;
4e. serve_q4k_gather the same Q4_K engine, 4 requests × 32 tokens over 4
            slots: q4k_gather_matmul and q8_gather_matmul must launch;
            then its `_trace` line;
4f. serve_q6k        packed Q6_K decoder weights from the same seed (the
            experts' down projection again Q8_0): 16 requests × 128 tokens
            over 16 slots, the dense tier: q6k_matmul, q6k_dense_experts
            and q8_dense_experts_perx must launch; then its profile;
4g. serve_q6k_gather the same Q6_K engine, 4 requests × 32 tokens over 4
            slots: q6k_gather_matmul and q8_gather_matmul must launch;
            then its `_trace` line;
4h. serve_q8_paged   the Q8_0 engine of 4b with DSOCR_PAGED_KV=1,
            DSOCR_Q8_MEGAFUSED=1 and DSOCR_POOL_PAGES=108: 16 requests × 128
            tokens over 16 slots from a pool that holds 12 rows (9 pages of
            128 each), so 4 requests wait for pages. paged_kv_write,
            paged_decode_attention, q8_moe_megafused and q8_matmul must
            launch, the slot kernels, the codes-in writes and the
            two-kernel sweep must not; the
            line gives the pool's pages and bytes against the contiguous
            cache's, the occupancy, and how many requests' tokens equal 4b's
            (not required: megafused sums the experts in another order);
            then its profile, with a paged runner;
5. parity   the tiny config in f32 with one set of weights, served on the
            card (kernels) and on the CPU (twins): greedy tokens must match;
            again with Q8_0 weights (moe_intermediate_size 32), and with
            Q4_K and with Q6_K weights (hidden 256, moe_intermediate_size
            32: K-quant gate+up, Q8_0 down), each at 2 slots (gather tier)
            and 4 slots (dense tier), f32 and int8 KV; and all-Q4_K and
            all-Q6_K experts (moe_intermediate_size 256) at 4 slots, the
            path that reaches q4k_/q6k_dense_experts_perx (DeepSeek's
            full-width down projection is Q8_0); and the Q8_0 config at 4
            slots with paged KV and the megafused chain, f32 and int8 KV,
            and with a pool of 2 pages, so that a request waits for pages;
            and engine.decode with and without the cache, f32 and Q8_0.

Every phase line carries t_s, the script's seconds when it was printed.
The seeded page's host prep (page_packet) runs once for the script;
outside the bursts' windows each phase reuses it.

Then a line with the script's total seconds, a {"kernels": [...]} summary
line (launches: the sum over the nine serving bursts, the sched phase, the
split phase and the two decode phases), the nvidia-smi
line, and last
{"ok": true, "device": {...}}. Without a CUDA card, or without the
dsocr_tpu_torch package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
MAX_NEW = 128
N_REQUESTS = 16
N_SLOTS = 16
CHUNK = 128
PROFILE_ROWS, PROFILE_WAVE, PROFILE_WINDOW = 16, 1024, 16  # rows, positions per row, steps
TOWER_PAGES = 16  # the profile's tower line: the vision towers of a 16-page burst
PROMPT = "<image>\nFree OCR."
PARITY_SEED = 7
# Seed 7's Q6_K weights put a greedy near-tie in the int8-KV runs: summing
# the same bf16 products in another order flips a token, on the CPU as on
# the card. The Q6_K parity engines draw from seed 8, which
# tests/test_torch_q6k.py holds clear of such ties.
Q6K_PARITY_SEED = 8
IMAGE_TOKEN_ID = 128815  # the DeepSeek tokenizer's <image> id
# phase 3's row-layout matmul cases (case, N, K, M), the same for every
# format; the lm_head first (the summary line takes its times)
ROW_CASES = (("lm_head", 16, 1280, 129280), ("qkv", 1, 1280, 3840), ("qkv", 16, 1280, 3840),
             ("qkv", 1024, 1280, 3840), ("qkv", 16384, 1280, 3840), ("shared_down", 16, 1792, 1280))


class BenchTokenizer:
    """Deterministic stand-in tokenizer (dsocr_tpu/bench/workload.py)."""

    def encode(self, text):
        return [(ord(c) * 7 + 13) % 120000 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def token_to_id(self, token):
        return IMAGE_TOKEN_ID if token == "<image>" else None


class TinyTokenizer:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def require(cond, message: str) -> None:
    """A failed check ends the run (raises; never skipped, unlike assert)."""
    if not cond:
        raise RuntimeError(message)


def emit(obj) -> None:
    """One JSON line; a phase's line also gets t_s, the script's seconds
    when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_us(event) -> float:
    """A torch.profiler event's own device microseconds."""
    value = getattr(event, "self_device_time_total", None)
    return float(value if value is not None else event.self_cuda_time_total)


def time_ms(fn, reps: int = 10, batches: int = 3) -> float:
    """Device milliseconds per fn() call: CUDA events around reps calls
    launched back to back behind a GPU sleep that outlasts their launching,
    so the host's time in a kernel wrapper (30-75 us a call, most of a small
    decode kernel's) is not counted; the median over batches, after a
    warm-up batch that also times the launching."""
    import torch

    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(host_s * 2e9 * 2) + 10 ** 6  # twice the launch time at <= 2 GHz
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense bf16 and TF32 tensor cores; f32 off them
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes the call must move (each input read once, each output
    written once) over the memory rate and its operations over the peak
    rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bf16_tol(ref) -> float:
    """One bf16 ulp at the reference's largest magnitude: both sides round
    their f32 result to bf16 once."""
    return float(ref.float().abs().max()) * 2.0 ** -7 + 1e-5


def q8_tol(bound) -> float:
    """f32 reassociation of exact bf16 products: 1e-5 of the largest sum of
    term magnitudes (|bf16 x| @ |W|)."""
    return float(bound.max()) * 1e-5


def megafused_tol(torch, x, weights, gu_codes, gu_scales, dn_codes, dn_scales):
    """Per-element tolerance of q8_moe_megafused [N, H] against another
    summation order of the same chain. In the down product and the combine,
    1e-5 of the sum of term magnitudes, as for the other Q8_0 kernels. In
    gate+up the sums (exact bf16 products, f32 adds) move by far less,
    ~1e-7 of it at these depths (3.3e-6 at H 768 on the CPU): what matters
    is whether that, allowed 1e-6 of the sum of magnitudes, and silu's own
    rounding, allowed 1e-6, can flip the bf16 rounding of an inter element.
    Where it can, the element may differ by one bf16 ulp, which |w|·|Wd|
    carries to the output."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16

    def deq(codes, scales):  # in-major [E, K, M] → f32 of bf16(code · scale)
        return (codes.float() * scales.repeat_interleave(32, dim=-2)).to(bf16).float()

    xb = x.to(bf16).float()[None]
    wgu = deq(gu_codes, gu_scales)
    gate, up = torch.chunk(torch.matmul(xb, wgu), 2, dim=-1)
    d_gate, d_up = torch.chunk(1e-6 * torch.matmul(xb.abs(), wgu.abs()), 2, dim=-1)
    del wgu
    act = F.silu(gate)
    pre = act * up
    slack = 1.1 * up.abs() * d_gate + act.abs() * d_up + 1e-6 * pre.abs()  # |silu'| < 1.1
    flips = ((pre + slack).to(bf16).float() - (pre - slack).to(bf16).float()).abs()
    terms = flips + 1e-5 * pre.to(bf16).float().abs()
    return (weights.abs()[:, :, None] * torch.matmul(terms, deq(dn_codes, dn_scales).abs())).sum(0) + 1e-6


def kv_tokens(torch, qkv, NKV, D):
    """The decoder's new K and V for a KV write from its projection qkv
    [B, 1, 3·NKV·D]: [B, NKV, 1, D] views of it, as DeepseekDecoder._qkv
    splits it (so not contiguous), with the quantizer's edge cases written
    in: row 0's first head all zeros (scale 0, safe 1); row 1's first head
    amax 127 (scale 1) and row 2's last head amax 63.5 (scale 0.5), their
    other values on rounding ties (x / scale = k + 0.5), exact in bf16."""
    B = qkv.shape[0]
    _, k, v = torch.split(qkv, NKV * D, dim=-1)
    k, v = (t.reshape(B, 1, NKV, D).transpose(1, 2) for t in (k, v))
    d = torch.arange(D, device=qkv.device, dtype=torch.float32)
    ties = (d % 200 - 100) + 0.5
    ties[0] = 127.0
    halves = ((d % 100) - 50) * 0.5 + 0.25
    halves[0] = 63.5
    for t, sign in ((k, 1.0), (v, -1.0)):
        if B > 0:
            t[0, 0, 0] = 0.0
        if B > 1:
            t[1, 0, 0] = sign * ties
        if B > 2:
            t[2, NKV - 1, 0] = sign * halves
    return k, v


def check_q8_kernels(torch, K, record, randn):
    """Phase 3, Q8_0: the four dequant-matmul wrappers against their twins
    at the main path's shapes, and the quantizer on the card against its
    CPU run."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    # lm_head 1280 → 129280 at N = 16; qkv 1280 → 3840 at one request's
    # decode, the 16-slot step, a 1024-row prefill and the 16 × 1024 wave;
    # shared down (K 1792) at the step. Two launches must give the same bits.
    for case, n, k, m in ROW_CASES:
        p = quantize_plain(randn(k, m, dtype=torch.bfloat16, std=k ** -0.5))
        codes, scales = p["codes"], p["scales"]
        x = randn(n, k, dtype=torch.bfloat16)
        out = K.q8_matmul(x, codes, scales)
        require(torch.equal(out, K.q8_matmul(x, codes, scales)),
                f"q8_matmul {case} N={n}: two launches on the same inputs differ")
        ref = K.q8_matmul_plain(x, codes, scales)
        w = codes.float() * scales.repeat_interleave(32, dim=1)
        tol = q8_tol(torch.matmul(bf16_abs(x), w.abs().t()))
        wt = w.to(torch.bfloat16).t()
        del w
        record("q8_matmul", f"{case} N={n} K={k} M={m}", float((out - ref).abs().max()), tol,
               time_ms(lambda: K.q8_matmul(x, codes, scales)),
               time_ms(lambda: K.q8_matmul_plain(x, codes, scales)),
               time_ms(lambda: torch.matmul(x, wt)),
               bound(nbytes(x, codes, scales, out), 2 * n * k * m, "bf16"), deterministic=True)
        del out, ref, wt

    # expert stacks of one MoE layer: gate+up [64, 1280, 1792], down [64, 896, 1280]
    t0 = time.perf_counter()
    w_gu = randn(64, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5)
    gu = quantize_expert_stack(w_gu)
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    twin = quantize_expert_stack(w_gu.cpu())
    same = torch.equal(gu["codes"].cpu(), twin["codes"]) and torch.equal(gu["scales"].cpu(), twin["scales"])
    emit({"phase": "kernels", "kernel": "quantize_expert_stack", "case": "E=64 K=1280 M=1792 bf16",
          "bit_exact": same, "ms": quant_ms})
    require(same, "the Q8_0 quantizer on the card differs from its CPU run")
    del w_gu, twin
    dn = quantize_expert_stack(randn(64, 896, 1280, dtype=torch.bfloat16, std=896 ** -0.5))

    def deq(p):
        return p["codes"].float() * p["scales"].repeat_interleave(32, dim=1)

    check_expert_kernels(torch, record, randn, "q8", K.q8_gather_matmul, K.q8_gather_matmul_plain,
                         K.q8_dense_experts, K.q8_dense_experts_plain, K.q8_dense_experts_perx,
                         K.q8_dense_experts_perx_plain, gu, dn, deq, ("codes", "scales"))
    check_megafused(torch, K, record, randn, gu, dn)


def check_megafused(torch, K, record, randn, gu, dn):
    """q8_moe_megafused on one full-width MoE layer at N 16 (the serving
    step), 11 and 32 rows, routed top-6 by a seeded softmax router:
    per-element tolerance megafused_tol, two launches bit-equal; beside it
    the two-kernel sweep it replaces (q8_dense_experts, silu·up,
    q8_dense_experts_perx, the combine), sweep_ms. No single PyTorch call
    computes the chain: no library time."""
    import torch.nn.functional as F

    from dsocr_tpu_torch.ops.kernels import dequant_matmul

    def occupancy(*shape):  # what the card holds of the launch (None from a tree that cannot say)
        query = getattr(dequant_matmul, "q8_moe_megafused_occupancy", None)
        return query(*shape) if query else None

    E, topk = gu["codes"].shape[0], 6
    H, MI = gu["codes"].shape[1], dn["codes"].shape[1]
    for N in (16, 11, 32):
        x = randn(N, H, dtype=torch.bfloat16)
        weights, idx = torch.topk(torch.softmax(randn(N, E), dim=-1), topk, dim=-1)
        w = torch.zeros((E, N), device=x.device).index_put_(
            (idx.reshape(-1), torch.arange(N, device=x.device).repeat_interleave(topk)),
            weights.reshape(-1), accumulate=True)
        args = (x, w, gu["codes"], gu["scales"], dn["codes"], dn["scales"])
        out = K.q8_moe_megafused(*args)
        again = K.q8_moe_megafused(*args)
        require(torch.equal(out, again), f"q8_moe_megafused N={N}: two launches on the same inputs differ")
        ref = K.q8_moe_megafused_plain(*args)
        tol = megafused_tol(torch, *args)
        require(bool(((out - ref).abs() <= tol).all()),
                f"q8_moe_megafused N={N}: outside the per-element tolerance")

        def sweep():
            gates, ups = torch.chunk(K.q8_dense_experts(x, gu["codes"], gu["scales"]), 2, dim=-1)
            outs = K.q8_dense_experts_perx((F.silu(gates) * ups).to(x.dtype), dn["codes"], dn["scales"])
            sel = outs[idx, torch.arange(N, device=x.device)[:, None]]
            return (sel * weights[..., None]).sum(dim=1)

        record("q8_moe_megafused", f"N={N} E={E} H={H} MI={MI} top-{topk}", float((out - ref).abs().max()),
               float(tol.max()), time_ms(lambda: K.q8_moe_megafused(*args)),
               time_ms(lambda: K.q8_moe_megafused_plain(*args)), None,
               bound(nbytes(*args, out), 2 * E * N * (H * 2 * MI + MI * H), "bf16"),
               sweep_ms=time_ms(sweep), deterministic=True,
               clusters_resident_blocks_per_sm=occupancy(N, H, MI, E))
        del out, again, ref, tol


# the gather tier's draws timed in phase 3, (selections, top-6 sets): a
# top-6 of its own for each token at the burst's largest gather launch
# (10 rows × top-6), 4 serving slots and one request's decode; then 4 and
# 10 tokens that share one top-6, as identical requests route (the
# bursts here serve one page: their 24-selection launches hold 6–8
# distinct experts)
GATHER_DRAWS = ((60, 10), (24, 4), (6, 1), (24, 1), (60, 1))
GATHER_TOPK = 6


def routed_idx(torch, tokens, E, generator, sets=None):
    """A router's selections [tokens · top-6] int32: each token's experts
    distinct, `sets` top-6 draws (default one a token) taken in turn."""
    draws = [torch.randperm(E, generator=generator, device="cuda")[:GATHER_TOPK] for _ in range(sets or tokens)]
    return torch.stack([draws[t % len(draws)] for t in range(tokens)]).reshape(-1).to(torch.int32)


def gather_case(sel, sets):
    """The label of a GATHER_DRAWS entry."""
    return f"{sel} rows" + ("" if sets == sel // GATHER_TOPK else f" {sets} top-6")


def check_expert_kernels(torch, record, randn, fmt, gather, gather_plain, dense, dense_plain, perx,
                         perx_plain, gu, dn, deq, keys):
    """The gather, dense and per-expert wrappers of one format against
    their twins: gather at GATHER_DRAWS' routed selections of both
    stacks, the dense pair at N = 16 (csrc/expert_sweep.cu), each launched
    twice and bit-equal. `gu` and `dn` are packed [E, K, M] stacks (dn may
    be a stand-in), `deq` dequantizes one to f32 [E, K, M]. A gather's
    bound counts the bytes of the distinct experts it selects."""

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    gen_idx = torch.Generator(device="cuda").manual_seed(1)
    for case, p in (("gateup", gu), ("down", dn)):
        packed = tuple(p[key] for key in keys)
        w = deq(p)
        E, k, m = w.shape
        for sel, sets in GATHER_DRAWS:
            x = randn(sel, k, dtype=torch.bfloat16)
            idx = routed_idx(torch, sel // GATHER_TOPK, E, gen_idx, sets)
            out = gather(x, *packed, idx)
            require(torch.equal(out, gather(x, *packed, idx)),
                    f"{fmt}_gather_matmul {case} {gather_case(sel, sets)}: two launches on the same inputs differ")
            ref = gather_plain(x, *packed, idx)
            bnd = torch.bmm(bf16_abs(x)[:, None], w[idx.long()].abs())
            wg = w[idx.long()].to(torch.bfloat16)  # the library call gets its weights gathered
            used = torch.unique(idx).numel()  # bytes of the experts this run selects
            record(f"{fmt}_gather_matmul", f"{case} {gather_case(sel, sets)} E={E} K={k} M={m}",
                   float((out - ref).abs().max()), q8_tol(bnd),
                   time_ms(lambda: gather(x, *packed, idx)),
                   time_ms(lambda: gather_plain(x, *packed, idx)),
                   time_ms(lambda: torch.bmm(x[:, None], wg)),
                   bound(nbytes(x, idx, out) + nbytes(*packed) * used // E, 2 * sel * k * m, "bf16"),
                   deterministic=True, distinct_experts=used)
            del out, ref, bnd, wg
        del w

    packed = tuple(gu[key] for key in keys)
    w = deq(gu)
    E, k, m = w.shape
    x = randn(16, k, dtype=torch.bfloat16)
    out = dense(x, *packed)
    require(torch.equal(out, dense(x, *packed)),
            f"{fmt}_dense_experts: two launches on the same inputs differ")
    ref = dense_plain(x, *packed)
    wb = w.to(torch.bfloat16)
    record(f"{fmt}_dense_experts", f"gateup N=16 E={E} K={k} M={m}", float((out - ref).abs().max()),
           q8_tol(torch.matmul(bf16_abs(x)[None], w.abs())),
           time_ms(lambda: dense(x, *packed)), time_ms(lambda: dense_plain(x, *packed)),
           time_ms(lambda: torch.matmul(x[None], wb)),
           bound(nbytes(x, out, *packed), 2 * E * 16 * k * m, "bf16"), deterministic=True)
    del out, ref, wb, w
    packed = tuple(dn[key] for key in keys)
    w = deq(dn)
    E, k, m = w.shape
    xe = randn(E, 16, k, dtype=torch.bfloat16)
    out = perx(xe, *packed)
    require(torch.equal(out, perx(xe, *packed)),
            f"{fmt}_dense_experts_perx: two launches on the same inputs differ")
    ref = perx_plain(xe, *packed)
    wb = w.to(torch.bfloat16)
    record(f"{fmt}_dense_experts_perx", f"down N=16 E={E} K={k} M={m}", float((out - ref).abs().max()),
           q8_tol(torch.matmul(bf16_abs(xe), w.abs())),
           time_ms(lambda: perx(xe, *packed)), time_ms(lambda: perx_plain(xe, *packed)),
           time_ms(lambda: torch.matmul(xe, wb)),
           bound(nbytes(xe, out, *packed), 2 * E * 16 * k * m, "bf16"), deterministic=True)


def check_kquant_kernels(torch, K, record, randn, method):
    """Phase 3, Q4_K or Q6_K: the four wrappers of the format against their
    twins at the main path's shapes (the per-expert sweep at a stand-in
    shape: DeepSeek's down projection is Q8_0), and the quantizer on the
    card against its CPU run on 8 experts of a full-width gate+up stack."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain
    from dsocr_tpu_torch.ops.kernels import kquant_matmul

    fmt = method.replace("_", "")  # q4k, q6k
    parts = kquant_matmul.Q4K_PARTS if method == "q4_k" else kquant_matmul.Q6K_PARTS
    keys = tuple(name for name, _, _ in parts)
    dequant = getattr(kquant_matmul, f"dequant_{fmt}")
    matmul, matmul_plain = getattr(K, f"{fmt}_matmul"), getattr(K, f"{fmt}_matmul_plain")

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    # the Q8_0 row cases (check_q8_kernels); two launches must give the same bits
    for case, n, k, m in ROW_CASES:
        p = quantize_plain(randn(k, m, dtype=torch.bfloat16, std=k ** -0.5), method)
        packed = tuple(p[key] for key in keys)
        x = randn(n, k, dtype=torch.bfloat16)
        out = matmul(x, *packed)
        require(torch.equal(out, matmul(x, *packed)),
                f"{fmt}_matmul {case} N={n}: two launches on the same inputs differ")
        ref = matmul_plain(x, *packed)
        w = dequant(*packed, -1).float()
        tol = q8_tol(torch.matmul(bf16_abs(x), w.abs().t()))
        wt = w.to(torch.bfloat16).t()
        del w
        record(f"{fmt}_matmul", f"{case} N={n} K={k} M={m}", float((out - ref).abs().max()), tol,
               time_ms(lambda: matmul(x, *packed)),
               time_ms(lambda: matmul_plain(x, *packed)),
               time_ms(lambda: torch.matmul(x, wt)),
               bound(nbytes(x, out, *packed), 2 * n * k * m, "bf16"), deterministic=True)
        del out, ref, wt

    w8 = randn(8, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = quantize_expert_stack(w8, method)
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    twin = quantize_expert_stack(w8.cpu(), method)
    same = all(torch.equal(card[key].cpu(), twin[key]) for key in keys)
    emit({"phase": "kernels", "kernel": "quantize_expert_stack", "case": f"{method} E=8 K=1280 M=1792 bf16",
          "bit_exact": same, "ms": quant_ms})
    require(same, f"the {method} quantizer on the card differs from its CPU run")
    del w8, card, twin

    gu = quantize_expert_stack(randn(64, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5), method)
    dn = quantize_expert_stack(randn(64, 1792, 1280, dtype=torch.bfloat16, std=1792 ** -0.5), method)

    def deq(p):
        return dequant(*(p[key] for key in keys), -2).float()

    kernels = [getattr(K, f"{fmt}_{name}{suffix}") for name in ("gather_matmul", "dense_experts",
                                                                "dense_experts_perx")
               for suffix in ("", "_plain")]
    check_expert_kernels(torch, record, randn, fmt, *kernels, gu, dn, deq, keys)


def check_kernels(torch, K):
    """Phase 3: every kernel against its twin at main-path shapes."""
    import torch.nn.functional as F

    from dsocr_tpu_torch.ops.kernels import _lib

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0, generator=None):
        return (torch.randn(shape, generator=generator or gen, device=dev) * std).to(dtype)

    cases = []

    def record(kernel, case, err, tol, ms, plain_ms, library_ms, bnd, **extra):
        line = {"phase": "kernels", "kernel": kernel, "case": case, "max_abs_err": err,
                "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], **extra}
        emit(line)
        require(err <= tol, f"{kernel} {case}: max abs err {err} > tol {tol}")
        cases.append(line)

    # SAM global attention: one 1024 global view (S = 4096, 1 view x 12
    # heads), one page's six 640 tiles (S = 1600, 72), and, last, the
    # engine's launches: 4 views (BH 48) and 16 tiles (BH 192) a call; q
    # pre-scaled, f32. Two launches must give the same bits. The bound is
    # 3xTF32 on the tensor cores (three TF32 products per f32 product, as
    # the kernel computes); the f32 FMA bound stands beside it. The launch
    # shapes draw from a generator of their own and run after every other
    # kernel, so the other cases' inputs, and the device memory they find
    # (the plain twin at BH 48 allocates ~13 GB), do not depend on them.
    def check_sam(bh, s, src):  # a square grid of S = W² keys
        w = int(round(s ** 0.5))
        q, k, v = (randn(bh, s, 64, std=std, generator=src) for std in (0.125, 1.0, 1.0))
        bias_h, bias_w = (randn(bh, s, w, std=0.3, generator=src) for _ in range(2))
        args = (q, k, v, bias_h, bias_w)
        out = K.sam_flash_attention(*args, width=w)
        require(torch.equal(out, K.sam_flash_attention(*args, width=w)),
                "sam_flash_attention: two launches on the same inputs differ")
        ref = K.sam_flash_attention_plain(*args, width=w)
        err = float((out - ref).abs().max())
        del ref
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(bh, s, s)
        flops = 4 * bh * s * s * 64
        record("sam_flash_attention", f"BH={bh} S={s}", err, 1e-4,
               time_ms(lambda: K.sam_flash_attention(*args, width=w)),
               time_ms(lambda: K.sam_flash_attention_plain(*args, width=w)),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)),
               bound(nbytes(*args, out), 3 * flops, "tf32"),
               bound_f32_fma_ms=bound(nbytes(*args, out), flops, "f32")[0], deterministic=True)

    check_sam(12, 4096, gen)
    check_sam(72, 1600, gen)

    # decoder prefill: 10 heads of 128, bf16: S = 1792 with left padding;
    # the profile's wave (16 rows of 1024, no padding); pads at the tile
    # boundaries 63, 64, 65. Two launches must give the same bits.
    for b, pads, s in ((1, [0], 1792), (4, [0, 300, 7, 1000], 1792), (16, [0] * 16, 1024),
                       (3, [63, 64, 65], 256)):
        q, k, v = (randn(b, 10, s, 128, dtype=torch.bfloat16) for _ in range(3))
        pad = torch.tensor(pads, dtype=torch.int32, device=dev)
        scale = 128 ** -0.5
        out = K.flash_prefill_attention(q, k, v, pad, scale=scale)
        require(torch.equal(out, K.flash_prefill_attention(q, k, v, pad, scale=scale)),
                "flash_prefill_attention: two launches on the same inputs differ")
        ref = K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)
        err = float((out.float() - ref.float()).abs().max())
        pos = torch.arange(s, device=dev)
        mask = (pos[None, None, :, None] >= pos[None, None, None, :]) & (
            pos[None, None, None, :] >= pad[:, None, None, None])
        # a live query attends keys pad..i; a fully padded one averages all S
        keys = sum(p * s + (s - p) * (s - p + 1) // 2 for p in pads)
        label = f"pad_start={pads}" if any(pads) else "no pads"
        record("flash_prefill_attention", f"B={b} S={s} {label}", err, bf16_tol(ref),
               time_ms(lambda: K.flash_prefill_attention(q, k, v, pad, scale=scale)),
               time_ms(lambda: K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)),
               time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)),
               bound(nbytes(q, k, v, pad, out), 4 * 10 * 128 * keys, "bf16"), deterministic=True)
        del mask, q, k, v, out, ref

    # slot caches: L = 12, B = 16, NKV = 10, D = 128, S_max = 2560
    L, B, NKV, S, D = 12, 16, 10, 2560, 128
    lengths = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 0, S - 1
    layer = 5
    used = int((lengths.long() + 1).sum())  # positions the attend reads: [0, lengths[b]]
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        if quant:
            def codes(*shape):
                return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

            k_all, v_all = codes(L, B, NKV, S, D), codes(L, B, NKV, S, D)
            ks_all = randn(L, B, NKV, S).abs() * 0.02
            vs_all = randn(L, B, NKV, S).abs() * 0.02
            k_new, v_new = codes(B, NKV, D), codes(B, NKV, D)
            ks_new, vs_new = randn(B, NKV).abs() * 0.02, randn(B, NKV).abs() * 0.02
        else:
            k_all, v_all = randn(L, B, NKV, S, D, dtype=torch.bfloat16), randn(L, B, NKV, S, D, dtype=torch.bfloat16)
            ks_all = vs_all = ks_new = vs_new = None
            k_new, v_new = randn(B, NKV, D, dtype=torch.bfloat16), randn(B, NKV, D, dtype=torch.bfloat16)
        caches = (k_all, v_all, ks_all, vs_all)
        twins = tuple(None if t is None else t.clone() for t in caches)
        new = (k_new, v_new, ks_new, vs_new)
        K.slot_kv_update(*caches, *new, layer, lengths)
        K.slot_kv_update_plain(*twins, *new, layer, lengths)
        same = all(a is None or torch.equal(a, b) for a, b in zip(caches, twins))
        # no single PyTorch call writes the four planes: no library time
        record("slot_kv_update", f"{kind} B={B} S={S}", 0.0 if same else float("inf"), 0.0,
               time_ms(lambda: K.slot_kv_update(*caches, *new, layer, lengths)),
               time_ms(lambda: K.slot_kv_update_plain(*twins, *new, layer, lengths)),
               None, bound(2 * nbytes(*new) + nbytes(lengths), 0, "bf16"))

        check_slot_attend(torch, K, record, randn, q=randn(B, 10, 1, D, dtype=torch.bfloat16),
                          caches=caches, layer=layer, lengths=lengths, case=f"{kind} B={B} S={S}")
    del k_all, v_all, ks_all, vs_all, caches, twins
    check_kv_writes(torch, K, record, randn, "slot", (L, B, NKV, S), D, lengths, layer)
    # the serving step (16 rows of the page's packet, 904 prompt tokens and
    # up to 128 new, in a 1536-position slot cache), then rows that end on
    # either side of a split boundary, and a row of one position
    split = _lib.DECODE_SPLIT
    edges = [0, split - 2, split - 1, split, split + 1, 2 * split - 1, 2 * split, 2 * split + 1]
    for case, lengths in (("serving", torch.randint(904, 904 + 128, (B,), generator=gen, device=dev,
                                                    dtype=torch.int32)),
                          ("split edges", torch.tensor(edges * 2, dtype=torch.int32, device=dev))):
        S = 1536
        for quant in (False, True):
            if quant:
                caches = (torch.randint(-127, 128, (1, B, NKV, S, D), generator=gen, device=dev,
                                        dtype=torch.int8),
                          torch.randint(-127, 128, (1, B, NKV, S, D), generator=gen, device=dev,
                                        dtype=torch.int8),
                          randn(1, B, NKV, S).abs() * 0.02, randn(1, B, NKV, S).abs() * 0.02)
            else:
                caches = (randn(1, B, NKV, S, D, dtype=torch.bfloat16),
                          randn(1, B, NKV, S, D, dtype=torch.bfloat16), None, None)
            check_slot_attend(torch, K, record, randn, q=randn(B, 10, 1, D, dtype=torch.bfloat16),
                              caches=caches, layer=0, lengths=lengths,
                              case=f"{'int8' if quant else 'bf16'} B={B} S={S} {case} "
                                   f"lengths {int(lengths.min())}-{int(lengths.max())}")
            del caches
    check_gather_matmul(torch, K, record, randn, gen)
    check_paged_kernels(torch, K, record, randn, gen)
    check_q8_kernels(torch, K, record, randn)
    torch.cuda.empty_cache()
    for method in ("q4_k", "q6_k"):
        check_kquant_kernels(torch, K, record, randn, method)
        torch.cuda.empty_cache()
    launch_gen = torch.Generator(device=dev).manual_seed(1)
    check_sam(48, 4096, launch_gen)
    check_sam(192, 1600, launch_gen)
    torch.cuda.empty_cache()
    # the 1280 view's 80 × 80 grid (S 6400: one view's 12 heads, and the
    # engine's 4-view launch), and 128 × 128, past the shared-memory budget
    # of the staged bias rows (the kernel reads the bias per score there)
    for bh, s in ((12, 6400), (48, 6400), (2, 16384)):
        check_sam(bh, s, launch_gen)
        torch.cuda.empty_cache()
    return cases


def check_kv_writes(torch, K, record, randn, layout, lead, D, lengths, layer, tables=None):
    """The KV writes from the decoder's token (slot_kv_write or
    paged_kv_write: the int8 quantization in the kernel's body) on caches
    of shape `lead` + [D] (slot [L, B, NKV, S], paged [L, P, NKV, page]),
    int8 and bf16, tokens bf16 (the model's) and f32 from kv_tokens (the
    projection's views, an all-zero row and rounding ties): every plane
    torch.equal to the twin's (quantize_kv_int8, or the cast, then the
    plain write) on the same card. Beside the kernel's time, route_ms: the
    decode step's write before the kernel quantized, quantize_kv_int8 on K
    and V (about 11 PyTorch launches each) and the codes-in kernel
    (slot_kv_update / paged_kv_update). Bound: the token read once, the
    codes (or values), scales and the row map's int32s written or read
    once. No single PyTorch call does the write: no library time."""
    from dsocr_tpu_torch.ops.attention import quantize_kv_int8

    dev = "cuda"
    B, NKV = lengths.shape[0], lead[2]
    write = getattr(K, f"{layout}_kv_write")
    twin = getattr(K, f"{layout}_kv_write_plain")
    update = getattr(K, f"{layout}_kv_update")
    where = (layer, lengths) if tables is None else (tables, lengths, layer)
    for kind, token in (("int8", torch.bfloat16), ("bf16", torch.bfloat16), ("int8", torch.float32)):
        if kind == "int8":
            caches = [torch.randint(-127, 128, (*lead, D), device=dev, dtype=torch.int8) for _ in range(2)]
            caches += [randn(*lead).abs() * 0.02 for _ in range(2)]
        else:
            caches = [randn(*lead, D, dtype=torch.bfloat16) for _ in range(2)] + [None, None]
        twins = [None if c is None else c.clone() for c in caches]
        k, v = kv_tokens(torch, randn(B, 1, 3 * NKV * D, dtype=token), NKV, D)
        write(*caches, k, v, *where)
        twin(*twins, k, v, *where)
        same = all(a is None or torch.equal(a, b) for a, b in zip(caches, twins))
        del twins

        def route():
            if kind == "int8":
                (kq, ks), (vq, vs) = quantize_kv_int8(k[:, :, 0]), quantize_kv_int8(v[:, :, 0])
                new = (kq, vq, ks, vs)
            else:
                new = (k[:, :, 0].to(caches[0].dtype).contiguous(), v[:, :, 0].to(caches[0].dtype).contiguous(),
                       None, None)
            update(*caches, *new, *where)

        written = 2 * B * NKV * (D * caches[0].element_size() + (4 if kind == "int8" else 0))
        map_bytes = nbytes(lengths) + (nbytes(tables) if tables is not None else 0)
        record(f"{layout}_kv_write", f"{kind} cache, {str(token)[6:]} token B={B} {layout} {list(lead)}",
               0.0 if same else float("inf"), 0.0,
               time_ms(lambda: write(*caches, k, v, *where)), time_ms(lambda: twin(*caches, k, v, *where)),
               None, bound(2 * B * NKV * D * k.element_size() + written + map_bytes, 0, "bf16"),
               route_ms=time_ms(route), bit_exact=same)
        del caches


def check_slot_attend(torch, K, record, randn, *, q, caches, layer, lengths, case):
    """slot_decode_attention on one layer of `caches` against its twin
    (tolerance bf16_tol), two launches bit-equal; library time SDPA over
    the whole bf16 row under the length mask (none for int8: SDPA takes no
    int8 cache); bound: the K/V rows [0, lengths[b]] (and their int8
    scales) read once."""
    import torch.nn.functional as F

    k_all, v_all, ks_all, vs_all = caches
    B, NH, _, D = q.shape
    NKV, S = k_all.shape[2], k_all.shape[3]
    scale = D ** -0.5
    out = K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)
    require(torch.equal(out, K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)),
            f"slot_decode_attention {case}: two launches on the same inputs differ")
    ref = K.slot_decode_attention_plain(q, *caches, layer, lengths, scale=scale)
    err = float((out.float() - ref.float()).abs().max())
    used = int((lengths.long() + 1).sum())  # positions the attend reads: [0, lengths[b]]
    quant = ks_all is not None
    kv_bytes = used * NKV * D * k_all.element_size() * 2 + (used * NKV * 4 * 2 if quant else 0)
    library = None
    if not quant:
        live = (torch.arange(S, device=q.device)[None, :] <= lengths.long()[:, None])[:, None, None, :]
        kl, vl = k_all[layer], v_all[layer]
        library = time_ms(lambda: F.scaled_dot_product_attention(q, kl, vl, attn_mask=live, scale=scale))
    record("slot_decode_attention", case, err, bf16_tol(ref),
           time_ms(lambda: K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)),
           time_ms(lambda: K.slot_decode_attention_plain(q, *caches, layer, lengths, scale=scale)),
           library, bound(nbytes(q, lengths, out) + kv_bytes, 4 * NH * D * used, "bf16"),
           deterministic=True)


def check_gather_matmul(torch, K, record, randn, gen):
    """Phase 3, gather_matmul: the split layout's expert gather at full
    width, gate/up [N·6, 1280] × [64, 1280, 896] and down [N·6, 896] ×
    [64, 896, 1280], for 16 and 2 tokens at top-6 (96 and 12 rows, experts
    repeated across tokens), bf16 and f32 stacks. Tolerance 1e-5 ·
    max(|x| @ |W|) (f32 sums in another order); two launches bit-equal.
    Bound: the distinct selected experts' slabs, each read once, over
    3.35 TB/s (the line gives the per-row bytes too); library: index_select
    of the selected slabs and one bmm, which the port never calls."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        stacks = {"gateup": randn(64, 1280, 896, dtype=dtype, std=1280 ** -0.5),
                  "down": randn(64, 896, 1280, dtype=dtype, std=896 ** -0.5)}
        for rows in (96, 12):
            logits = randn(rows // 6, 64)
            idx = torch.topk(logits, 6, dim=-1).indices.reshape(-1).to(torch.int32)
            for case, w in stacks.items():
                cases.append((dtype, rows, case, w, idx))
    for dtype, rows, case, w, idx in cases:
        E, H, I = w.shape
        x = randn(rows, H, dtype=dtype)
        out = K.gather_matmul(x, w, idx)
        require(torch.equal(out, K.gather_matmul(x, w, idx)),
                "gather_matmul: two launches on the same inputs differ")
        ref = K.gather_matmul_plain(x, w, idx)
        tol = q8_tol(torch.bmm(x.float().abs()[:, None], w[idx.long()].float().abs()))
        distinct = torch.unique(idx).numel()
        slab = H * I * w.element_size()
        record("gather_matmul", f"{case} {rows} rows E={E} H={H} I={I} {str(dtype)[6:]}",
               float((out - ref).abs().max()), tol,
               time_ms(lambda: K.gather_matmul(x, w, idx)),
               time_ms(lambda: K.gather_matmul_plain(x, w, idx)),
               time_ms(lambda: torch.bmm(x[:, None], w.index_select(0, idx))),
               bound(nbytes(x, idx, out) + distinct * slab, 2 * rows * H * I,
                     "bf16" if dtype == torch.bfloat16 else "f32"),
               distinct_experts=distinct, bytes_per_row_slabs=rows * slab,
               bytes_distinct_slabs=distinct * slab, deterministic=True)
        del out, ref
    del cases, stacks
    torch.cuda.empty_cache()


def check_paged_kernels(torch, K, record, randn, gen):
    """Phase 3, paged KV: the write and the attend at the main path's
    shapes, 16 rows of the page's packet (904 prompt tokens, up to 128 new)
    holding 9 pages of 128 each in a pool of 144 (L 12, NKV 10, D 128),
    with int8 and bf16 pools. The library time of the bf16 attend is SDPA
    over each row's pages gathered contiguously outside the timing."""
    import torch.nn.functional as F

    dev = "cuda"
    L, B, NKV, D, page, P_max, per_row = 12, 16, 10, 128, 128, 12, 9
    P = B * per_row
    tables = torch.full((B, P_max), -1, dtype=torch.int32, device=dev)
    tables[:, :per_row] = torch.randperm(P, generator=gen, device=dev).reshape(B, per_row).int()
    lengths = torch.randint(904, 904 + 128, (B,), generator=gen, device=dev, dtype=torch.int32)
    layer = 5
    used = int((lengths.long() + 1).sum())  # positions the attend reads: [0, lengths[b]]
    for quant in (True, False):
        kind = "int8" if quant else "bf16"
        if quant:
            def codes(*shape):
                return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

            pools = [codes(L, P, NKV, page, D), codes(L, P, NKV, page, D),
                     randn(L, P, NKV, page).abs() * 0.02, randn(L, P, NKV, page).abs() * 0.02]
            new = (codes(B, NKV, D), codes(B, NKV, D), randn(B, NKV).abs() * 0.02,
                   randn(B, NKV).abs() * 0.02)
        else:
            pools = [randn(L, P, NKV, page, D, dtype=torch.bfloat16),
                     randn(L, P, NKV, page, D, dtype=torch.bfloat16), None, None]
            new = (randn(B, NKV, D, dtype=torch.bfloat16), randn(B, NKV, D, dtype=torch.bfloat16),
                   None, None)
        twins = [None if t is None else t.clone() for t in pools]
        K.paged_kv_update(*pools, *new, tables, lengths, layer)
        K.paged_kv_update_plain(*twins, *new, tables, lengths, layer)
        same = all(a is None or torch.equal(a, b) for a, b in zip(pools, twins))
        del twins
        # no single PyTorch call writes the four planes through a table: no library time
        record("paged_kv_update", f"{kind} B={B} P={P} page={page}", 0.0 if same else float("inf"),
               0.0, time_ms(lambda: K.paged_kv_update(*pools, *new, tables, lengths, layer)),
               time_ms(lambda: K.paged_kv_update_plain(*pools, *new, tables, lengths, layer)),
               None, bound(2 * nbytes(*new) + nbytes(tables, lengths), 0, "bf16"))

        q = randn(B, 10, D)
        scale = D ** -0.5
        out = K.paged_decode_attention(q, *pools, tables, lengths, layer, scale=scale)
        require(torch.equal(out, K.paged_decode_attention(q, *pools, tables, lengths, layer, scale=scale)),
                "paged_decode_attention: two launches on the same inputs differ")
        ref = K.paged_decode_attention_plain(q, *pools, tables, lengths, layer, scale=scale)
        kv_bytes = used * NKV * D * pools[0].element_size() * 2 + (used * NKV * 4 * 2 if quant else 0)
        library = None  # SDPA takes no int8 cache
        if not quant:
            ids = tables.long().clamp(min=0)
            rows = [pools[i][layer][ids].transpose(1, 2).reshape(B, NKV, P_max * page, D) for i in (0, 1)]
            live = (torch.arange(P_max * page, device=dev)[None, :] <= lengths.long()[:, None])[:, None, None, :]
            qb = q.to(torch.bfloat16)[:, :, None]
            library = time_ms(lambda: F.scaled_dot_product_attention(qb, *rows, attn_mask=live, scale=scale))
            del rows
        # f32 throughout: reassociation, the online rescaling and expf
        record("paged_decode_attention", f"{kind} B={B} ~{used // B} tokens/row", float((out - ref).abs().max()),
               float(ref.abs().max()) * 1e-4 + 1e-6,
               time_ms(lambda: K.paged_decode_attention(q, *pools, tables, lengths, layer, scale=scale)),
               time_ms(lambda: K.paged_decode_attention_plain(q, *pools, tables, lengths, layer, scale=scale)),
               library, bound(nbytes(q, tables, lengths, out) + kv_bytes, 4 * 10 * D * used, "f32"),
               deterministic=True)
        del pools, new
        torch.cuda.empty_cache()
    # a row without a page writes nothing: the last row's table is emptied
    tables[-1] = -1
    check_kv_writes(torch, K, record, randn, "paged", (L, P, NKV, page), D, lengths, layer, tables=tables)


def seeded_page():
    """The benchmark page: a seeded random page at sample_1.png's size, in
    1024/640 crop mode (904 prompt tokens)."""
    import numpy as np

    from dsocr_tpu_torch.core import VisionSettings

    image = np.random.default_rng(0).integers(0, 256, size=(1756, 2852, 3), dtype=np.uint8)
    return image, VisionSettings(base_size=1024, image_size=640, crop_mode=True)


_PAGE_INPUT = []


def page_input(engine):
    """The seeded page's VisionInput: the host prep (the host_prep phase
    read 0.11 s a page with the native resampler and 3.2 s with its NumPy
    twin on the host of an H100 80GB HBM3 machine) does not depend on the
    engine, so it runs once per script."""
    if not _PAGE_INPUT:
        _PAGE_INPUT.append(engine.prepare_vision_input(*seeded_page()))
    return _PAGE_INPUT[0]


def page_packet(engine):
    """The seeded page through `engine` outside a measured window → (image,
    vision, tokens, image mask, image embedding)."""
    image, vision = seeded_page()
    vin = page_input(engine)
    emb = engine.compute_image_embedding(vin)
    tokens, mask = engine.build_prompt_tokens(BenchTokenizer(), PROMPT, [vin], [emb], vision)
    return image, vision, tokens, mask, emb


HOST_PREP_SIZES = ((37, 53, 128, 96), (1756, 2852, 1, 1), (641, 1283, 639, 311), (900, 700, 1280, 1920))


def host_prep_phase(torch, engine, pages=N_REQUESTS):
    """Host image prep on the card's host. The seeded page through
    engine.prepare_vision_input with the native resampler and with its
    NumPy twin (resize_bicubic_numpy swapped in): the global view and every
    tile bit-equal, and HOST_PREP_SIZES (source H, W → output W, H) of
    seeded images resized both ways bit-equal; the seconds a page of each
    (median of 3); then a 16-page prep wave through the engine's prefill
    (its thread pool of up to 8; slot.prepare_inputs of a BenchRecorder,
    towers and prefill after it not counted), and os.cpu_count()."""
    import numpy as np

    from dsocr_tpu_torch.core.benchmark import BenchRecorder, set_recorder
    from dsocr_tpu_torch.image import resample

    image, vision = seeded_page()

    def prep_seconds():
        times, vin = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            vin = engine.prepare_vision_input(image, vision)
            times.append(time.perf_counter() - t0)
        return statistics.median(times), times, vin

    native_s, native_runs, native_vin = prep_seconds()
    native = resample.resize_bicubic_native
    resample.resize_bicubic_native = resample.resize_bicubic_numpy
    try:
        twin_s, twin_runs, twin_vin = prep_seconds()
    finally:
        resample.resize_bicubic_native = native
    rng = np.random.default_rng(5)
    sizes_equal = []
    for h, w, ow, oh in HOST_PREP_SIZES:
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        sizes_equal.append(bool(np.array_equal(resample.resize_bicubic(img, ow, oh),
                                               resample.resize_bicubic_numpy(img, ow, oh))))
    rec = BenchRecorder()
    set_recorder(rec)
    try:
        engine.prefill_for_slots(BenchTokenizer(), [(PROMPT, [image], vision)] * pages)
    finally:
        set_recorder(None)
    wave_s = rec.stage_totals()["slot.prepare_inputs"] / 1e3
    line = {"phase": "host_prep", "cpu_count": os.cpu_count(),
            "tiles": len(native_vin.patches), "crop_shape": list(native_vin.crop_shape),
            "global_view_equal": bool(np.array_equal(native_vin.global_pixels, twin_vin.global_pixels)),
            "tiles_equal": bool(np.array_equal(native_vin.patches, twin_vin.patches)),
            "sizes_equal": sizes_equal,
            "prepare_s_per_page_native": native_s, "prepare_s_per_page_twin": twin_s,
            "prepare_s_runs_native": native_runs, "prepare_s_runs_twin": twin_runs,
            "wave_pages": pages, "wave_prep_s": wave_s, "wave_prep_s_per_page": wave_s / pages}
    emit(line)
    require(line["global_view_equal"] and line["tiles_equal"] and all(sizes_equal),
            "the native resize differs from its NumPy twin")


class InjectedFault(RuntimeError):
    """The sched phase's injected chunk fault: the one exception it expects."""


def sched_phase(torch, K, engine, n_requests=4, max_new=32, chunk=8):
    """The scheduler's serving features at full width on the bf16 engine:
    n_requests requests of the seeded page, max_new greedy tokens, over
    n_requests slots, chunks of `chunk` steps, prefill waves of one request.
    Checks, each against the plain burst's tokens: every request streamed
    (each callback's list extends the one before, and the last is the
    tokens); the page twice, one after the other, with DSOCR_PREFIX_CACHE=4
    (one hit; the hit's TTFT beside the miss's); max_inflight=2 with
    n_requests submitted at once (two shed with QueueDepthExceeded, two
    complete); one injected chunk fault (recoveries 1, every request
    completes with the plain burst's tokens); and the plain and faulted
    bursts again with DSOCR_PAGED_KV=1 (the faulted tokens equal the
    paged plain burst's, and every page back in the pool after each).

    The fault is injected on the first chunk, which raises before it runs:
    the row rejoins through the same one-row prefill and join as the
    plain burst, so its tokens are equal by construction. A later fault
    rejoins through a continuation prefill, which computes the generated
    tokens' K/V in the prefill's bf16 sums rather than the decode step's,
    so greedy tokens of random weights could part there; the CPU tests
    (tests/test_torch_scheduler.py) hold continuations at f32. Waves of one
    request: the recovery re-prefills one row, and cuBLAS may sum a wave of
    several rows in another order."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler, QueueDepthExceeded

    image, vision, tokens, _, _ = page_packet(engine)
    params = DecodeParameters(max_new_tokens=max_new)
    tok = BenchTokenizer()
    s_pad = -(-len(tokens) // 128) * 128
    max_len = -(-(s_pad + max_new) // 512) * 512

    def scheduler(**kw):
        return ContinuousScheduler(engine, tok, n_slots=n_requests, max_len=max_len, chunk_steps=chunk,
                                   prefill_batch=1, **kw)

    def burst(sched, n=n_requests, stream=None, exceptions=False):
        async def run():
            return await asyncio.gather(*(
                sched.submit(PROMPT, [image], vision, params,
                             stream_cb=None if stream is None else stream(i)) for i in range(n)),
                return_exceptions=exceptions)

        return asyncio.run(run())

    def inject(sched):
        sched._ensure_state()
        run = sched._runner.run_chunk_snap
        calls = []

        def chunk_call(*args):
            calls.append(1)
            if len(calls) == 1:
                raise InjectedFault("injected chunk fault")
            return run(*args)

        sched._runner.run_chunk_snap = chunk_call

    K.reset_launches()
    t0 = time.perf_counter()
    plain = scheduler()
    want = [o.generated_tokens for o in burst(plain)]
    line = {"phase": "sched", "requests": n_requests, "max_new": max_new, "chunk": chunk,
            "tokens_per_request": [len(t) for t in want], "plain_speculated_chunks": plain.speculated_chunks}

    seen = {i: [] for i in range(n_requests)}
    streamed_sched = scheduler()
    streamed = [o.generated_tokens for o in burst(
        streamed_sched, stream=lambda i: (lambda n, toks: seen[i].append(list(toks))))]
    extends = all(b[: len(a)] == a and len(b) > len(a) for calls in seen.values()
                  for a, b in zip(calls, calls[1:]))
    line.update(stream_equal=streamed == want, stream_callbacks=[len(c) for c in seen.values()],
                stream_extends=extends, stream_last_equal=[c[-1] if c else None for c in seen.values()] == want,
                stream_speculated_chunks=streamed_sched.speculated_chunks)

    with environ(DSOCR_PREFIX_CACHE="4"):
        cached = scheduler()
    miss = burst(cached, n=1)[0].generated_tokens
    hit = burst(cached, n=1)[0].generated_tokens
    line.update(prefix_hits=cached.prefix_cache.hits, prefix_misses=cached.prefix_cache.misses,
                prefix_equal=miss == hit == want[0], ttft_miss_s=cached.ttft_samples[0],
                ttft_hit_s=cached.ttft_samples[1])

    capped = scheduler(max_inflight=2)
    outs = burst(capped, exceptions=True)
    shed = [o for o in outs if isinstance(o, QueueDepthExceeded)]
    done = [o for o in outs if not isinstance(o, BaseException)]
    line.update(shed=len(shed), shed_requests=capped.shed_requests, shed_completed=len(done),
                retry_after_s=[e.retry_after_s for e in shed])
    require(len(shed) + len(done) == len(outs), f"an unexpected failure under max_inflight: {outs}")

    faulted = scheduler()
    inject(faulted)
    got = [o.generated_tokens for o in burst(faulted)]
    line.update(recoveries=faulted.recoveries, recovered_equal=got == want)

    with environ(DSOCR_PAGED_KV="1"):
        paged_plain = scheduler()
        paged_want = [o.generated_tokens for o in burst(paged_plain)]
        paged_faulted = scheduler()
        inject(paged_faulted)
        paged_got = [o.generated_tokens for o in burst(paged_faulted)]
    pools = [(s._runner.allocator.free_count, s._cache.n_pages) for s in (paged_plain, paged_faulted)]
    line.update(paged_recoveries=paged_faulted.recoveries, paged_recovered_equal=paged_got == paged_want,
                paged_equal_to_contiguous=paged_want == want, paged_pages_free_after=pools,
                launches={k: v for k, v in K.launch_counts().items() if v},
                seconds=time.perf_counter() - t0)
    launches = K.launch_counts()
    emit(line)
    require(line["stream_equal"] and line["stream_extends"] and line["stream_last_equal"],
            "streamed tokens differ from the plain burst's or do not extend")
    require(all(n >= 2 for n in line["stream_callbacks"]), "a streamed request got fewer than 2 callbacks")
    require(line["stream_speculated_chunks"] == 0, "a chunk was speculated while rows streamed")
    require(line["prefix_hits"] == 1 and line["prefix_misses"] == 1 and line["prefix_equal"],
            "the prefix cache did not serve the second page from one hit with equal tokens")
    require(line["shed"] == 2 and line["shed_requests"] == 2 and line["shed_completed"] == 2,
            "max_inflight=2 did not shed two of four requests")
    require(line["recoveries"] == 1 and line["recovered_equal"], "the recovered burst differs")
    require(line["paged_recoveries"] == 1 and line["paged_recovered_equal"],
            "the recovered paged burst differs")
    require(all(free == total for free, total in pools), f"pages were not returned: {pools}")
    return launches


def split_state(torch, state, lang):
    """The fused decoder state_dict split into the reference's split layout
    (q/k/v, gate/up, shared gate/up, expert gate/up): fusing it gives
    `state` back."""
    NH, NKV, D, DV = lang.num_attention_heads, lang.resolved_kv_heads, lang.head_dim, lang.resolved_v_head_dim
    parts = {"qkv_proj": (("q_proj", "k_proj", "v_proj"), (NH * D, NKV * D, NKV * DV)),
             "gateup_proj": (("gate_proj", "up_proj"), None),
             "shared_gateup": (("shared_gate", "shared_up"), None),
             "experts_gateup": (("experts_gate", "experts_up"), None)}
    out = {}
    for key, value in state.items():
        head, _, name = key.rpartition(".")
        if name not in parts:
            out[key] = value
            continue
        names, sizes = parts[name]
        pieces = torch.split(value, sizes or value.shape[-1] // 2, dim=-1)
        out.update({f"{head}.{n}": p.contiguous() for n, p in zip(names, pieces)})
    return out


def split_phase(torch, K, engine, steps=32):
    """The decoder's split layout at full width on the card: the bf16 split
    tree of phase 4's engine (fusing it gives the engine's weights) over a
    contiguous KVCache, prefill of the page's packet (the grouped MoE tier)
    and `steps` greedy steps (the single tier), fed the fused engine's
    tokens so that each step's logits compare; then moe_apply with
    gather_threshold=N for N in (2, 4, 16) at layer 1's experts through
    gather_matmul, held to the same call on the CPU. Tolerances: logits
    bit-equal and tokens equal (both layouts run the same column products
    through the same kernels; every run on the H100 read 0.0); moe_apply
    2^-6 of its largest output (f32 sums in another order can move an inter
    element's bf16 rounding, then the output's, by one ulp)."""
    from dsocr_tpu_torch.models.deepseek.decoder import DeepseekDecoder
    from dsocr_tpu_torch.ops import moe
    from dsocr_tpu_torch.runtime.kv_cache import bump_length

    lang = engine.cfg.language
    fused = engine.model.decoder
    t0 = time.perf_counter()
    split = DeepseekDecoder.from_state(lang, split_state(torch, fused.state_dict(), lang),
                                       engine.dtype, engine.device)
    require(split.moe_layers[0].split, "the split state built a fused decoder")
    build_s = time.perf_counter() - t0
    _, _, tokens, mask, emb = page_packet(engine)
    s_pad = -(-len(tokens) // 128) * 128
    embeds = engine._row_embeds(tokens, mask, [emb], s_pad)[None]
    lens = torch.tensor([len(tokens)], device="cuda")

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = {}
    for name, dec in (("fused", fused), ("split", split)):
        with torch.no_grad():
            logits, cache = dec(embeds, torch.arange(s_pad, device="cuda")[None],
                                engine.new_kv_cache(1, s_pad + steps + 8), engine._rope,
                                last_index=lens - 1, flash_prefill=True)
        runs[name] = (logits, bump_length(cache, len(tokens)))
    fed, errs, split_tokens, fused_tokens = None, [], [], []
    scale = float(runs["fused"][0].abs().max())
    for step in range(steps + 1):
        (lf, cf), (ls, cs) = runs["fused"], runs["split"]
        errs.append(float((lf - ls).abs().max()))
        scale = max(scale, float(lf.abs().max()))
        fed = lf.argmax(dim=-1)
        fused_tokens.append(int(fed))
        split_tokens.append(int(ls.argmax(dim=-1)))
        if step == steps:
            break
        with torch.no_grad():
            runs = {"fused": engine._step_fn(fused, fed, cf, None)[:2],
                    "split": engine._step_fn(split, fed, cs, None)[:2]}
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = K.launch_counts()
    differ = [[i, a, b] for i, (a, b) in enumerate(zip(fused_tokens, split_tokens)) if a != b]
    line = {"phase": "split", "prompt_tokens": len(tokens), "steps": steps, "build_s": build_s,
            "forward_s": forward_s, "max_abs_logit_err": max(errs), "max_abs_logit": scale,
            "tokens_equal": not differ, "differing_tokens": differ,
            "flash_prefill_launches": launches["flash_prefill_attention"]}
    del runs, embeds

    layer = split.moe_layers[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    cpu_stacks = [w.cpu() for w in (layer.experts_gate, layer.experts_up, layer.experts_down)]
    checks = []
    K.reset_launches()
    for n in (2, 4, 16):
        x = (torch.randn((n, lang.hidden_size), generator=gen, device="cuda")).to(engine.dtype)
        weights, idx = moe.moe_router(x, layer.gate_weight, split.moe_cfg)
        out = moe.moe_apply(x, weights, idx, layer.experts_gate, layer.experts_up, layer.experts_down,
                            gather_threshold=n)
        ref = moe.moe_apply(x.cpu(), weights.cpu(), idx.cpu(), *cpu_stacks, gather_threshold=n)
        err = float((out.float().cpu() - ref.float()).abs().max())
        tol = float(ref.float().abs().max()) * 2.0 ** -6
        checks.append({"n": n, "max_abs_err": err, "tol": tol})
        require(err <= tol, f"moe_apply(gather_threshold={n}): max abs err {err} > tol {tol}")
    gather_launches = K.launch_counts()
    line.update(moe_apply_gather=checks, gather_matmul_launches=gather_launches["gather_matmul"])
    emit(line)
    require(line["max_abs_logit_err"] == 0.0,
            f"split vs fused logits differ by up to {line['max_abs_logit_err']}")
    require(not differ, f"split vs fused greedy tokens differ at [step, fused, split] {differ}")
    require(gather_launches["gather_matmul"] > 0, "moe_apply's gather tier did not launch gather_matmul")
    del split, cpu_stacks
    gc.collect()
    torch.cuda.empty_cache()
    return gather_launches


GATHER_STEPS = 16


def is_gather_kernel(name: str) -> bool:
    """A profiler kernel name of the gather tier: csrc/expert_sweep.cu's
    gather instantiations, whose last template argument is true, or the
    expert_kernel of trees before it (serve_ab.py reads a parent's)."""
    return ("sweep_kernel<" in name and name.split(">")[0].endswith("true")) or "::expert_kernel<" in name


def decode_phase(torch, K, engine, smi, required, max_new=MAX_NEW):
    """Single-request decode at full width: engine.decode on the seeded page,
    max_new greedy tokens (after a warm-up prefill and 4 steps of the same
    path), the launch counters zeroed just before and read just after;
    every kernel in `required` must have launched. With packed weights,
    16 more warm-up steps under torch.profiler give the gather tier's
    device ms a token beside the step's (`gather`)."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.runtime.kv_cache import bump_length

    image, vision, tokens, mask, emb = page_packet(engine)
    s_pad = -(-len(tokens) // 128) * 128
    with torch.no_grad():
        logits, cache = engine._prefill(engine._row_embeds(tokens, mask, [emb], s_pad)[None],
                                        engine.new_kv_cache(1, s_pad + 8 + GATHER_STEPS),
                                        torch.tensor([len(tokens)], device="cuda"))
        cache = bump_length(cache, len(tokens))
        for _ in range(4):
            logits, cache, _ = engine._step_fn(engine.model.decoder, logits.argmax(dim=-1), cache, None)
        gather = None
        if engine.quantize:  # the gather tier's device ms a token, from 16 traced steps
            state = [logits, cache]

            def steps():
                for _ in range(GATHER_STEPS):
                    state[0], state[1], _ = engine._step_fn(engine.model.decoder, state[0].argmax(dim=-1),
                                                            state[1], None)

            kernels = []
            step_ms, host_ms, _ = traced(torch, steps, GATHER_STEPS, kernels)
            mine = [e for e in kernels if is_gather_kernel(e.key)]
            gather = {"steps": GATHER_STEPS, "device_ms_per_token": sum(map(device_us, mine)) / 1e3 / GATHER_STEPS,
                      "launches_per_token": sum(e.count for e in mine) / GATHER_STEPS,
                      "step_device_ms": step_ms, "step_host_ms_traced": host_ms}
            logits, cache = state
    del logits, cache, emb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = engine.decode(BenchTokenizer(), PROMPT, [image], vision, DecodeParameters(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = engine.decode_stages
    eos = engine.cfg.language.eos_token_id
    line = {"phase": "decode", "quantize": engine.quantize, "nvidia_smi": smi,
            "prompt_tokens": out.prompt_tokens, "response_tokens": out.response_tokens,
            "truncated": out.truncated, "wall_s": wall, "stages_s": st,
            "prefill_s": st["decode.prefill"],
            "decode_ms_per_step": st["decode.generate"] * 1e3 / max(st["decode.steps"], 1),
            "decode_tok_per_s": out.response_tokens / st["decode.generate"],
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: v for k, v in launches.items() if v}}
    if gather is not None:
        line["gather"] = gather
    emit(line)
    require(out.response_tokens == max_new or (eos not in out.generated_tokens and not out.truncated),
            f"decode returned {out.response_tokens} of {max_new} tokens without EOS")
    for name in required:
        require(launches[name] > 0, f"kernel {name} was not launched in the decode phase")
    return launches


def serve(engine, tokenizer, images, vision, params, *, n_slots, max_len, chunk):
    """One request per image, all submitted at once; (outcomes, scheduler)."""
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(engine, tokenizer, n_slots=n_slots, max_len=max_len,
                                chunk_steps=chunk, prefill_batch=n_slots)

    async def run():
        return await asyncio.gather(*(sched.submit(PROMPT, [img], vision, params) for img in images))

    return asyncio.run(run()), sched


@contextlib.contextmanager
def recording():
    """A BenchRecorder installed for the block → the recorder (None from a
    tree without core/benchmark.py, which serve_ab.py may drive)."""
    try:
        from dsocr_tpu_torch.core.benchmark import BenchRecorder, set_recorder
    except ImportError:
        yield None
        return
    rec = BenchRecorder()
    set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(None)


def serving_phase(torch, K, phase, engine, *, n_requests, n_slots, max_new, required,
                  warmup=True, profile=False, towers=False, unused=(), same_as=None, trace_gather=False,
                  chunk=CHUNK, speculate=False):
    """Phases 4-4h: n_requests requests of max_new tokens through
    ContinuousScheduler over n_slots at its defaults (speculative chunk
    dispatch on), chunks of `chunk` steps; the launch counters are zeroed
    just before and read just after, every kernel in `required` must have
    launched and none in `unused`. The line gives the scheduler's
    speculated_chunks and stage_ms, the stage totals of a BenchRecorder
    installed for the burst (while one is installed, the engine waits for
    the towers and the prefill to finish inside their stages); with
    `speculate`, speculated_chunks must be > 0. A paged burst also
    reports its pool and, against `same_as` (another burst's tokens), how
    many requests gave the same tokens. With `profile`, profile_phase
    follows on the page's packet (with `towers`, its tower line too); with
    `trace_gather`, gather_trace on the same burst. → (launch counts,
    tokens per request)."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.runtime.paged import PagedSlotCache

    image, vision, tokens, mask, emb = page_packet(engine)
    params = DecodeParameters(max_new_tokens=max_new)  # greedy, no-repeat-ngram 20
    tok = BenchTokenizer()
    s_pad = -(-len(tokens) // 128) * 128
    max_len = min(engine.max_seq_len, -(-(s_pad + max_new) // 512) * 512)
    if warmup:  # cuBLAS/cuDNN handles, allocator pools; not measured
        serve(engine, tok, [image] * 2, vision, DecodeParameters(max_new_tokens=8),
              n_slots=n_slots, max_len=max_len, chunk=CHUNK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with recording() as rec:
        t0 = time.perf_counter()
        outs, sched = serve(engine, tok, [image] * n_requests, vision, params,
                            n_slots=n_slots, max_len=max_len, chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = K.launch_counts()

    generated = [o.generated_tokens for o in outs]
    n_tokens = sum(len(g) for g in generated)
    eos = engine.cfg.language.eos_token_id
    line = {
        "phase": phase, "quantize": engine.quantize, "requests": len(outs), "slots": n_slots,
        "prompt_tokens": len(tokens), "max_len": max_len,
        "tokens_per_request": [len(g) for g in generated], "wall_s": wall,
        "pages_per_s": len(outs) / wall, "decode_tok_per_s": n_tokens / wall,
        "ttft_p50_s": statistics.median(sched.ttft_samples),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "occupancy_per_chunk": sched.batch_sizes, "chunk": chunk,
        "speculated_chunks": getattr(sched, "speculated_chunks", None),
        "stage_ms": rec.stage_totals() if rec is not None else None, "launches": launches,
    }
    cache = sched._state.cache
    if isinstance(cache, PagedSlotCache):
        lang = engine.cfg.language
        per_token = lang.num_hidden_layers * lang.resolved_kv_heads * (
            (lang.head_dim + lang.resolved_v_head_dim) * cache.k.element_size()
            + (8 if cache.k_scale is not None else 0))
        pages_per_row = -(-max(s_pad, len(tokens) + max_new) // cache.page_size)
        line.update(pool_pages=cache.n_pages, page_size=cache.page_size,
                    pool_bytes=nbytes(cache.k, cache.v, cache.k_scale, cache.v_scale),
                    contiguous_cache_bytes=n_slots * max_len * per_token,
                    rows_the_pool_holds=cache.n_pages // pages_per_row,
                    max_occupancy=max(sched.batch_sizes),
                    pages_free_after=sched._runner.allocator.free_count)
        require(line["max_occupancy"] <= line["rows_the_pool_holds"], "more rows than the pool holds")
        require(line["pages_free_after"] == cache.n_pages, "pages were not returned")
    if same_as is not None:
        line["requests_equal_to_contiguous_burst"] = sum(a == b for a, b in zip(generated, same_as))
    # one more prefill of the page's packet (the join packet that
    # prefill_for_slot makes, outside the window) to read the logits of the path
    pre = engine._prefill_rows([(tokens, mask, [emb])])[0]
    del emb
    line["logits_finite"] = bool(torch.isfinite(pre["logits"]).all())
    emit(line)
    require(len(outs) == n_requests, "not every request completed")
    for g, o in zip(generated, outs):
        # a row stops at its budget, or earlier only on EOS (never appended)
        require(len(g) == max_new or (len(g) < max_new and not o.truncated and eos not in g),
                f"a request returned {len(g)} of {max_new} tokens without EOS")
    require(line["logits_finite"], "non-finite logits")
    require(not speculate or line["speculated_chunks"], f"the {phase} burst speculated no chunk")
    for name in required:
        require(launches[name] > 0, f"kernel {name} was not launched in the {phase} burst")
    for name in unused:
        require(launches[name] == 0, f"kernel {name} was launched in the {phase} burst")
    if profile:
        profile_phase(torch, K, engine, pre, paged=isinstance(cache, PagedSlotCache), towers=towers)
    if trace_gather:
        gather_trace(torch, K, phase, engine, lambda: serve(engine, tok, [image] * n_requests, vision, params,
                                                            n_slots=n_slots, max_len=max_len, chunk=CHUNK))
    return launches, generated


def gather_trace(torch, K, phase, engine, burst):
    """The gather tier in a burst: `burst` once more under torch.profiler,
    every gather wrapper's idx kept (a copy on the card). Emits the tier's
    device ms and launches (per decode step: two a MoE layer), and for
    each selection count its launches and their distinct in-range experts
    (min, mean, max) beside the mean of as many uniform draws."""
    E = engine.cfg.language.n_routed_experts
    names = {f"{fmt}_gather_matmul" for fmt in ("q8", "q4k", "q6k")}
    kept = []

    def keep(w):
        def kept_idx(*args, **kwargs):
            kept.append(args[-1].clone())
            return w(*args, **kwargs)

        return kept_idx

    kernels = []
    with wrapped_kernels(K, keep, names):
        traced(torch, burst, 1, kernels)
    mine = [e for e in kernels if is_gather_kernel(e.key)]
    launches = sum(e.count for e in mine)
    device_ms = sum(map(device_us, mine)) / 1e3
    by_count = {}
    for idx in kept:
        by_count.setdefault(idx.numel(), []).append(torch.unique(idx[(idx >= 0) & (idx < E)]).numel())
    per_step = 2 * len(engine.model.decoder.moe_layers)
    emit({"phase": f"{phase}_trace", "gather_launches": launches, "wrapper_calls": len(kept),
          "gather_device_ms": device_ms, "device_ms_per_launch": device_ms / max(launches, 1),
          "device_ms_per_step": device_ms * per_step / max(launches, 1), "launches_per_step": per_step,
          "distinct_experts": {s: {"launches": len(d), "min": min(d), "mean": statistics.fmean(d), "max": max(d),
                                   "uniform_mean": E * (1 - (1 - 1 / E) ** s)}
                               for s, d in sorted(by_count.items())}})
    require(launches > 0 and kept, f"{phase}: the trace saw no gather launch")


@contextlib.contextmanager
def wrapped_kernels(K, wrap, names=None):
    """Within the block, every kernel wrapper (or those named in `names`)
    is wrap(wrapper) where the port calls it. The kernel modules keep their
    own names, through which they count launches."""
    patched = []
    wrappers = {w.__name__: w for w, _, _ in K.KERNELS if names is None or w.__name__ in names}
    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "")
        if not name.startswith("dsocr_tpu_torch.") or name.startswith("dsocr_tpu_torch.ops.kernels."):
            continue
        for attr, w in wrappers.items():
            if getattr(mod, attr, None) is w:
                setattr(mod, attr, wrap(w))
                patched.append((mod, attr, w))
    try:
        yield
    finally:
        for mod, attr, w in patched:
            setattr(mod, attr, w)


def wrapper_host_ms(K, fn) -> float:
    """Run fn with every kernel wrapper timed on the host clock where the
    port calls it; → milliseconds spent inside the wrappers (checks, the
    output's allocation, the ctypes launch)."""
    spent = []

    def timer(w):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = w(*args, **kwargs)
            spent.append(time.perf_counter() - t0)
            return out

        return timed

    with wrapped_kernels(K, timer):
        fn()
    return sum(spent) * 1e3


def traced(torch, fn, n_calls: int, kernels_out=None):
    """fn once under torch.profiler → (device ms per call: the kernel
    events' durations; host ms per call of the traced window, which the
    profiler slows; the 4 largest kernels [name, launches, ms] per call).
    The kernel events are appended to `kernels_out` where it is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if kernels_out is not None:
        kernels_out.extend(kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:4]
    return (sum(map(device_us, kernels)) / 1e3 / n_calls, wall * 1e3 / n_calls,
            [[e.key[:60], e.count / n_calls, device_us(e) / 1e3 / n_calls] for e in top])


# the SAM global-attention kernels' names: its own bodies
# (sam_attention_*_kernel), and before them the flash_tile body it shared
# with the f32 decoder prefill (which the towers never launch), so the
# tower line also reads a parent tree
SAM_KERNEL_NAMES = ("sam_attention_", "flash_tile_kernel")


def tower_profile(torch, K, engine, pages=TOWER_PAGES):
    """The vision towers of a 16-page burst: the seeded page's VisionInput
    (page_input, so no host prep in the window) 16 times through
    engine._compute_image_embeddings_batched, which pools the pages' views
    as the scheduler's prefill does (4 global views and 16 tiles a call).
    Host ms around the synchronized call (median of 3 after a warm-up),
    then one call under torch.profiler: the towers' device ms, the SAM
    global attention's device ms, launches and share of it, the largest
    kernels."""
    vins = [page_input(engine)] * pages

    def towers():
        engine._compute_image_embeddings_batched(vins)

    t0 = time.perf_counter()
    towers()
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        towers()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    K.reset_launches()
    events = []
    device_ms, traced_ms, top = traced(torch, towers, 1, kernels_out=events)
    sam_ms = sum(device_us(e) for e in events if any(n in e.key for n in SAM_KERNEL_NAMES)) / 1e3
    line = {"phase": "profile_towers", "pages": pages, "host_ms": statistics.median(host),
            "host_ms_runs": host, "device_ms": device_ms, "busy_share": device_ms / traced_ms,
            "sam_attention_ms": sam_ms, "sam_attention_share": sam_ms / device_ms,
            "sam_attention_launches": K.launch_counts()["sam_flash_attention"], "top": top,
            "seconds": time.perf_counter() - t0}
    emit(line)
    require(device_ms > 0 and sam_ms > 0, "the profiler saw no tower or SAM attention time")
    return line


def profile_phase(torch, K, engine, pre, paged=False, towers=False):
    """Where the time goes at 16 rows in the engine's weight format:
    a prefill wave (16 rows × 1024 seeded embeddings through the decoder,
    host clock around synchronized work, median of 3 after a warm-up) and
    decode steps (the page's packet joined into 16 slots that never end,
    SlotRunner.run_chunk, or with `paged` a PagedSlotRunner over a pool
    of 16 × 12 pages, greedy with the 20-gram ban: host ms per step,
    median of 4 windows of 16 steps). Then one wave and 4 steps under
    torch.profiler (device ms, busy share, kernel launches a step: the
    kernel events' count, largest kernels), and 16 steps
    with every kernel wrapper timed on the host: the host ms per step
    inside the wrappers against the rest of the step. `seconds` gives the
    wall seconds of each part. With `towers`, tower_profile's line
    follows."""
    from dsocr_tpu_torch.core import DecodeParameters
    from dsocr_tpu_torch.ops.rope import build_rope_tables
    from dsocr_tpu_torch.runtime.slots import SlotRunner

    dec = engine.model.decoder
    lang = engine.cfg.language
    rows, window = PROFILE_ROWS, PROFILE_WINDOW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rope = build_rope_tables(engine.max_seq_len, lang.rope_dim, lang.rope_theta, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds = (torch.randn((rows, PROFILE_WAVE, lang.hidden_size), generator=gen, device="cuda")
              * 0.02).to(engine.dtype)
    positions = torch.arange(PROFILE_WAVE, device="cuda")[None].expand(rows, PROFILE_WAVE)
    last = torch.full((rows,), PROFILE_WAVE - 1, device="cuda")

    def wave():
        with torch.no_grad():
            dec.prefill(embeds, positions, rope, last_index=last)

    def host_ms(fn, n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_calls

    t0 = time.perf_counter()
    wave()
    line = {"phase": "profile", "quantize": engine.quantize, "paged": paged,
            "prefill_wave_ms": statistics.median(host_ms(wave, 1) for _ in range(3))}
    t1 = time.perf_counter()
    line["prefill_device_ms"], _, line["prefill_top"] = traced(torch, wave, 1)
    seconds = {"waves": t1 - t0, "traced_wave": time.perf_counter() - t1}
    del embeds

    context = 1536  # the 904-token prompt and every step below
    if paged:
        runner, cache = engine.make_paged_slot_runner(rows, context, n_pages=rows * context // 128)
        runner.eos_ids = ()
    else:
        runner, cache = SlotRunner(engine.slot_step_fn, eos_ids=()), engine.new_slot_cache(rows, context)
    t0 = time.perf_counter()
    state = runner.init_state(cache, context)
    budget = context - len(pre["prompt_ids"])  # more than the steps below take
    runner.join_many(state, list(range(rows)), [pre] * rows, [DecodeParameters()] * rows,
                     [budget] * rows, [None] * rows)
    chunk = lambda n: runner.run_chunk(dec, state, n)  # noqa: E731
    chunk(8)
    windows = [host_ms(lambda: chunk(window), window) for _ in range(4)]
    line["decode_step_ms"], line["decode_step_ms_windows"] = statistics.median(windows), windows
    t1 = time.perf_counter()
    step_events = []
    line["step_device_ms"], traced_ms, line["step_top"] = traced(torch, lambda: chunk(4), 4, step_events)
    line["step_busy_share"] = line["step_device_ms"] / traced_ms
    line["step_launches"] = sum(e.count for e in step_events) / 4  # kernel events a step
    seconds.update(join_and_steps=t1 - t0, traced_steps=time.perf_counter() - t1)
    t1 = time.perf_counter()
    K.reset_launches()
    spent = []
    step_ms = host_ms(lambda: spent.append(wrapper_host_ms(K, lambda: chunk(window))), window)
    line["wrapper_calls_per_step"] = sum(K.launch_counts().values()) / window
    line["wrapper_host_ms_per_step"] = spent[0] / window
    line["rest_host_ms_per_step"] = step_ms - spent[0] / window
    line["seconds"] = {**seconds, "wrapper_steps": time.perf_counter() - t1}
    line["expert_bytes_per_dense_step"] = sum(
        sum(t.numel() * t.element_size() for t in (w.buffers() if isinstance(w, torch.nn.Module) else [w]))
        for layer in dec.moe_layers for w in (layer.experts_gateup, layer.experts_down))
    line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(line)
    require(all(t > 0 for t in (line["prefill_device_ms"], line["step_device_ms"])),
            "the profiler saw no device time")
    if towers:
        tower_profile(torch, K, engine)


def profile_packet(torch, K, engine, paged=False):
    """profile_phase on the seeded page's packet, without a burst before it
    (serve_ab.py --profiles)."""
    _, _, tokens, mask, emb = page_packet(engine)
    pre = engine._prefill_rows([(tokens, mask, [emb])])[0]
    del emb
    profile_phase(torch, K, engine, pre, paged=paged)


def full_width_engine(torch, quantize=None):
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig, DeepseekOcrEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = DeepseekOcrEngine(DeepseekOcrConfig(), dtype=torch.bfloat16, device="cuda",
                               max_seq_len=4096, seed=0, kv_quant="int8", quantize=quantize)
    torch.cuda.synchronize()
    emit({"phase": "init", "quantize": quantize, "init_s": time.perf_counter() - t0,
          "quantize_s": engine.model.decoder.quantize_s,
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return engine


def parity_phase(torch):
    """Phase 5: tiny config, same weights, CUDA kernels vs CPU twins."""
    import numpy as np

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config

    cfg = tiny_deepseek_config()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in range(3)]
    params = DecodeParameters(max_new_tokens=16, no_repeat_ngram_size=None)
    vision = VisionSettings(64, 64, False)
    cpu = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=PARITY_SEED)
    state = cpu.model.state_dict()
    result = {"phase": "parity"}
    for kv_quant in (None, "int8"):
        tokens, speculated = {}, {}
        for device in ("cpu", "cuda"):
            eng = DeepseekOcrEngine(cfg, dtype=torch.float32, device=device, max_seq_len=512,
                                    kv_quant=kv_quant, state=state)
            outs, sched = serve(eng, TinyTokenizer(), images, vision, params,
                                n_slots=2, max_len=256, chunk=8)
            tokens[device] = [o.generated_tokens for o in outs]
            speculated[device] = sched.speculated_chunks
        key = kv_quant or "f32"
        result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
        result[f"{key}_tokens_cuda"] = tokens["cuda"]
        result[f"{key}_speculated_chunks"] = speculated  # the scheduler's default is on, both sides
    # Q8_0: every contraction dim % 32, so the routed experts pack too.
    # K-quants: hidden 256 puts the projections' in dims on the 256-value
    # super-block; the down projections (in dim 32) pack as Q8_0, a mixed
    # expert group as at full width.
    from dsocr_tpu_torch.ops import kernels as K

    lang32 = dataclasses.replace(cfg.language, moe_intermediate_size=32)
    # moe_intermediate_size 256 packs the down projections as the K-quant
    # too: the one served path that reaches q4k_/q6k_dense_experts_perx.
    def kq(inter):
        lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=inter)
        return dataclasses.replace(cfg, projector_n_embed=256, language=lang)

    formats = (
        ("q8_0", "q8", dataclasses.replace(cfg, language=lang32), PARITY_SEED,
         ((2, "q8_gather_matmul"), (4, "q8_dense_experts"))),
        ("q4_k", "q4k", kq(32), PARITY_SEED, ((2, "q4k_gather_matmul"), (4, "q4k_dense_experts"))),
        ("q4_k", "q4k_all", kq(256), PARITY_SEED, ((4, "q4k_dense_experts_perx"),)),
        ("q6_k", "q6k", kq(32), Q6K_PARITY_SEED, ((2, "q6k_gather_matmul"), (4, "q6k_dense_experts"))),
        ("q6_k", "q6k_all", kq(256), Q6K_PARITY_SEED, ((4, "q6k_dense_experts_perx"),)),
    )
    for method, tag, qcfg, seed, tiers in formats:
        cpu = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=seed,
                                quantize=method)
        state = cpu.model.state_dict()
        for n_slots, tier in tiers:
            for kv_quant in (None, "int8"):
                tokens = {}
                for device in ("cpu", "cuda"):
                    eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                            kv_quant=kv_quant, state=state, quantize=method)
                    K.reset_launches()
                    outs, _ = serve(eng, TinyTokenizer(), images, vision, params,
                                    n_slots=n_slots, max_len=256, chunk=8)
                    tokens[device] = [o.generated_tokens for o in outs]
                key = f"{tag}_{n_slots}slots_{kv_quant or 'f32'}"
                result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
                result[f"{key}_{tier}_launches"] = K.launch_counts()[tier]
                result[f"{key}_tokens_per_request"] = [len(t) for t in tokens["cuda"]]
                require(K.launch_counts()[tier] > 0, f"{key}: the {tier} tier did not run on the card")
    # paged KV + the megafused chain on the Q8_0 config at 4 slots (the
    # dense tier); a pool of 2 pages holds 2 of the 4 rows, so the third
    # request waits for pages on the card as on the CPU
    qcfg = dataclasses.replace(cfg, language=lang32)
    state = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512,
                              seed=PARITY_SEED, quantize="q8_0").model.state_dict()
    for kv_quant, pool in ((None, None), ("int8", None), (None, "2")):
        pool_env = {"DSOCR_POOL_PAGES": pool} if pool else {}
        with environ(DSOCR_PAGED_KV="1", DSOCR_Q8_MEGAFUSED="1", **pool_env):
            tokens = {}
            for device in ("cpu", "cuda"):
                eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                        kv_quant=kv_quant, state=state, quantize="q8_0")
                K.reset_launches()
                outs, sched = serve(eng, TinyTokenizer(), images, vision, params,
                                    n_slots=4, max_len=256, chunk=8)
                tokens[device] = [o.generated_tokens for o in outs]
        key = f"q8_paged_4slots_{kv_quant or 'f32'}" + (f"_pool{pool}" if pool else "")
        counts = K.launch_counts()
        result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
        result[f"{key}_launches"] = {name: counts[name] for name in
                                     ("q8_moe_megafused", "paged_kv_write", "paged_decode_attention")}
        result[f"{key}_max_occupancy"] = max(sched.batch_sizes)
        require(all(result[f"{key}_launches"].values()), f"{key}: a paged or megafused kernel did not run")
        require(not pool or max(sched.batch_sizes) <= int(pool), f"{key}: more rows than the pool holds")
    # single-request decode (engine.decode over a contiguous KV cache), with
    # and without the cache, f32 and Q8_0 weights (the gather tier at N = 1)
    for tag, qcfg, method in (("f32", cfg, None), ("q8", dataclasses.replace(cfg, language=lang32), "q8_0")):
        state = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512,
                                  seed=PARITY_SEED, quantize=method).model.state_dict()
        for use_cache in (True, False):
            tokens = {}
            for device in ("cpu", "cuda"):
                eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                        state=state, quantize=method)
                out = eng.decode(TinyTokenizer(), PROMPT, images[:1], vision,
                                 DecodeParameters(max_new_tokens=16 if use_cache else 6,
                                                  use_cache=use_cache))
                tokens[device] = out.generated_tokens
            key = f"decode_{tag}_{'cache' if use_cache else 'nocache'}"
            result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
            result[f"{key}_tokens_cuda"] = tokens["cuda"]
    emit(result)
    require(all(v for k, v in result.items() if k.endswith("_equal")), "CUDA and CPU greedy tokens differ")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dsocr_tpu_torch")):
        print("chip_smoke: the dsocr_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from dsocr_tpu_torch.core.device import set_f32_precision
    from dsocr_tpu_torch.ops import kernels as K
    from dsocr_tpu_torch.ops.kernels import _lib

    set_f32_precision()
    smi = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    t0 = time.perf_counter()
    _lib.lib()
    emit({"phase": "build", "nvcc_s": _lib.build_info.get("nvcc_s"),
          "load_s": time.perf_counter() - t0, "library": os.path.relpath(_lib.build_info["path"], HERE)})

    cases = check_kernels(torch, K)
    slot = ["slot_kv_write", "slot_decode_attention"]
    # the codes-in writes of the reference's contract: phase 3 only, since
    # the decode step's writes quantize the token themselves
    codes_in = ["slot_kv_update", "paged_kv_update"]
    attention = ["sam_flash_attention", "flash_prefill_attention"] + slot
    engine = full_width_engine(torch)
    host_prep_phase(torch, engine)
    bursts = [serving_phase(torch, K, "serve", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
                            max_new=MAX_NEW, required=attention, unused=codes_in, profile=True,
                            towers=True)[0]]
    # Phase 4's gate cannot open: a chunk of 128 steps and 128 new tokens
    # never leave two chunks of budget (emitted + 2 · 128 <= 128). The same
    # burst in chunks of 32 (the scheduler's default chunk_steps) must
    # speculate: rows join at chunk boundaries, so the first wave's 4 rows
    # have emitted 0, 32, 64 or 96 tokens when the other 12 join. Up to 64
    # opens the gate at once (64 + 2 · 32 <= 128, no free slot); 96 opens
    # it a chunk later, when those rows have left, no prefill is left and
    # the other rows have emitted 32.
    bursts.append(serving_phase(torch, K, "serve_spec", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
                                max_new=MAX_NEW, required=attention, unused=codes_in, warmup=False,
                                chunk=32, speculate=True)[0])
    bursts.append(sched_phase(torch, K, engine))
    bursts.append(split_phase(torch, K, engine))
    prefill = ["sam_flash_attention", "flash_prefill_attention"]
    bursts.append(decode_phase(torch, K, engine, smi, required=prefill))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_width_engine(torch, quantize="q8_0")
    sweep = ["q8_dense_experts", "q8_dense_experts_perx"]
    launches, q8_tokens = serving_phase(
        torch, K, "serve_q8", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q8_matmul"] + sweep, unused=codes_in, warmup=False, profile=True)
    bursts.append(launches)
    bursts.append(serving_phase(
        torch, K, "serve_q8_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q8_gather_matmul"], warmup=False, trace_gather=True)[0])
    bursts.append(decode_phase(torch, K, engine, smi,
                               required=prefill + ["q8_matmul", "q8_gather_matmul"]))
    # the same engine with a shared page pool that holds 12 of the 16 rows
    # (9 pages each of 108) and the megafused expert chain
    with environ(DSOCR_PAGED_KV="1", DSOCR_Q8_MEGAFUSED="1", DSOCR_POOL_PAGES="108"):
        bursts.append(serving_phase(
            torch, K, "serve_q8_paged", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
            max_new=MAX_NEW, required=["paged_kv_write", "paged_decode_attention",
                                       "q8_moe_megafused", "q8_matmul"],
            unused=slot + sweep + codes_in, warmup=False, profile=True, same_as=q8_tokens)[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_width_engine(torch, quantize="q4_k")
    bursts.append(serving_phase(
        torch, K, "serve_q4k", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q4k_matmul", "q4k_dense_experts", "q8_dense_experts_perx"],
        unused=codes_in, warmup=False, profile=True)[0])
    bursts.append(serving_phase(
        torch, K, "serve_q4k_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q4k_gather_matmul", "q8_gather_matmul"], warmup=False, trace_gather=True)[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_width_engine(torch, quantize="q6_k")
    bursts.append(serving_phase(
        torch, K, "serve_q6k", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q6k_matmul", "q6k_dense_experts", "q8_dense_experts_perx"],
        unused=codes_in, warmup=False, profile=True)[0])
    bursts.append(serving_phase(
        torch, K, "serve_q6k_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q6k_gather_matmul", "q8_gather_matmul"], warmup=False, trace_gather=True)[0])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: sum(b[name] for b in bursts) for name in bursts[0]}
    parity_phase(torch)

    # per kernel: the worst error over its cases; the times and bound of its first case
    summary = []
    for fn, source, replaces in K.KERNELS:
        mine = [c for c in cases if c["kernel"] == fn.__name__]
        summary.append({
            "name": fn.__name__, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[fn.__name__],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            **{key: mine[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
