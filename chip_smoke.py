#!/usr/bin/env python3
"""Drive the PyTorch port (dsocr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (nothing is caught):

1. env      torch/CUDA versions and the card's name and power limit;
2. build    nvcc of dsocr_tpu_torch/csrc/*.cu into one shared library;
3. kernels  each hand-written kernel against its plain PyTorch twin at
            the main path's shapes: max abs error against the stated
            tolerance, median kernel and plain milliseconds (CUDA events);
            and the Q8_0 quantizer on the card bit for bit against its CPU
            run on a full-width expert stack;
4. serve    DeepSeek-OCR v1 at full width (DeepseekOcrConfig(), bf16
            weights from a seeded torch.Generator, int8 KV): 16 requests
            of 128 new tokens through ContinuousScheduler.submit over 16
            slots, 128-step chunks, on a seeded 1756×2852 page in 1024/640
            crop mode. The launch counters are zeroed just before and read
            just after; every kernel of the bf16 path must have launched;
4b. serve_q8         the same with packed Q8_0 decoder weights (quantized
            on the card from the same seed): 16 requests × 128 tokens over
            16 slots, 16·6 = 96 selections > 64 experts, so decode runs the
            dense all-expert tier: q8_matmul, q8_dense_experts and
            q8_dense_experts_perx must launch, with the attention kernels;
4c. serve_q8_gather  the same Q8_0 engine, 4 requests × 32 tokens over 4
            slots (24 selections ≤ 64): q8_gather_matmul must launch;
5. parity   the tiny config in f32 with one set of weights, served on the
            card (kernels) and on the CPU (twins): greedy tokens must match;
            again with Q8_0 weights (moe_intermediate_size 32) at 2 slots
            (gather tier) and 4 slots (dense tier).

Then a {"kernels": [...]} summary line (launches: the sum over the
three serving bursts), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA card, or without the
dsocr_tpu_torch package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_NEW = 128
N_REQUESTS = 16
N_SLOTS = 16
CHUNK = 128
PROMPT = "<image>\nFree OCR."
IMAGE_TOKEN_ID = 128815  # the DeepSeek tokenizer's <image> id


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


def require(cond, message: str) -> None:
    """A failed check ends the run (raises; never skipped, unlike assert)."""
    if not cond:
        raise RuntimeError(message)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_tol(ref) -> float:
    """One bf16 ulp at the reference's largest magnitude: both sides round
    their f32 result to bf16 once."""
    return float(ref.float().abs().max()) * 2.0 ** -7 + 1e-5


def q8_tol(bound) -> float:
    """f32 reassociation of exact bf16 products: 1e-5 of the largest sum of
    term magnitudes (|bf16 x| @ |W|)."""
    return float(bound.max()) * 1e-5


def check_q8_kernels(torch, K, record, randn):
    """Phase 3, Q8_0: the four dequant-matmul wrappers against their twins
    at the main path's shapes, and the quantizer on the card against its
    CPU run."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack, quantize_plain

    def bf16_abs(x):
        return x.to(torch.bfloat16).float().abs()

    # lm_head 1280 → 129280 at N = 16; qkv 1280 → 3840 at decode and prefill
    for case, n, k, m in (("lm_head", 16, 1280, 129280), ("qkv", 16, 1280, 3840),
                          ("qkv", 16384, 1280, 3840)):
        p = quantize_plain(randn(k, m, dtype=torch.bfloat16, std=k ** -0.5))
        codes, scales = p["codes"], p["scales"]
        x = randn(n, k, dtype=torch.bfloat16)
        out = K.q8_matmul(x, codes, scales)
        ref = K.q8_matmul_plain(x, codes, scales)
        w = codes.float() * scales.repeat_interleave(32, dim=1)
        tol = q8_tol(torch.matmul(bf16_abs(x), w.abs().t()))
        del w
        record("q8_matmul", f"{case} N={n} K={k} M={m}", float((out - ref).abs().max()), tol,
               time_ms(lambda: K.q8_matmul(x, codes, scales)),
               time_ms(lambda: K.q8_matmul_plain(x, codes, scales)))
        del out, ref

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

    gen_idx = torch.Generator(device="cuda").manual_seed(1)
    for case, p, k in (("gateup", gu, 1280), ("down", dn, 896)):
        x = randn(60, k, dtype=torch.bfloat16)
        idx = torch.randint(0, 64, (60,), generator=gen_idx, device="cuda", dtype=torch.int32)
        out = K.q8_gather_matmul(x, p["codes"], p["scales"], idx)
        ref = K.q8_gather_matmul_plain(x, p["codes"], p["scales"], idx)
        bound = torch.bmm(bf16_abs(x)[:, None], deq(p)[idx.long()].abs())
        record("q8_gather_matmul", f"{case} 60 rows", float((out - ref).abs().max()), q8_tol(bound),
               time_ms(lambda: K.q8_gather_matmul(x, p["codes"], p["scales"], idx)),
               time_ms(lambda: K.q8_gather_matmul_plain(x, p["codes"], p["scales"], idx)))
        del out, ref, bound

    x = randn(16, 1280, dtype=torch.bfloat16)
    out = K.q8_dense_experts(x, gu["codes"], gu["scales"])
    ref = K.q8_dense_experts_plain(x, gu["codes"], gu["scales"])
    record("q8_dense_experts", "gateup N=16", float((out - ref).abs().max()),
           q8_tol(torch.matmul(bf16_abs(x)[None], deq(gu).abs())),
           time_ms(lambda: K.q8_dense_experts(x, gu["codes"], gu["scales"])),
           time_ms(lambda: K.q8_dense_experts_plain(x, gu["codes"], gu["scales"])))
    xe = randn(64, 16, 896, dtype=torch.bfloat16)
    out = K.q8_dense_experts_perx(xe, dn["codes"], dn["scales"])
    ref = K.q8_dense_experts_perx_plain(xe, dn["codes"], dn["scales"])
    record("q8_dense_experts_perx", "down N=16", float((out - ref).abs().max()),
           q8_tol(torch.matmul(bf16_abs(xe), deq(dn).abs())),
           time_ms(lambda: K.q8_dense_experts_perx(xe, dn["codes"], dn["scales"])),
           time_ms(lambda: K.q8_dense_experts_perx_plain(xe, dn["codes"], dn["scales"])))


def check_kernels(torch, K):
    """Phase 3: every kernel against its twin at main-path shapes."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    cases = []

    def record(kernel, case, err, tol, ms, plain_ms):
        line = {"phase": "kernels", "kernel": kernel, "case": case, "max_abs_err": err,
                "tol": tol, "ms": ms, "plain_ms": plain_ms}
        emit(line)
        require(err <= tol, f"{kernel} {case}: max abs err {err} > tol {tol}")
        cases.append(line)

    # SAM global attention: 1024 global view (S = 4096, 1 view x 12 heads)
    # and 640 tiles (S = 1600, 6 tiles x 12 heads); q pre-scaled, f32
    for bh, s in ((12, 4096), (72, 1600)):
        w = int(round(s ** 0.5))
        q, k, v = randn(bh, s, 64, std=0.125), randn(bh, s, 64), randn(bh, s, 64)
        bias_h, bias_w = randn(bh, s, w, std=0.3), randn(bh, s, w, std=0.3)
        args = (q, k, v, bias_h, bias_w)
        out = K.sam_flash_attention(*args, width=w)
        ref = K.sam_flash_attention_plain(*args, width=w)
        err = float((out - ref).abs().max())
        record("sam_flash_attention", f"BH={bh} S={s}", err, 1e-4,
               time_ms(lambda: K.sam_flash_attention(*args, width=w)),
               time_ms(lambda: K.sam_flash_attention_plain(*args, width=w)))

    # decoder prefill: 10 heads of 128, S = 1792, bf16, with left padding
    for b, pads in ((1, [0]), (4, [0, 300, 7, 1000])):
        s = 1792
        q, k, v = (randn(b, 10, s, 128, dtype=torch.bfloat16) for _ in range(3))
        pad = torch.tensor(pads, dtype=torch.int32, device=dev)
        scale = 128 ** -0.5
        out = K.flash_prefill_attention(q, k, v, pad, scale=scale)
        ref = K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)
        err = float((out.float() - ref.float()).abs().max())
        record("flash_prefill_attention", f"B={b} S={s} pad_start={pads}", err, bf16_tol(ref),
               time_ms(lambda: K.flash_prefill_attention(q, k, v, pad, scale=scale)),
               time_ms(lambda: K.flash_prefill_attention_plain(q, k, v, pad, scale=scale)))

    # slot caches: L = 12, B = 16, NKV = 10, D = 128, S_max = 2560
    L, B, NKV, S, D = 12, 16, 10, 2560, 128
    lengths = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 0, S - 1
    layer = 5
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
        record("slot_kv_update", f"{kind} B={B} S={S}", 0.0 if same else float("inf"), 0.0,
               time_ms(lambda: K.slot_kv_update(*caches, *new, layer, lengths)),
               time_ms(lambda: K.slot_kv_update_plain(*twins, *new, layer, lengths)))

        q = randn(B, 10, 1, D, dtype=torch.bfloat16)
        scale = D ** -0.5
        out = K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)
        ref = K.slot_decode_attention_plain(q, *caches, layer, lengths, scale=scale)
        err = float((out.float() - ref.float()).abs().max())
        record("slot_decode_attention", f"{kind} B={B} S={S}", err, bf16_tol(ref),
               time_ms(lambda: K.slot_decode_attention(q, *caches, layer, lengths, scale=scale)),
               time_ms(lambda: K.slot_decode_attention_plain(q, *caches, layer, lengths, scale=scale)))
    del k_all, v_all, ks_all, vs_all, caches, twins
    check_q8_kernels(torch, K, record, randn)
    torch.cuda.empty_cache()
    return cases


def serve(engine, tokenizer, images, vision, params, *, n_slots, max_len, chunk):
    """One request per image, all submitted at once; (outcomes, scheduler)."""
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(engine, tokenizer, n_slots=n_slots, max_len=max_len,
                                chunk_steps=chunk, prefill_batch=n_slots)

    async def run():
        return await asyncio.gather(*(sched.submit(PROMPT, [img], vision, params) for img in images))

    return asyncio.run(run()), sched


def serving_phase(torch, K, phase, engine, *, n_requests, n_slots, max_new, required,
                  warmup=True):
    """Phases 4, 4b, 4c: n_requests requests of max_new tokens through
    ContinuousScheduler over n_slots; the launch counters are zeroed just
    before and read just after, and every kernel in `required` must have
    launched."""
    import numpy as np

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings

    # the benchmark page: a seeded random page at sample_1.png's size
    image = np.random.default_rng(0).integers(0, 256, size=(1756, 2852, 3), dtype=np.uint8)
    vision = VisionSettings(base_size=1024, image_size=640, crop_mode=True)
    params = DecodeParameters(max_new_tokens=max_new)  # greedy, no-repeat-ngram 20
    tok = BenchTokenizer()

    vin = engine.prepare_vision_input(image, vision)
    emb = engine.compute_image_embedding(vin)
    tokens, _ = engine.build_prompt_tokens(tok, PROMPT, [vin], [emb], vision)
    s_pad = -(-len(tokens) // 128) * 128
    max_len = min(engine.max_seq_len, -(-(s_pad + max_new) // 512) * 512)
    del emb
    if warmup:  # cuBLAS/cuDNN handles, allocator pools; not measured
        serve(engine, tok, [image] * 2, vision, params, n_slots=n_slots, max_len=max_len, chunk=CHUNK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    outs, sched = serve(engine, tok, [image] * n_requests, vision, params,
                        n_slots=n_slots, max_len=max_len, chunk=CHUNK)
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
        "occupancy_per_chunk": sched.batch_sizes, "launches": launches,
    }
    # one more prefill to read the logits of the path (outside the window)
    pre = engine.prefill_for_slot(tok, PROMPT, [image], vision)
    line["logits_finite"] = bool(torch.isfinite(pre["logits"]).all())
    emit(line)
    require(len(outs) == n_requests, "not every request completed")
    for g, o in zip(generated, outs):
        # a row stops at its budget, or earlier only on EOS (never appended)
        require(len(g) == max_new or (len(g) < max_new and not o.truncated and eos not in g),
                f"a request returned {len(g)} of {max_new} tokens without EOS")
    require(line["logits_finite"], "non-finite logits")
    for name in required:
        require(launches[name] > 0, f"kernel {name} was not launched in the {phase} burst")
    return launches


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
    cpu = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=7)
    state = cpu.model.state_dict()
    result = {"phase": "parity"}
    for kv_quant in (None, "int8"):
        tokens = {}
        for device in ("cpu", "cuda"):
            eng = DeepseekOcrEngine(cfg, dtype=torch.float32, device=device, max_seq_len=512,
                                    kv_quant=kv_quant, state=state)
            outs, _ = serve(eng, TinyTokenizer(), images, vision, params,
                            n_slots=2, max_len=256, chunk=8)
            tokens[device] = [o.generated_tokens for o in outs]
        key = kv_quant or "f32"
        result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
        result[f"{key}_tokens_cuda"] = tokens["cuda"]
    # Q8_0: every contraction dim % 32, so the routed experts pack too
    from dsocr_tpu_torch.ops import kernels as K

    qcfg = dataclasses.replace(cfg, language=dataclasses.replace(cfg.language, moe_intermediate_size=32))
    cpu = DeepseekOcrEngine(qcfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=7,
                            quantize="q8_0")
    state = cpu.model.state_dict()
    for n_slots, tier in ((2, "q8_gather_matmul"), (4, "q8_dense_experts")):
        for kv_quant in (None, "int8"):
            tokens = {}
            for device in ("cpu", "cuda"):
                eng = DeepseekOcrEngine(qcfg, dtype=torch.float32, device=device, max_seq_len=512,
                                        kv_quant=kv_quant, state=state, quantize="q8_0")
                K.reset_launches()
                outs, _ = serve(eng, TinyTokenizer(), images, vision, params,
                                n_slots=n_slots, max_len=256, chunk=8)
                tokens[device] = [o.generated_tokens for o in outs]
            key = f"q8_{n_slots}slots_{kv_quant or 'f32'}"
            result[f"{key}_equal"] = tokens["cpu"] == tokens["cuda"]
            result[f"{key}_{tier}_launches"] = K.launch_counts()[tier]
            require(K.launch_counts()[tier] > 0, f"{key}: the {tier} tier did not run on the card")
    emit(result)
    require(all(v for k, v in result.items() if k.endswith("_equal")), "CUDA and CPU greedy tokens differ")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dsocr_tpu_torch")):
        print("chip_smoke: the dsocr_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
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
    attention = ["sam_flash_attention", "flash_prefill_attention", "slot_kv_update",
                 "slot_decode_attention"]
    engine = full_width_engine(torch)
    bursts = [serving_phase(torch, K, "serve", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS,
                            max_new=MAX_NEW, required=attention)]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_width_engine(torch, quantize="q8_0")
    bursts.append(serving_phase(
        torch, K, "serve_q8", engine, n_requests=N_REQUESTS, n_slots=N_SLOTS, max_new=MAX_NEW,
        required=attention + ["q8_matmul", "q8_dense_experts", "q8_dense_experts_perx"]))
    bursts.append(serving_phase(
        torch, K, "serve_q8_gather", engine, n_requests=4, n_slots=4, max_new=32,
        required=["q8_gather_matmul"], warmup=False))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: sum(b[name] for b in bursts) for name in bursts[0]}
    parity_phase(torch)

    # per kernel: the worst error over its cases; the times of its first case
    summary = []
    for fn, source, replaces in K.KERNELS:
        mine = [c for c in cases if c["kernel"] == fn.__name__]
        summary.append({
            "name": fn.__name__, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[fn.__name__],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"],
        })
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
