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
4. serve    DeepSeek-OCR v1 at full width (DeepseekOcrConfig(), bf16
            weights from a seeded torch.Generator, int8 KV): 16 requests
            of 128 new tokens through ContinuousScheduler.submit over 16
            slots, 128-step chunks, on a seeded 1756×2852 page in 1024/640
            crop mode. The launch counters are zeroed just before and read
            just after; every kernel must have launched;
5. parity   the tiny config in f32 with one set of weights, served on the
            card (kernels) and on the CPU (twins): greedy tokens must match.

Then a {"kernels": [...]} summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA card, or without the
dsocr_tpu_torch package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import asyncio
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
    return cases


def serve(engine, tokenizer, images, vision, params, *, n_slots, max_len, chunk):
    """One request per image, all submitted at once; (outcomes, scheduler)."""
    from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(engine, tokenizer, n_slots=n_slots, max_len=max_len,
                                chunk_steps=chunk, prefill_batch=n_slots)

    async def run():
        return await asyncio.gather(*(sched.submit(PROMPT, [img], vision, params) for img in images))

    return asyncio.run(run()), sched


def serving_phase(torch, K):
    """Phase 4: the full-width model served through ContinuousScheduler."""
    import numpy as np

    from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig, DeepseekOcrEngine

    t0 = time.perf_counter()
    engine = DeepseekOcrEngine(DeepseekOcrConfig(), dtype=torch.bfloat16, device="cuda",
                               max_seq_len=4096, seed=0, kv_quant="int8")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the benchmark page: a seeded random page at sample_1.png's size
    image = np.random.default_rng(0).integers(0, 256, size=(1756, 2852, 3), dtype=np.uint8)
    vision = VisionSettings(base_size=1024, image_size=640, crop_mode=True)
    params = DecodeParameters(max_new_tokens=MAX_NEW)  # greedy, no-repeat-ngram 20
    tok = BenchTokenizer()

    vin = engine.prepare_vision_input(image, vision)
    emb = engine.compute_image_embedding(vin)
    tokens, _ = engine.build_prompt_tokens(tok, PROMPT, [vin], [emb], vision)
    s_pad = -(-len(tokens) // 128) * 128
    max_len = min(engine.max_seq_len, -(-(s_pad + MAX_NEW) // 512) * 512)
    del emb
    # warm-up (cuBLAS/cuDNN handles, allocator pools), not measured
    serve(engine, tok, [image] * 2, vision, params, n_slots=N_SLOTS, max_len=max_len, chunk=CHUNK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    outs, sched = serve(engine, tok, [image] * N_REQUESTS, vision, params,
                        n_slots=N_SLOTS, max_len=max_len, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()

    generated = [o.generated_tokens for o in outs]
    n_tokens = sum(len(g) for g in generated)
    eos = engine.cfg.language.eos_token_id
    line = {
        "phase": "serve", "requests": len(outs), "prompt_tokens": len(tokens), "max_len": max_len,
        "tokens_per_request": [len(g) for g in generated], "init_s": init_s, "wall_s": wall,
        "pages_per_s": len(outs) / wall, "decode_tok_per_s": n_tokens / wall,
        "ttft_p50_s": statistics.median(sched.ttft_samples),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "occupancy_per_chunk": sched.batch_sizes, "launches": launches,
    }
    # one more prefill to read the logits of the path (outside the window)
    pre = engine.prefill_for_slot(tok, PROMPT, [image], vision)
    line["logits_finite"] = bool(torch.isfinite(pre["logits"]).all())
    emit(line)
    require(len(outs) == N_REQUESTS, "not every request completed")
    for g, o in zip(generated, outs):
        # a row stops at its budget, or earlier only on EOS (never appended)
        require(len(g) == MAX_NEW or (len(g) < MAX_NEW and not o.truncated and eos not in g),
                f"a request returned {len(g)} of {MAX_NEW} tokens without EOS")
    require(line["logits_finite"], "non-finite logits")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    return launches


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
    emit(result)
    require(result["f32_equal"] and result["int8_equal"], "CUDA and CPU greedy tokens differ")


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
    launches = serving_phase(torch, K)
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
