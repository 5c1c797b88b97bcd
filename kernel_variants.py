#!/usr/bin/env python3
"""Time variants of the kernels' sources on one CUDA card.

    python3 kernel_variants.py '{"base": [], "two_stages": [["constexpr int PF_STAGES = 3;",
                                                 "constexpr int PF_STAGES = 2;"]]}' \
        [prefill|decode|row|sam|experts|gather|gmm|megafused|kvwrite[,...]]

Each variant is a list of text substitutions applied to a copy of
dsocr_tpu_torch/csrc/ under dsocr_tpu_torch/_build/variants/<name>/ (an
empty list is the checkout's own sources); a substitution whose old text
is "DA_CHUNK" sets the decode attend's split size to the new text, in the
source and in the wrapper; one whose old text is "py:MODULE.NAME" sets that
attribute of dsocr_tpu_torch.ops.kernels.MODULE to the JSON value of the
new text for the variant (row_matmul.GEMV_MAX_N, TARGET_BLOCKS, ...). Each
variant builds its own kernel library, and every variant runs the same
inputs: flash_prefill_attention at phase 3's shapes (B 1 and B 4 at S
1792, the profile's 16 × 1024 wave), slot_decode_attention with bf16 and
int8 caches (rows ending at split edges, the serving step's 904-1031
positions, phase 3's S 2560 rows), for `row`, q8_matmul, q4k_matmul
and q6k_matmul at the main path's shapes (qkv at N 1, 16, 32 and 16384,
o and shared down at N 16, the lm_head at N 16) and, for `sam`,
sam_flash_attention at phase 3's four shapes (BH 12 and 48 at S 4096,
BH 72 and 192 at S 1600; the engine launches the larger two), and, for
`experts`, the dense expert sweeps of csrc/expert_sweep.cu at the serving
step's shapes (N 16, E 64): q8/q4k/q6k_dense_experts on a gate+up stack
(1280 → 1792) and q8_dense_experts_perx on a down stack (896 → 1280), with
the K-quants' perx at the stand-in 1792 → 1280 (substitutions such as
["static constexpr int STAGES = 3;", "static constexpr int STAGES = 4;"], BK, WN, WK,
MIN_BLOCKS_LO, MIN_BLOCKS_HI), and, for `gather`, the gather tier
(q8/q4k/q6k_gather_matmul, the same stacks) at chip_smoke's
GATHER_DRAWS (6, 24 and 60 routed selections, and 24 and 60 that share
one top-6; KSPLIT_MIN, KSPLIT_MAX, SPLIT_MIN_STAGES, MIN_BLOCKS_HI), and,
for `gmm`, gather_matmul (csrc/gather_matmul.cu) at phase 3's eight
full-width cases (gate/up and down, 96 and 12 rows, bf16 and f32) on cold
slabs (chip_smoke.cold_stacks taken in turn), and, for `megafused`, q8_moe_megafused on one full-width MoE layer at N 16, 11
and 32 with the two-kernel sweep beside it, and at N 16 on 32 and 16 of
its experts (csrc/moe_megafused.cu's CLUSTER and MIN_BLOCKS,
expert_sweep.cuh's STAGES), and, for `kvwrite`,
slot_kv_write and paged_kv_write at the serving step (16 rows, int8 and
bf16 caches, bf16 tokens) beside the step's former route
(quantize_kv_int8, then the codes-in write).
Times are chip_smoke.time_ms's (device milliseconds per call, CUDA
events); SDPA's time is printed once per slot and SAM case, and the decode
attend's two kernels are timed apart by torch.profiler. Every variant is
timed twice, all variants in turn, and each line carries the round.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys

HERE = pathlib.Path(__file__).resolve().parent


def cases(torch, K, F, which):
    """(name, call, reference output) for the chosen kernels, plus SDPA lines."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = []
    if {"all", "sam"} & which:
        for bh, s in ((12, 4096), (72, 1600), (48, 4096), (192, 1600)):
            w = int(round(s ** 0.5))
            q, k, v = randn(bh, s, 64) * 0.125, randn(bh, s, 64), randn(bh, s, 64)
            bias_h, bias_w = randn(bh, s, w) * 0.3, randn(bh, s, w) * 0.3
            args = (q, k, v, bias_h, bias_w)
            ref = K.sam_flash_attention_plain(*args, width=w)
            out.append((f"sam BH{bh} S{s}", lambda args=args, w=w: K.sam_flash_attention(*args, width=w), ref))
            bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(bh, s, s)
            out.append((f"sdpa BH{bh} S{s}",
                        lambda q=q, k=k, v=v, bias=bias: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=bias, scale=1.0),
                        None))
    if {"all", "prefill"} & which:
        for b, pads, s in ((1, [0], 1792), (4, [0, 300, 7, 1000], 1792), (16, [0] * 16, 1024)):
            q, k, v = (randn(b, 10, s, 128, dtype=torch.bfloat16) for _ in range(3))
            pad = torch.tensor(pads, dtype=torch.int32, device=dev)
            ref = K.flash_prefill_attention_plain(q, k, v, pad, scale=128 ** -0.5)
            out.append((f"prefill B{b} S{s}",
                        lambda q=q, k=k, v=v, pad=pad: K.flash_prefill_attention(q, k, v, pad, scale=128 ** -0.5),
                        ref))
    if {"all", "decode"} & which:
        B, NKV, D = 16, 10, 128
        for name, S, lengths in (
                ("edges", 1536, torch.tensor([0, 254, 255, 256, 257, 511, 512, 513] * 2, dtype=torch.int32, device=dev)),
                ("serving", 1536, torch.randint(904, 1032, (B,), generator=gen, device=dev, dtype=torch.int32)),
                ("S2560", 2560, torch.randint(0, 2560, (B,), generator=gen, device=dev, dtype=torch.int32))):
            for quant in (False, True):
                if quant:
                    def codes():
                        return torch.randint(-127, 128, (1, B, NKV, S, D), generator=gen, device=dev, dtype=torch.int8)

                    c = (codes(), codes(), randn(1, B, NKV, S).abs() * 0.02, randn(1, B, NKV, S).abs() * 0.02)
                else:
                    c = (randn(1, B, NKV, S, D, dtype=torch.bfloat16), randn(1, B, NKV, S, D, dtype=torch.bfloat16),
                         None, None)
                q = randn(B, 10, 1, D, dtype=torch.bfloat16)
                ref = K.slot_decode_attention_plain(q, *c, 0, lengths, scale=D ** -0.5)
                out.append((f"slot {name} {'int8' if quant else 'bf16'}",
                            lambda q=q, c=c, lengths=lengths: K.slot_decode_attention(q, *c, 0, lengths, scale=D ** -0.5),
                            ref))
                if not quant:
                    live = (torch.arange(S, device=dev)[None, :] <= lengths.long()[:, None])[:, None, None, :]
                    out.append((f"sdpa {name}",
                                lambda q=q, c=c, live=live: F.scaled_dot_product_attention(
                                    q, c[0][0], c[1][0], attn_mask=live, scale=D ** -0.5),
                                None))
    if {"all", "row"} & which:
        from dsocr_tpu_torch.dsq.serve_quant import quantize_plain

        shapes = (("qkv", 16384, 1280, 3840), ("qkv", 32, 1280, 3840), ("qkv", 16, 1280, 3840),
                  ("qkv", 1, 1280, 3840), ("o", 16, 1280, 1280), ("shared_down", 16, 1792, 1280),
                  ("lm_head", 16, 1280, 129280))
        for method, fn, plain, keys in (
                ("q8_0", K.q8_matmul, K.q8_matmul_plain, ("codes", "scales")),
                ("q4_k", K.q4k_matmul, K.q4k_matmul_plain, ("codes", "scales", "mins")),
                ("q6_k", K.q6k_matmul, K.q6k_matmul_plain, ("codes", "highs", "scales"))):
            for case, n, k, m in shapes:
                p = quantize_plain(randn(k, m, dtype=torch.bfloat16) * k ** -0.5, method)
                packed = tuple(p[key] for key in keys)
                x = randn(n, k, dtype=torch.bfloat16)
                out.append((f"{method} {case} N{n}",
                            lambda x=x, packed=packed, fn=fn: fn(x, *packed), plain(x, *packed)))
    if {"all", "experts"} & which:
        from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack

        for method, keys in (("q8_0", ("codes", "scales")), ("q4_k", ("codes", "scales", "mins")),
                             ("q6_k", ("codes", "highs", "scales"))):
            fmt = "q8" if method == "q8_0" else method.replace("_", "")
            down_k = 896 if method == "q8_0" else 1792  # the K-quants' perx at its stand-in shape
            for case, k, m, per_expert in (("gateup", 1280, 1792, False), ("down", down_k, 1280, True)):
                p = quantize_expert_stack(randn(64, k, m, dtype=torch.bfloat16) * k ** -0.5, method)
                packed = tuple(p[key] for key in keys)
                del p
                name = f"{fmt}_dense_experts{'_perx' if per_expert else ''}"
                fn, plain = getattr(K, name), getattr(K, f"{name}_plain")
                x = randn(*((64,) if per_expert else ()), 16, k, dtype=torch.bfloat16)
                out.append((f"{name} {case} N16 E64 K{k} M{m}",
                            lambda x=x, packed=packed, fn=fn: fn(x, *packed), plain(x, *packed)))
    if {"all", "gather"} & which:
        import chip_smoke
        from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack

        for method, keys in (("q8_0", ("codes", "scales")), ("q4_k", ("codes", "scales", "mins")),
                             ("q6_k", ("codes", "highs", "scales"))):
            fmt = "q8" if method == "q8_0" else method.replace("_", "")
            fn, plain = getattr(K, f"{fmt}_gather_matmul"), getattr(K, f"{fmt}_gather_matmul_plain")
            down_k = 896 if method == "q8_0" else 1792  # the K-quants' down at its stand-in shape
            for case, k, m in (("gateup", 1280, 1792), ("down", down_k, 1280)):
                p = quantize_expert_stack(randn(64, k, m, dtype=torch.bfloat16) * k ** -0.5, method)
                packed = tuple(p[key] for key in keys)
                del p
                for sel, sets in chip_smoke.GATHER_DRAWS:
                    x = randn(sel, k, dtype=torch.bfloat16)
                    idx = chip_smoke.routed_idx(torch, sel // chip_smoke.GATHER_TOPK, 64, gen, sets)
                    out.append((f"{fmt}_gather_matmul {case} {chip_smoke.gather_case(sel, sets)} E64 K{k} M{m}",
                                lambda x=x, packed=packed, idx=idx, fn=fn: fn(x, *packed, idx),
                                plain(x, *packed, idx)))
    if {"all", "gmm"} & which:
        import chip_smoke

        for dtype in (torch.bfloat16, torch.float32):
            for case, h, i in (("gateup", 1280, 896), ("down", 896, 1280)):
                w = randn(64, h, i, dtype=dtype) * h ** -0.5
                for rows in (96, 12):
                    idx = torch.topk(randn(rows // 6, 64), 6, dim=-1).indices.reshape(-1).to(torch.int32)
                    x = randn(rows, h, dtype=dtype)
                    copies = chip_smoke.cold_stacks(w, torch.unique(idx).numel() * h * i * w.element_size())
                    out.append((f"gather_matmul {case} {rows} rows {str(dtype)[6:]} cold",
                                chip_smoke.in_turn(lambda s, x=x, idx=idx: K.gather_matmul(x, s, idx), copies),
                                K.gather_matmul_plain(x, w, idx)))
    if {"all", "megafused"} & which:
        from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack

        gu = quantize_expert_stack(randn(64, 1280, 1792, dtype=torch.bfloat16) * 1280 ** -0.5)
        dn = quantize_expert_stack(randn(64, 896, 1280, dtype=torch.bfloat16) * 896 ** -0.5)
        # N 16, 11 and 32 on the layer's 64 experts; then N 16 on its first 32
        # and 16 experts, fewer clusters than the card holds: a cluster's own
        # chain of stages, with the card nearly empty
        for n, e in ((16, 64), (11, 64), (32, 64), (16, 32), (16, 16)):
            x = randn(n, 1280, dtype=torch.bfloat16)
            weights, idx = torch.topk(torch.softmax(randn(n, e), dim=-1), 6, dim=-1)
            w = torch.zeros((e, n), device=dev).index_put_(
                (idx.reshape(-1), torch.arange(n, device=dev).repeat_interleave(6)), weights.reshape(-1),
                accumulate=True)
            args = (x, w, gu["codes"][:e], gu["scales"][:e], dn["codes"][:e], dn["scales"][:e])
            out.append((f"q8_moe_megafused N{n} E{e}", lambda args=args: K.q8_moe_megafused(*args),
                        K.q8_moe_megafused_plain(*args)))
            if e < 64:
                continue

            def sweep(x=x, idx=idx, weights=weights, n=n):
                gates, ups = torch.chunk(K.q8_dense_experts(x, gu["codes"], gu["scales"]), 2, dim=-1)
                outs = K.q8_dense_experts_perx((F.silu(gates) * ups).to(x.dtype), dn["codes"], dn["scales"])
                return (outs[idx, torch.arange(n, device=dev)[:, None]] * weights[..., None]).sum(dim=1)

            out.append((f"sweep N{n}", sweep, None))
    if {"all", "kvwrite"} & which:
        import chip_smoke
        from dsocr_tpu_torch.ops.attention import quantize_kv_int8

        B, NKV, D = 16, 10, 128
        for layout, lead in (("slot", (12, B, NKV, 2560)), ("paged", (12, 144, NKV, 128))):
            lengths = torch.randint(904, 1032, (B,), generator=gen, device=dev, dtype=torch.int32)
            tables = torch.randperm(144, generator=gen, device=dev)[: B * 9].reshape(B, 9).int()
            where = (5, lengths) if layout == "slot" else (tables, lengths, 5)
            write, update = getattr(K, f"{layout}_kv_write"), getattr(K, f"{layout}_kv_update")
            for kind in ("int8", "bf16"):
                if kind == "int8":
                    c = [torch.randint(-127, 128, (*lead, D), device=dev, dtype=torch.int8) for _ in range(2)]
                    c += [randn(*lead).abs() * 0.02 for _ in range(2)]
                else:
                    c = [randn(*lead, D, dtype=torch.bfloat16) for _ in range(2)] + [None, None]
                k, v = chip_smoke.kv_tokens(torch, randn(B, 1, 3 * NKV * D, dtype=torch.bfloat16), NKV, D)

                def route(c=c, k=k, v=v, kind=kind, update=update, where=where):
                    if kind == "int8":
                        (kq, ks), (vq, vs) = quantize_kv_int8(k[:, :, 0]), quantize_kv_int8(v[:, :, 0])
                        return update(*c, kq, vq, ks, vs, *where)
                    return update(*c, k[:, :, 0].contiguous(), v[:, :, 0].contiguous(), None, None, *where)

                out.append((f"{layout}_kv_write {kind}", lambda c=c, k=k, v=v, write=write, where=where:
                            write(*c, k, v, *where), None))
                out.append((f"{layout} quantize + kv_update {kind}", route, None))
    return out


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1])
    which = set((sys.argv[2] if len(sys.argv) == 3 else "all").split(","))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke
    from dsocr_tpu_torch.core.device import set_f32_precision
    from dsocr_tpu_torch.ops import kernels as K
    from dsocr_tpu_torch.ops.kernels import _lib

    set_f32_precision()
    print(chip_smoke.smi_line(), flush=True)
    todo = cases(torch, K, F, which)
    src = HERE / "dsocr_tpu_torch" / "csrc"
    root = HERE / "dsocr_tpu_torch" / "_build" / "variants"
    import importlib

    settings = {}  # variant → [(module, attribute, value)]; defaults restored between variants
    defaults = {}
    for name, subs in variants.items():
        settings[name] = []
        for old, new in subs:
            if old.startswith("py:"):
                mod_name, attr = old[3:].rsplit(".", 1)
                mod = importlib.import_module(f"dsocr_tpu_torch.ops.kernels.{mod_name}")
                defaults.setdefault((mod, attr), getattr(mod, attr))
                settings[name].append((mod, attr, json.loads(new)))
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d / "csrc")
        for f in (d / "csrc").iterdir():
            text = f.read_text()
            for old, new in subs:
                if old.startswith("py:"):
                    continue
                if old == "DA_CHUNK":
                    old, new = "constexpr int DA_CHUNK = 256;", f"constexpr int DA_CHUNK = {new};"
                text = text.replace(old, new)
            f.write_text(text)
    for rnd in range(2):
        for name, subs in variants.items():
            d = root / name
            _lib.CSRC_DIR, _lib.BUILD_DIR, _lib._lib = d / "csrc", d / "build", None
            _lib.DECODE_SPLIT = int(dict(subs).get("DA_CHUNK", 256))
            for (mod, attr), value in defaults.items():
                setattr(mod, attr, value)
            for mod, attr, value in settings[name]:
                setattr(mod, attr, value)
            _lib.lib()
            for case, fn, ref in todo:
                line = {"variant": name, "round": rnd, "case": case, "ms": chip_smoke.time_ms(fn)}
                if ref is not None:
                    line["max_abs_err"] = float((fn().float() - ref.float()).abs().max())
                    if ref.dtype == torch.bfloat16:
                        line["tol"] = chip_smoke.bf16_tol(ref)
                print(json.dumps(line), flush=True)
            if rnd == 1 and {"all", "decode"} & which:
                profile_decode(torch, name, todo)
    return 0


def profile_decode(torch, name, todo):
    """Device microseconds per call of the decode attend's split and merge
    kernels (torch.profiler over 10 calls)."""
    from torch.profiler import ProfilerActivity, profile

    for case, fn, ref in todo:
        if not case.startswith("slot"):
            continue
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0)
            if us and "decode_" in ev.key:
                kernel = "split" if "split" in ev.key else "merge"
                print(json.dumps({"variant": name, "profile": case, "kernel": kernel,
                                  "us_per_call": us / 10}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
