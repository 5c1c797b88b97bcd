#!/usr/bin/env python3
"""Time the kernels phase of several checkouts on one CUDA card.

    python3 kernel_ab.py [--same-cases | --only megafused,kvwrite] TREE [TREE ...]

Each TREE is a directory holding a checkout (chip_smoke.py beside
dsocr_tpu_torch/), such as a parent commit unpacked with `git archive`
into a git-ignored directory. The trees run one after another, each in a
process of its own, in the order given (parent, change, change, parent
for an A/B): each builds its own kernel library and runs its own
chip_smoke.check_kernels, timed with this checkout's chip_smoke.time_ms so
that every tree is measured the same way. With --same-cases every tree
runs this checkout's check_kernels instead (its cases on the tree's
kernels), for trees whose wrappers take the same arguments. With --only,
every tree runs just this checkout's cases of the named targets:
`megafused` (chip_smoke.check_megafused: one full-width MoE layer at N 16,
11 and 32, the two-kernel sweep beside it) and `kvwrite`
(chip_smoke.check_kv_writes: the decode step's KV write, slot and paged,
int8 and bf16 caches; on a tree without slot_kv_write and paged_kv_write
the step's write as that tree made it, quantize_kv_int8 and the codes-in
kernel, stands in for them). Each kernel line is printed as chip_smoke
prints it, with the tree added; any failure exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def codes_in_writes(K):
    """For a tree whose decode step quantized the token in PyTorch: its
    step's write (quantize_kv_int8, then slot_kv_update / paged_kv_update)
    as slot_kv_write / paged_kv_write and their twins."""
    import torch

    from dsocr_tpu_torch.ops.attention import quantize_kv_int8

    def token(k, v, cache):
        k, v = k[:, :, 0], v[:, :, 0]
        if cache.dtype == torch.int8:
            (kq, ks), (vq, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
            return kq, vq, ks, vs
        return k.to(cache.dtype).contiguous(), v.to(cache.dtype).contiguous(), None, None

    def slot(update):
        return lambda k_all, v_all, ks, vs, k, v, layer, lengths: update(
            k_all, v_all, ks, vs, *token(k, v, k_all), layer, lengths)

    def paged(update):
        return lambda k_pool, v_pool, ks, vs, k, v, tables, lengths, layer: update(
            k_pool, v_pool, ks, vs, *token(k, v, k_pool), tables, lengths, layer)

    K.slot_kv_write, K.slot_kv_write_plain = slot(K.slot_kv_update), slot(K.slot_kv_update_plain)
    K.paged_kv_write, K.paged_kv_write_plain = paged(K.paged_kv_update), paged(K.paged_kv_update_plain)


def run_targets(timing, torch, K, targets) -> None:
    """This checkout's phase-3 cases of `targets` on the tree's kernels."""
    from dsocr_tpu_torch.dsq.serve_quant import quantize_expert_stack

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def record(kernel, case, err, tol, ms, plain_ms, library_ms, bnd, **extra):
        timing.emit({"phase": "kernels", "kernel": kernel, "case": case, "max_abs_err": err, "tol": tol,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bnd[0],
                     "bound_by": bnd[1], **extra})
        timing.require(err <= tol, f"{kernel} {case}: max abs err {err} > tol {tol}")

    if "kvwrite" in targets:
        if not hasattr(K, "slot_kv_write"):
            codes_in_writes(K)
        L, B, NKV, S, D = 12, 16, 10, 2560, 128
        lengths = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
        timing.check_kv_writes(torch, K, record, randn, "slot", (L, B, NKV, S), D, lengths, 5)
        P, page, P_max, per_row = 144, 128, 12, 9
        tables = torch.full((B, P_max), -1, dtype=torch.int32, device=dev)
        tables[:, :per_row] = torch.randperm(P, generator=gen, device=dev).reshape(B, per_row).int()
        tables[-1] = -1
        lengths = torch.randint(904, 904 + 128, (B,), generator=gen, device=dev, dtype=torch.int32)
        timing.check_kv_writes(torch, K, record, randn, "paged", (L, P, NKV, page), D, lengths, 5,
                               tables=tables)
    if "megafused" in targets:
        gu = quantize_expert_stack(randn(64, 1280, 1792, dtype=torch.bfloat16, std=1280 ** -0.5))
        dn = quantize_expert_stack(randn(64, 896, 1280, dtype=torch.bfloat16, std=896 ** -0.5))
        timing.check_megafused(torch, K, record, randn, gu, dn)


def run_tree(root: str, same_cases: bool, targets=None) -> None:
    """In a child process: the kernels phase of the checkout at `root`
    (with same_cases, this checkout's phase on root's kernels; with
    targets, this checkout's cases of those targets)."""
    spec = importlib.util.spec_from_file_location("timing_smoke", os.path.join(HERE, "chip_smoke.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from dsocr_tpu_torch.core.device import set_f32_precision
    from dsocr_tpu_torch.ops import kernels as K

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not the one in {root}")
    chip_smoke.time_ms = timing.time_ms
    set_f32_precision()
    if targets:
        timing.emit({"nvidia_smi": timing.smi_line()})
        run_targets(timing, torch, K, targets)
        return
    (timing if same_cases else chip_smoke).check_kernels(torch, K)


def main() -> int:
    args = sys.argv[1:]
    same = ["--same-cases"] if args[:1] == ["--same-cases"] else []
    if args[:1] == ["--only"]:
        same = args[:2]
    args = args[len(same):]
    targets = set(same[1].split(",")) if same[:1] == ["--only"] else None
    if targets is not None and not targets <= {"megafused", "kvwrite"}:
        print(__doc__, file=sys.stderr)
        return 2
    if len(args) == 2 and args[0] == "--tree":
        run_tree(os.path.abspath(args[1]), bool(same), targets)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *same, "--tree", tree],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": tree, **json.loads(line)}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
