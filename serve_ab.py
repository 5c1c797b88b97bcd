"""Serving bursts of two trees of the PyTorch port on one card, alternated.

    python3 serve_ab.py [--towers | --gather | --profiles] PARENT_ROOT . . PARENT_ROOT

Each argument is the root of a tree that holds a ``dsocr_tpu_torch/``
package. The trees run one after another in the order given, each in a
process of its own, so that they share the card and the host's load;
name them parent, change, change, parent. Every process builds its tree's
kernels, then runs the bf16 and the Q6_K serving bursts of this file's
``chip_smoke.py`` on that tree's package: 16 requests of 128 greedy tokens
over 16 slots on the seeded page, after a 2-request warm-up, each followed
by its profile (prefill wave and decode steps, host and device time).
With ``--towers`` a process runs only ``chip_smoke.tower_profile`` on the
bf16 engine instead: the vision towers of 16 pages, device ms and the SAM
attention's share. With ``--gather`` it runs the Q8_0 engine's gather
tier instead: the 4-slot burst of 4 requests × 32 tokens with its
``_trace`` line (the tier's device ms, the distinct experts of each
launch), then single-request decode with the tier's device ms a token. With
``--profiles`` it runs only ``chip_smoke.profile_phase`` on the page's
packet (no burst) for every serving format: bf16, Q8_0, Q4_K, Q6_K, and
the Q8_0 engine with a paged pool and the megafused chain (the decode
step's host and device ms and its kernel launches).
Every line it prints is ``chip_smoke.py``'s, with
``"tree"`` added. It exits non-zero if any run fails, and needs one CUDA
card.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_tree(root: str, mode: str = "") -> int:
    """The bursts (or with mode "--towers" the tower profile, with
    "--gather" the gather tier's burst and decode, with "--profiles" every
    format's profile) on the package under `root`, measured by this file's
    chip_smoke.py."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    import dsocr_tpu_torch
    from dsocr_tpu_torch.core.device import set_f32_precision
    from dsocr_tpu_torch.ops import kernels as K
    from dsocr_tpu_torch.ops.kernels import _lib

    cs.require(os.path.dirname(os.path.abspath(dsocr_tpu_torch.__file__)) ==
               os.path.join(root, "dsocr_tpu_torch"), f"the package was not imported from {root}")
    emit = cs.emit
    cs.emit = lambda obj: emit({**obj, "tree": root})
    set_f32_precision()
    _lib.lib()
    if mode == "--towers":
        cs.tower_profile(torch, K, cs.full_width_engine(torch), pages=16)
        return 0
    if mode == "--gather":
        engine = cs.full_width_engine(torch, quantize="q8_0")
        cs.serving_phase(torch, K, "serve_q8_gather", engine, n_requests=4, n_slots=4, max_new=32,
                         required=["q8_gather_matmul"], trace_gather=True)
        cs.decode_phase(torch, K, engine, cs.smi_line(),
                        required=["sam_flash_attention", "flash_prefill_attention", "q8_gather_matmul"])
        return 0
    if mode == "--profiles":
        for quantize in (None, "q8_0", "q4_k", "q6_k"):
            engine = cs.full_width_engine(torch, quantize=quantize)
            cs.profile_packet(torch, K, engine)
            if quantize == "q8_0":
                with cs.environ(DSOCR_Q8_MEGAFUSED="1"):
                    cs.profile_packet(torch, K, engine, paged=True)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        return 0
    # the decode step's KV write: the token-quantizing wrapper where the tree has one
    write = "slot_kv_write" if hasattr(K, "slot_kv_write") else "slot_kv_update"
    attention = ["sam_flash_attention", "flash_prefill_attention", write, "slot_decode_attention"]
    for quantize, phase, kernels in ((None, "serve", []),
                                     ("q6_k", "serve_q6k", ["q6k_matmul", "q6k_dense_experts"])):
        engine = cs.full_width_engine(torch, quantize=quantize)
        cs.serving_phase(torch, K, phase, engine, n_requests=cs.N_REQUESTS, n_slots=cs.N_SLOTS,
                         max_new=cs.MAX_NEW, required=attention + kernels, profile=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--tree":
        return run_tree(argv[1], *argv[2:])
    flag = argv[:1] if argv[:1] in (["--towers"], ["--gather"], ["--profiles"]) else []
    argv = argv[len(flag):]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"nvidia_smi": smi.stdout.strip(), "order": argv}), flush=True)
    failed = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", root, *flag], timeout=600)
        if proc.returncode:
            failed.append((root, proc.returncode))
    if failed:
        print(f"serve_ab: failed runs {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
