#!/usr/bin/env python3
"""Time the kernels phase of several checkouts on one CUDA card.

    python3 kernel_ab.py [--same-cases] TREE [TREE ...]

Each TREE is a directory holding a checkout (chip_smoke.py beside
dsocr_tpu_torch/), such as a parent commit unpacked with `git archive`
into a git-ignored directory. The trees run one after another, each in a
process of its own, in the order given (parent, change, change, parent
for an A/B): each builds its own kernel library and runs its own
chip_smoke.check_kernels, timed with this checkout's chip_smoke.time_ms so
that every tree is measured the same way. With --same-cases every tree
runs this checkout's check_kernels instead (its cases on the tree's
kernels), for trees whose wrappers take the same arguments. Each kernel
line is printed as chip_smoke prints it, with the tree added; any
failure exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_tree(root: str, same_cases: bool) -> None:
    """In a child process: the kernels phase of the checkout at `root`
    (with same_cases, this checkout's phase on root's kernels)."""
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
    (timing if same_cases else chip_smoke).check_kernels(torch, K)


def main() -> int:
    args = sys.argv[1:]
    same = ["--same-cases"] if args[:1] == ["--same-cases"] else []
    args = args[len(same):]
    if len(args) == 2 and args[0] == "--tree":
        run_tree(os.path.abspath(args[1]), bool(same))
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
