"""Which torch.distributed backend two ranks sharing one CUDA card can use.

The mesh of dsocr_tpu_torch/parallel picks gloo when its ranks share a
card (comm.choose_backend). This script checks that choice with two
ranks on card 0, each in a spawned process of its own:

- nccl: one all_reduce of a CUDA tensor (NCCL refuses two ranks on one
  device; with NCCL_DEBUG=WARN its log says "Duplicate GPU detected");
- gloo: all_reduce, broadcast and gather of CUDA tensors, the three
  collectives the mesh makes (parallel/comm.py hands gloo its CUDA
  tensors as they are), each result checked.

Prints the card's name and power limit, one JSON line per backend, and
last {"ok": ...}: true when gloo's three collectives give the right
values. Run on a machine with a CUDA card: python3 mesh_backends.py
"""

import datetime
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import time

TIMEOUT_S = 30


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, backend: str, init: str, queue) -> None:
    import torch
    import torch.distributed as dist

    result = {"rank": rank}
    if backend == "nccl":  # NCCL's own reason for a refusal, on this rank's output
        os.environ.setdefault("NCCL_DEBUG", "WARN")
    try:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        checks = {}
        x = torch.full((4096,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        checks["all_reduce"] = bool((x == world * (world + 1) / 2).all())
        if backend == "gloo":
            b = torch.full((4096,), float(rank + 7), device=dev)
            dist.broadcast(b, src=0)
            checks["broadcast"] = bool((b == 7).all())
            g = torch.full((64,), float(rank), device=dev)
            parts = [torch.empty_like(g) for _ in range(world)] if rank == 0 else None
            dist.gather(g, parts, dst=0)
            if rank == 0:
                checks["gather"] = all(p.is_cuda and bool((p == r).all()) for r, p in enumerate(parts))
        result.update(ok=all(checks.values()), checks=checks)
    except Exception as err:
        result.update(ok=False, error=f"{type(err).__name__}: {str(err).splitlines()[0][:300]}")
    finally:
        queue.put(result)
        if dist.is_initialized():
            dist.destroy_process_group()


def run(backend: str, world: int = 2) -> dict:
    """Two ranks of `backend` on card 0 → {"backend", "ranks": [...]}."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank, args=(r, world, backend, init, queue), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, hung = [], []
    deadline = time.monotonic() + 3 * TIMEOUT_S
    for _ in procs:
        try:
            results.append(queue.get(timeout=max(0.1, deadline - time.monotonic())))
        except Exception:
            break
    for r, p in enumerate(procs):
        p.join(max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            hung.append(r)
            p.kill()
            p.join(5)
    return {"backend": backend, "ranks": sorted(results, key=lambda x: x["rank"]), "hung": hung,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_backends: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi)
    nccl = run("nccl")
    print(json.dumps(nccl))
    gloo = run("gloo")
    print(json.dumps(gloo))
    ok = not gloo["hung"] and len(gloo["ranks"]) == 2 and all(r["ok"] for r in gloo["ranks"])
    print(json.dumps({"ok": ok, "nccl_ok": all(r["ok"] for r in nccl["ranks"]) and len(nccl["ranks"]) == 2}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
