"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own nvcc, all started together, and the
objects link into ONE shared library with a plain C interface, at first
use, into the native package's ``build_dir()`` (``DSOCR_NATIVE_CACHE``,
else ``dsocr_tpu_torch/_build/``, git-ignored; read at each build).
The file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached library. The
library is bound with ctypes: every pointer and the stream travel as
``c_void_p``, and every C entry returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module,
and this machine class has no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

from ...native import build_dir

PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# positions per split of the decode attend (csrc/kv_attention.cuh: DA_CHUNK)
DECODE_SPLIT = 256

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "dsocr_sam_flash_attention": [_P] * 6 + [_I] * 6 + [_P],
    "dsocr_flash_prefill_attention": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
    "dsocr_slot_kv_update": [_P] * 9 + [_I] * 6 + [_P],
    "dsocr_slot_kv_write": [_P] * 7 + [_L] * 4 + [_I] * 7 + [_P],
    "dsocr_slot_decode_attention": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "dsocr_paged_kv_update": [_P] * 10 + [_I] * 8 + [_P],
    "dsocr_paged_kv_write": [_P] * 8 + [_L] * 4 + [_I] * 9 + [_P],
    "dsocr_paged_decode_attention": [_P] * 9 + [_I] * 8 + [_F, _I, _I, _P],
    "dsocr_row_matmul": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    "dsocr_q8_expert_matmul": [_P] * 5 + [_I] * 5 + [_L, _I, _P],
    "dsocr_q8_moe_megafused": [_P] * 8 + [_I] * 5 + [_P, _P],
    "dsocr_q4k_expert_matmul": [_P] * 6 + [_I] * 5 + [_L, _I, _P],
    "dsocr_q6k_expert_matmul": [_P] * 6 + [_I] * 5 + [_L, _I, _P],
    "dsocr_gather_matmul": [_P] * 4 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# filled by the build: library path and nvcc seconds (0 on a cache hit)
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> pathlib.Path:
    cu, cuh = _sources()
    digest = hashlib.sha256()
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libdsocr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the shared library unless it is cached."""
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            build_info.update(path=str(out), nvcc_s=0.0)
            return out
        cu, _ = _sources()
        nvcc = _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        objs = [out.with_suffix(f".{src.stem}.tmp{os.getpid()}.o") for src in cu]
        # a log file per nvcc (no pipe to fill), beside the objects
        logs = [open(obj.with_suffix(".log"), "w+") for obj in objs]
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=log, stderr=subprocess.STDOUT)
            for src, obj, log in zip(cu, objs, logs)
        ]
        try:
            failed = []
            for src, proc, log in zip(cu, procs, logs):
                if proc.wait() != 0:
                    log.seek(0)
                    failed.append(f"{src.name} ({proc.returncode}):\n{log.read()}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for obj, log in zip(objs, logs):
                obj.unlink(missing_ok=True)
                log.close()
                os.unlink(log.name)
        os.replace(tmp, out)
        build_info.update(path=str(out), nvcc_s=time.perf_counter() - t0)
        return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def count_launch(wrapper) -> None:
    """One more launch on `wrapper.launches` (the prefill and decode
    workers launch from different threads)."""
    with _count_lock:
        wrapper.launches += 1


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def decode_partials(B: int, NKV: int, capacity: int, G: int, Dv: int, device):
    """(splits, scratch) of the split-K decode attend: one split per
    DECODE_SPLIT positions of the cache's capacity, and per (row, KV head,
    split, query head) its running max, sum and value sum (Dv + 2 f32)."""
    splits = -(-capacity // DECODE_SPLIT)
    part = torch.empty(B * NKV * splits * G * (Dv + 2), dtype=torch.float32, device=device)
    return splits, part


def require_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor on one
    device — the kernels take raw pointers and assume dense layouts."""
    device = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
