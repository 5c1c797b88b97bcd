"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile with nvcc into ONE shared library with a plain C
interface, at first use, into ``dsocr_tpu_torch/_build/`` (git-ignored).
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

PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "dsocr_sam_flash_attention": [_P] * 6 + [_I] * 6 + [_P],
    "dsocr_flash_prefill_attention": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
    "dsocr_slot_kv_update": [_P] * 9 + [_I] * 6 + [_P],
    "dsocr_slot_decode_attention": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    "dsocr_q8_matmul": [_P] * 4 + [_I] * 4 + [_P],
    "dsocr_q8_expert_matmul": [_P] * 5 + [_I] * 5 + [_L, _I, _P],
    "dsocr_q4k_matmul": [_P] * 5 + [_I] * 4 + [_P],
    "dsocr_q4k_expert_matmul": [_P] * 6 + [_I] * 5 + [_L, _I, _P],
    "dsocr_q6k_matmul": [_P] * 5 + [_I] * 4 + [_P],
    "dsocr_q6k_expert_matmul": [_P] * 6 + [_I] * 5 + [_L, _I, _P],
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
    return BUILD_DIR / f"libdsocr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the shared library unless it is cached."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            build_info.update(path=str(out), nvcc_s=0.0)
            return out
        cu, _ = _sources()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        build_info.update(path=str(out), nvcc_s=seconds)
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
