"""ctypes binding for the Pillow-exact host resampler (``resample.cpp``),
the counterpart of dsocr_tpu/native/resample.py.

The library is built at first use with g++ into the package's
``build_dir()`` (native/__init__.py): the directory that
``DSOCR_NATIVE_CACHE`` names, else ``dsocr_tpu_torch/_build/``
(git-ignored), read at each build, where ops/kernels/_lib.py builds the
CUDA kernels too. The reference falls back
to ``~/.cache/dsocr_tpu/native``; the port keeps its builds beside the
package, so that a checkout builds everything it runs inside itself, and
an installed, read-only package names a writable directory by the knob.
The file name carries a hash of the source and
the flags, the build runs under an ``fcntl`` lock and lands by an atomic
rename, so processes that start on a cold cache at once wait for one
build and each loads a whole library. A build or load failure raises:
there is no quiet fall back to the NumPy twin.

ctypes releases the GIL for the length of each call, so the engine's
prep threads resize pages in parallel. ``build(source)`` compiles any
C++ source of this directory the same way (image/decode.py builds
``png.cpp``, ``jpeg.cpp``, ``tiff.cpp``, ``tiff_color.cpp``, ``bmp.cpp``,
``gif.cpp``, ``webp_lossless.cpp`` and ``webp_lossy.cpp``, the image
decoders' codecs, through it).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

from . import build_dir

SOURCE = pathlib.Path(__file__).resolve().with_name("resample.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8P, _F32P, _I = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int
_SIGNATURES = {
    "resize_bicubic_u8": [_U8P, _I, _I, _U8P, _I, _I],
    "resize_normalize_chw": [_U8P, _I, _I, _F32P, _I, _I, _F32P, _F32P, ctypes.c_float],
}


def library_path(source: Optional[pathlib.Path] = None) -> pathlib.Path:
    source = source or SOURCE
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"libdsocr_{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Compile a C++ source of this directory (resample.cpp by default)
    into its shared library unless it is cached."""
    source = source or SOURCE
    out = library_path(source)
    if out.exists():  # only a finished build is ever renamed into place
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        return out


def lib() -> ctypes.CDLL:
    """The loaded resampler library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = handle
        return _lib


def _source(image: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(image, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3 or src.shape[0] <= 0 or src.shape[1] <= 0:
        raise ValueError(f"expected a non-empty RGB uint8 [H, W, 3] image, got {src.shape}")
    return src


def resize_bicubic_native(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow-exact bicubic resize of RGB uint8 [H, W, 3] to [height, width, 3]."""
    if width <= 0 or height <= 0:
        raise ValueError(f"output size {width}x{height} must be positive")
    src = _source(image)
    dst = np.empty((height, width, 3), np.uint8)
    lib().resize_bicubic_u8(src.ctypes.data_as(_U8P), src.shape[0], src.shape[1],
                            dst.ctypes.data_as(_U8P), height, width)
    return dst


def resize_normalize_chw_native(image: np.ndarray, width: int, height: int, mean=(0.5, 0.5, 0.5),
                                std=(0.5, 0.5, 0.5), rescale: float = 1.0 / 255.0) -> np.ndarray:
    """Fused resize + (x · rescale − mean) / std + CHW float32 [3, height, width]."""
    if width <= 0 or height <= 0:
        raise ValueError(f"output size {width}x{height} must be positive")
    src = _source(image)
    dst = np.empty((3, height, width), np.float32)
    mean_arr = np.ascontiguousarray(mean, np.float32)
    std_arr = np.ascontiguousarray(std, np.float32)
    if mean_arr.shape != (3,) or std_arr.shape != (3,):
        raise ValueError("mean and std take one value per channel")
    lib().resize_normalize_chw(src.ctypes.data_as(_U8P), src.shape[0], src.shape[1],
                               dst.ctypes.data_as(_F32P), height, width,
                               mean_arr.ctypes.data_as(_F32P), std_arr.ctypes.data_as(_F32P),
                               ctypes.c_float(rescale))
    return dst
