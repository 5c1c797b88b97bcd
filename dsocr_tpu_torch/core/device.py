"""Device selection (counterpart of dsocr_tpu/core/runtime_device.py).

The port runs on one CUDA card, or on the host CPU when the caller asks
for "cpu" (the tests and the CPU twin runs do). The device is picked once
and passed explicitly to everything that allocates. No name, or "cuda",
where no GPU is present raises: a measurement or a serving run that
silently fell back to the CPU would report CPU numbers under a device's
name.

Float32 precision is set here as well: PyTorch runs f32 matmuls in full
f32 by default but cuDNN f32 convolutions in TF32 (~3 decimal digits).
The SAM neck convs (models/deepseek/sam.py) compute in f32 like the
reference, so both TF32 switches are turned off.

``is_sticky_cuda_error`` tells the errors after which the process's CUDA
context is unusable from those after which it can go on (the serving
scheduler recovers only from the latter).
"""

from __future__ import annotations

import re
from typing import Optional, Union

import torch

_ALIASES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}

# cudaError_t codes that leave the context unusable ("sticky": every later
# call fails too), with the runtime's own description of each
STICKY_CUDA_ERRORS = {
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    702: "the launch timed out and was terminated",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
}


def set_f32_precision() -> None:
    """Full-precision f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Resolve a device name: None means "cuda"; "cpu" only when asked
    for. The card without a GPU raises."""
    if isinstance(device, torch.device):
        name = device.type
    elif device is None:
        name = "cuda"
    else:
        key = str(device).strip().lower().split(":")[0]
        if key not in _ALIASES:
            raise ValueError(
                f"unsupported device {device!r}; expected one of {sorted(_ALIASES)}"
            )
        name = _ALIASES[key]
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available")
    set_f32_precision()
    return torch.device("cuda", torch.cuda.current_device()) if name == "cuda" else torch.device("cpu")


def is_sticky_cuda_error(err: BaseException) -> bool:
    """Is `err` a CUDA error that leaves the context unusable? Read from
    its message: PyTorch's ("CUDA error: an illegal memory access ...")
    or the kernel wrappers' ("CUDA error 700 at launch"). Out of memory
    and errors raised by the program are not sticky."""
    msg = str(err)
    codes = {int(code) for code in re.findall(r"CUDA error (\d+)", msg)}
    return bool(codes & STICKY_CUDA_ERRORS.keys()) or (
        "CUDA error" in msg and any(text in msg for text in STICKY_CUDA_ERRORS.values()))
