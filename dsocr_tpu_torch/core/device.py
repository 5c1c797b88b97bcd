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
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_ALIASES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


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
