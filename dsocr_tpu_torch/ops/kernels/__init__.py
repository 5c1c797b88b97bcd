"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper each.

Each wrapper runs its plain PyTorch twin (``*_plain``, same module) on a
CPU tensor, launches its kernel on a CUDA tensor (or raises — it never
falls back), and counts its launches in a plain int attribute
``wrapper.launches``. ``KERNELS`` lists them with their source and the
TPU kernel each replaces.
"""

from .prefill_attention import flash_prefill_attention, flash_prefill_attention_plain
from .sam_attention import sam_flash_attention, sam_flash_attention_plain
from .slot_attention import (
    slot_decode_attention,
    slot_decode_attention_plain,
    slot_kv_update,
    slot_kv_update_plain,
)

# (wrapper, source, replaced TPU kernel's pallas_call site)
KERNELS = (
    (sam_flash_attention, "dsocr_tpu_torch/csrc/sam_attention.cu",
     "dsocr_tpu/ops/pallas/sam_attention.py:92"),
    (flash_prefill_attention, "dsocr_tpu_torch/csrc/prefill_attention.cu",
     "dsocr_tpu/ops/pallas/prefill_attention.py:101"),
    (slot_kv_update, "dsocr_tpu_torch/csrc/slot_attention.cu",
     "dsocr_tpu/ops/pallas/slot_attention.py:278"),
    (slot_decode_attention, "dsocr_tpu_torch/csrc/slot_attention.cu",
     "dsocr_tpu/ops/pallas/slot_attention.py:436"),
)


def reset_launches() -> None:
    for fn, _, _ in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn, _, _ in KERNELS}


__all__ = [
    "KERNELS",
    "flash_prefill_attention",
    "flash_prefill_attention_plain",
    "launch_counts",
    "reset_launches",
    "sam_flash_attention",
    "sam_flash_attention_plain",
    "slot_decode_attention",
    "slot_decode_attention_plain",
    "slot_kv_update",
    "slot_kv_update_plain",
]
