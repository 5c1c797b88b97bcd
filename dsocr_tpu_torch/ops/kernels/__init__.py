"""Hand-written CUDA kernels for Hopper (sm_90a), one wrapper each.

Each wrapper runs its plain PyTorch twin (``*_plain``, same module) on a
CPU tensor, launches its kernel on a CUDA tensor (or raises — it never
falls back), and counts its launches in a plain int attribute
``wrapper.launches``. ``KERNELS`` lists them with their source and the
TPU kernel each replaces.
"""

from .dequant_matmul import (
    q8_dense_experts,
    q8_dense_experts_perx,
    q8_dense_experts_perx_plain,
    q8_dense_experts_plain,
    q8_gather_matmul,
    q8_gather_matmul_plain,
    q8_matmul,
    q8_matmul_plain,
    q8_moe_megafused,
    q8_moe_megafused_plain,
)
from .gather_matmul import gather_matmul, gather_matmul_plain
from .kquant_matmul import (
    q4k_dense_experts,
    q4k_dense_experts_perx,
    q4k_dense_experts_perx_plain,
    q4k_dense_experts_plain,
    q4k_gather_matmul,
    q4k_gather_matmul_plain,
    q4k_matmul,
    q4k_matmul_plain,
    q6k_dense_experts,
    q6k_dense_experts_perx,
    q6k_dense_experts_perx_plain,
    q6k_dense_experts_plain,
    q6k_gather_matmul,
    q6k_gather_matmul_plain,
    q6k_matmul,
    q6k_matmul_plain,
)
from .paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_kv_update,
    paged_kv_update_plain,
    paged_kv_write,
    paged_kv_write_plain,
)
from .prefill_attention import flash_prefill_attention, flash_prefill_attention_plain
from .sam_attention import sam_flash_attention, sam_flash_attention_plain
from .slot_attention import (
    slot_decode_attention,
    slot_decode_attention_plain,
    slot_kv_update,
    slot_kv_update_plain,
    slot_kv_write,
    slot_kv_write_plain,
)

_DQ = "dsocr_tpu/ops/pallas/dequant_matmul.py"
_KQ = "dsocr_tpu/ops/pallas/kquant_matmul.py"
_PA = "dsocr_tpu/ops/pallas/paged_attention.py"
_QKV = "dsocr_tpu/ops/attention.py:83 (quantize_kv_int8, XLA)"

# (wrapper, source, replaced TPU kernels' pallas_call sites)
KERNELS = (
    (sam_flash_attention, "dsocr_tpu_torch/csrc/sam_attention.cu",
     "dsocr_tpu/ops/pallas/sam_attention.py:92"),
    (flash_prefill_attention, "dsocr_tpu_torch/csrc/prefill_attention.cu",
     "dsocr_tpu/ops/pallas/prefill_attention.py:101"),
    (slot_kv_update, "dsocr_tpu_torch/csrc/slot_attention.cu",
     "dsocr_tpu/ops/pallas/slot_attention.py:278"),
    (slot_kv_write, "dsocr_tpu_torch/csrc/slot_attention.cu",
     f"dsocr_tpu/ops/pallas/slot_attention.py:278 (slot_kv_update), {_QKV}"),
    (slot_decode_attention, "dsocr_tpu_torch/csrc/slot_attention.cu",
     "dsocr_tpu/ops/pallas/slot_attention.py:436"),
    (q8_matmul, "dsocr_tpu_torch/csrc/row_matmul.cu",
     f"{_DQ}:171 (q8_matmul), {_DQ}:312 (q8_matmul_layered)"),
    (q8_gather_matmul, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_DQ}:250 (q8_gather_matmul), {_DQ}:381 (q8_gather_matmul_layered)"),
    (q8_dense_experts, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_DQ}:480 (q8_dense_experts_layered)"),
    (q8_dense_experts_perx, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_DQ}:520 (q8_dense_experts_perx_layered)"),
    (q4k_matmul, "dsocr_tpu_torch/csrc/row_matmul.cu",
     f"{_KQ}:225 (q4k_matmul), {_KQ}:362 (q4k_matmul_layered)"),
    (q4k_gather_matmul, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_KQ}:593 (q4k_gather_matmul), {_KQ}:633 (q4k_gather_matmul_layered)"),
    (q4k_dense_experts, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_KQ}:844 (q4k_dense_experts_layered)"),
    (q4k_dense_experts_perx, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_KQ}:908 (q4k_dense_experts_perx_layered)"),
    (q6k_matmul, "dsocr_tpu_torch/csrc/row_matmul.cu",
     f"{_KQ}:294 (q6k_matmul), {_KQ}:430 (q6k_matmul_layered)"),
    (q6k_gather_matmul, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_KQ}:729 (q6k_gather_matmul), {_KQ}:770 (q6k_gather_matmul_layered)"),
    (q6k_dense_experts, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_KQ}:982 (q6k_dense_experts_layered)"),
    (q6k_dense_experts_perx, "dsocr_tpu_torch/csrc/expert_sweep.cu",
     f"{_KQ}:1025 (q6k_dense_experts_perx_layered)"),
    (q8_moe_megafused, "dsocr_tpu_torch/csrc/moe_megafused.cu",
     f"{_DQ}:669 (q8_moe_megafused_layered)"),
    (paged_kv_update, "dsocr_tpu_torch/csrc/paged_attention.cu", f"{_PA}:312"),
    (paged_kv_write, "dsocr_tpu_torch/csrc/paged_attention.cu", f"{_PA}:312 (paged_kv_update), {_QKV}"),
    (paged_decode_attention, "dsocr_tpu_torch/csrc/paged_attention.cu", f"{_PA}:158"),
    (gather_matmul, "dsocr_tpu_torch/csrc/gather_matmul.cu",
     "dsocr_tpu/ops/pallas/gather_matmul.py:86"),
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
    "gather_matmul",
    "gather_matmul_plain",
    "launch_counts",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_kv_update",
    "paged_kv_update_plain",
    "paged_kv_write",
    "paged_kv_write_plain",
    "q4k_dense_experts",
    "q4k_dense_experts_perx",
    "q4k_dense_experts_perx_plain",
    "q4k_dense_experts_plain",
    "q4k_gather_matmul",
    "q4k_gather_matmul_plain",
    "q4k_matmul",
    "q4k_matmul_plain",
    "q6k_dense_experts",
    "q6k_dense_experts_perx",
    "q6k_dense_experts_perx_plain",
    "q6k_dense_experts_plain",
    "q6k_gather_matmul",
    "q6k_gather_matmul_plain",
    "q6k_matmul",
    "q6k_matmul_plain",
    "q8_dense_experts",
    "q8_dense_experts_perx",
    "q8_dense_experts_perx_plain",
    "q8_dense_experts_plain",
    "q8_gather_matmul",
    "q8_gather_matmul_plain",
    "q8_matmul",
    "q8_matmul_plain",
    "q8_moe_megafused",
    "q8_moe_megafused_plain",
    "reset_launches",
    "sam_flash_attention",
    "sam_flash_attention_plain",
    "slot_decode_attention",
    "slot_decode_attention_plain",
    "slot_kv_update",
    "slot_kv_update_plain",
    "slot_kv_write",
    "slot_kv_write_plain",
]
