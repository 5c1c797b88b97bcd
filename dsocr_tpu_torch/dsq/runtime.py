"""Snapshot-aware weight source (dsocr_tpu/dsq/runtime.py).

A ``.dsq`` record for a linear overrides the float checkpoint's tensor of
the same name (the reference's dsq-runtime SnapshotLoadPlan). Snapshot
records are named without the ``.weight`` suffix
(``model.layers.0.self_attn.q_proj``); checkpoint tensors carry it.
Checkpoint tensors come back as CPU tensors in their stored dtype;
snapshot records are decoded on ``device`` (the card unless the caller
names the CPU) into f32, as the reference dequantizes them.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import torch

from ..core.device import select_device
from ..utils.safetensors_io import CheckpointReader
from .format import BLOCK_SIZES, DsqReader


class WeightSource:
    """The CheckpointReader interface over a checkpoint and a snapshot,
    counting the tensors each served (``quantized_hits`` from the snapshot,
    ``float_hits`` from the checkpoint)."""

    def __init__(self, checkpoint: Optional[CheckpointReader], snapshot: Optional[DsqReader] = None,
                 device=None):
        self.checkpoint = checkpoint
        self.snapshot = snapshot
        self.device = select_device(device)
        self.quantized_hits = 0
        self.float_hits = 0

    @classmethod
    def open(cls, weights_path: Optional[pathlib.Path], snapshot_path: Optional[pathlib.Path] = None,
             device=None) -> "WeightSource":
        checkpoint = CheckpointReader(weights_path) if weights_path else None
        snapshot = DsqReader(snapshot_path) if snapshot_path else None
        return cls(checkpoint, snapshot, device)

    def _snapshot_name(self, name: str) -> Optional[str]:
        if self.snapshot is None:
            return None
        base = name[: -len(".weight")] if name.endswith(".weight") else name
        return base if base in self.snapshot else None

    def __contains__(self, name: str) -> bool:
        if self._snapshot_name(name) is not None:
            return True
        return self.checkpoint is not None and name in self.checkpoint

    def get(self, name: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if name.endswith(".weight"):
            snap = self._snapshot_name(name)
            if snap is not None:
                self.quantized_hits += 1
                return self.snapshot.dequantize(snap, dtype or torch.float32, self.device)
        if self.checkpoint is not None and name in self.checkpoint:
            self.float_hits += 1
            return self.checkpoint.get(name, dtype)
        if self.snapshot is not None and name.endswith(".bias"):
            record = self.snapshot.tensor(name[: -len(".bias")])
            if record is not None:
                bias = self.snapshot.bias_array(record)
                if bias is not None:
                    return bias.to(dtype or torch.float32)
        raise KeyError(f"tensor {name!r} not in checkpoint or snapshot")

    def get_optional(self, name: str, dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
        try:
            return self.get(name, dtype)
        except KeyError:
            return None

    def raw_quant(self, name: str):
        """(payload, q_dtype, out_dim, in_dim) when the snapshot stores
        `name` as a ggml-quantized record, the payload a uint8 CPU tensor
        over the file: the serving path packs the published codes from it
        (dsq/serve_quant.py). None for float records and checkpoint-only
        tensors."""
        snap = self._snapshot_name(name)
        if snap is None:
            return None
        record = self.snapshot.tensor(snap)
        if record.q_dtype not in BLOCK_SIZES:
            return None
        return self.snapshot.payload(record), record.q_dtype, record.out_dim, record.in_dim

    def iter_prefix(self, prefix: str):
        if self.checkpoint is not None:
            yield from self.checkpoint.iter_prefix(prefix)
