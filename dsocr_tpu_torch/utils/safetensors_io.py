"""Safetensors checkpoint access without the safetensors package
(dsocr_tpu/utils/safetensors_io.py).

A safetensors file is an 8-byte little-endian header length, a JSON header
({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus an optional
``__metadata__``), then the tensors' bytes, offsets counted from the end
of the header. ``CheckpointReader`` maps each file once (a private
copy-on-write mapping, so a tensor handed out is writable and nothing is
copied until it is written) and returns CPU tensors over the mapping in
their stored dtype: bf16 comes through ``torch.frombuffer`` as bf16, with
no f32 copy and no ``ml_dtypes``. A tensor whose bytes do not start on a
multiple of its element size is copied out instead of viewed. A
``*.safetensors.index.json`` shard set reads through its ``weight_map``.

The reference's ``_decode_ml_dtypes`` (turning any uint16 array into
bf16, a workaround for some safetensors versions) is not copied: the
dtype comes from the header.
"""

from __future__ import annotations

import json
import mmap
import pathlib
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


class _Shard:
    """One mapped safetensors file: its header and its data's start."""

    def __init__(self, path: pathlib.Path):
        with open(path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
            self.mmap = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.entries: Dict[str, dict] = header
        self.base = 8 + n
        self.path = path

    def tensor(self, name: str) -> torch.Tensor:
        entry = self.entries[name]
        if entry["dtype"] not in DTYPES:
            raise ValueError(f"tensor {name!r} in {self.path.name}: unsupported dtype {entry['dtype']!r}")
        dtype = DTYPES[entry["dtype"]]
        shape: Tuple[int, ...] = tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        numel = 1
        for d in shape:
            numel *= d
        if count != numel or (end - begin) % itemsize:
            raise ValueError(f"tensor {name!r}: {end - begin} bytes for shape {list(shape)} {entry['dtype']}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        start = self.base + begin
        if start % itemsize:  # a view would be misaligned: copy the bytes out
            return torch.frombuffer(bytearray(self.mmap[start : self.base + end]), dtype=dtype).reshape(shape)
        return torch.frombuffer(self.mmap, dtype=dtype, count=count, offset=start).reshape(shape)


class CheckpointReader:
    """name → CPU tensor over one safetensors file or a shard set
    (``weights_path`` a ``.safetensors`` file, its ``.index.json``, or a
    file name whose ``<name>.index.json`` exists beside it)."""

    def __init__(self, weights_path):
        weights_path = pathlib.Path(weights_path)
        index_candidate = weights_path.parent / (weights_path.name + ".index.json")
        if weights_path.suffix != ".json" and not weights_path.exists() and index_candidate.exists():
            weights_path = index_candidate
        self._shards: Dict[pathlib.Path, _Shard] = {}
        if weights_path.suffix == ".json":
            index = json.loads(weights_path.read_text())
            self._files = {name: weights_path.parent / shard for name, shard in index["weight_map"].items()}
        else:
            self._files = dict.fromkeys(self._shard(weights_path).entries, weights_path)

    def _shard(self, path: pathlib.Path) -> _Shard:
        if path not in self._shards:
            self._shards[path] = _Shard(path)
        return self._shards[path]

    def keys(self) -> List[str]:
        return list(self._files)

    def __contains__(self, name: str) -> bool:
        return name in self._files

    def get(self, name: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The tensor in its stored dtype (a view of the file where it is
        aligned), or cast to `dtype`."""
        if name not in self._files:
            raise KeyError(f"tensor {name!r} not in checkpoint")
        t = self._shard(self._files[name]).tensor(name)
        return t if dtype is None else t.to(dtype)

    def get_optional(self, name: str, dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
        return self.get(name, dtype) if name in self._files else None

    def iter_prefix(self, prefix: str) -> Iterator[str]:
        for name in self._files:
            if name.startswith(prefix):
                yield name
