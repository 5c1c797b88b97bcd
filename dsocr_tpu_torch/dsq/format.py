"""The ``.dsq`` container (dsocr_tpu/dsq/format.py): reader and writer.

Byte for byte the reference's format (crates/dsq/src/lib.rs): magic
``DSQSNAP``, version 1, a little-endian header {candle_version, model_id,
backend, default_qdtype, block_size, tensor_count}, then one record per
tensor {name, out_dim, in_dim, q_dtype, q_offset, q_len, bias_offset,
bias_len, bias_dtype}, then the payloads (each tensor's, then its bias).
Strings are u32-length-prefixed UTF-8. Files either package writes read
in the other.

The reader maps the file once (a private copy-on-write mapping) and hands
out payloads as uint8 CPU tensors over it (``payload``), bytes where the
reference does (``tensor_bytes``), biases and dequantized weights as
tensors; ``dequantize`` decodes on the device it is given. The writer
takes tensors on any device (``quantize_and_add`` quantizes where the
weights lie) and keeps the payloads until ``finalize`` writes the file.
"""

from __future__ import annotations

import dataclasses
import mmap
import pathlib
import struct
from typing import Dict, List, Optional

import torch

from .quant import to_bytes

MAGIC = b"DSQSNAP"
VERSION = 1

# dtype codes (ref dsq/src/lib.rs:60-70)
TENSOR_DTYPE_CODES = {"Q8_0": 8, "Q4_K": 12, "Q6_K": 14, "F16": 1, "BF16": 16, "F32": 0}
TENSOR_DTYPE_NAMES = {v: k for k, v in TENSOR_DTYPE_CODES.items()}
BIAS_DTYPE_CODES = {"U8": 0, "U32": 1, "I64": 2, "F16": 3, "F32": 4, "F64": 5, "BF16": 6}
BIAS_DTYPE_NAMES = {v: k for k, v in BIAS_DTYPE_CODES.items()}
BLOCK_SIZES = {"Q8_0": 32, "Q4_K": 256, "Q6_K": 256}
FLOAT_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_BIAS_TORCH = {"U8": torch.uint8, "U32": getattr(torch, "uint32", None), "I64": torch.int64,
               "F16": torch.float16, "F32": torch.float32, "F64": torch.float64, "BF16": torch.bfloat16}
# the bias dtypes the reference's writer takes (it writes no BF16 bias)
_WRITER_BIAS = {v: k for k, v in _BIAS_TORCH.items() if v is not None and k != "BF16"}


@dataclasses.dataclass
class DsqHeader:
    version: int
    candle_version: str
    model_id: str
    backend: str
    default_qdtype: str
    block_size: int
    tensor_count: int


@dataclasses.dataclass
class DsqRecord:
    name: str
    out_dim: int
    in_dim: int
    q_dtype: str
    q_offset: int
    q_len: int
    bias_offset: Optional[int] = None
    bias_len: Optional[int] = None
    bias_dtype: Optional[str] = None


def _read_string(buf, pos: int):
    (length,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    return bytes(buf[pos : pos + length]).decode("utf-8"), pos + length


def _pack_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<I", len(raw)) + raw


class DsqReader:
    """A ``.dsq`` file's header and records over one mapping."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        with open(self.path, "rb") as fh:
            self._mmap = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        buf = self._mmap
        if bytes(buf[:7]) != MAGIC:
            raise ValueError(f"invalid snapshot magic: {bytes(buf[:7])!r}")
        pos = 7
        (version,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if version != VERSION:
            raise ValueError(f"unsupported snapshot version {version}, expected {VERSION}")
        candle_version, pos = _read_string(buf, pos)
        model_id, pos = _read_string(buf, pos)
        backend, pos = _read_string(buf, pos)
        qdtype_code, block_size, tensor_count = struct.unpack_from("<III", buf, pos)
        pos += 12
        if block_size == 0:
            raise ValueError("block_size must be non-zero")
        qdtype = TENSOR_DTYPE_NAMES.get(qdtype_code)
        if qdtype is None:
            raise ValueError(f"unsupported tensor dtype code {qdtype_code}")
        if BLOCK_SIZES.get(qdtype) != block_size:
            raise ValueError(
                f"snapshot block size {block_size} mismatches expected {BLOCK_SIZES.get(qdtype)} for {qdtype}")
        self.records: List[DsqRecord] = []
        self._index: Dict[str, int] = {}
        for _ in range(tensor_count):
            name, pos = _read_string(buf, pos)
            out_dim, in_dim, q_dtype_code = struct.unpack_from("<III", buf, pos)
            q_offset, q_len, bias_offset, bias_len = struct.unpack_from("<QQQQ", buf, pos + 12)
            (bias_dtype_code,) = struct.unpack_from("<I", buf, pos + 44)
            pos += 48
            q_dtype = TENSOR_DTYPE_NAMES.get(q_dtype_code)
            if q_dtype is None:
                raise ValueError(f"unsupported tensor dtype code {q_dtype_code}")
            record = DsqRecord(
                name=name, out_dim=out_dim, in_dim=in_dim, q_dtype=q_dtype, q_offset=q_offset,
                q_len=q_len,
                bias_offset=bias_offset if bias_len else None,
                bias_len=bias_len if bias_len else None,
                bias_dtype=BIAS_DTYPE_NAMES[bias_dtype_code] if bias_len else None,
            )
            if q_len == 0:
                raise ValueError(f"tensor `{name}` has empty quantized payload")
            if name in self._index:
                raise ValueError(f"duplicate tensor record `{name}`")
            self._index[name] = len(self.records)
            self.records.append(record)
        self.metadata_len = pos
        for record in self.records:
            if record.q_offset < self.metadata_len:
                raise ValueError(f"tensor `{record.name}` q_offset {record.q_offset} overlaps metadata")
            if record.q_offset + record.q_len > len(self._mmap):
                raise ValueError(f"tensor `{record.name}` exceeds file size")
        self.header = DsqHeader(
            version=version, candle_version=candle_version, model_id=model_id, backend=backend,
            default_qdtype=qdtype, block_size=block_size, tensor_count=tensor_count,
        )

    def close(self) -> None:
        """Unmap the file (raises BufferError while a tensor from
        ``payload`` or ``bias_array`` still views it)."""
        self._mmap.close()

    def tensor(self, name: str) -> Optional[DsqRecord]:
        idx = self._index.get(name)
        return self.records[idx] if idx is not None else None

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def _view(self, offset: int, length: int) -> torch.Tensor:
        return torch.frombuffer(self._mmap, dtype=torch.uint8, count=length, offset=offset)

    def payload(self, record: DsqRecord) -> torch.Tensor:
        """The record's payload as a uint8 CPU tensor over the file."""
        return self._view(record.q_offset, record.q_len)

    def tensor_bytes(self, record: DsqRecord) -> bytes:
        return self._mmap[record.q_offset : record.q_offset + record.q_len]

    def bias_array(self, record: DsqRecord) -> Optional[torch.Tensor]:
        if record.bias_len is None:
            return None
        dtype = _BIAS_TORCH[record.bias_dtype]
        if dtype is None:
            raise ValueError(f"bias dtype {record.bias_dtype} needs a torch with uint32")
        raw = self._view(record.bias_offset, record.bias_len)
        return raw.clone().view(dtype)  # a copy: the bias need not lie on its element size

    def dequantize(self, name: str, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
        """[out_dim, in_dim] weights of a record, decoded on `device` (the
        CPU by default) and cast to `dtype`."""
        from .quant import dequantize

        record = self.tensor(name)
        if record is None:
            raise KeyError(name)
        raw = self.payload(record)
        if record.q_dtype in BLOCK_SIZES:
            out = dequantize(record.q_dtype, raw, record.out_dim, record.in_dim, device)
        elif record.q_dtype in FLOAT_DTYPES:
            # a copy on the device (the view need not lie on the element size)
            raw = raw.clone() if device is None else raw.to(device)
            out = raw.view(FLOAT_DTYPES[record.q_dtype]).reshape(record.out_dim, record.in_dim)
        else:
            raise ValueError(record.q_dtype)
        return out.to(dtype)


class DsqWriter:
    """A reference-compatible container: entries kept in memory, the file
    written by ``finalize`` (the reference's writer, buffered the same
    way)."""

    def __init__(self, model_id: str, default_qdtype: str = "Q8_0", backend: str = "dsocr_tpu",
                 candle_version: str = "0.0.0"):
        if default_qdtype not in BLOCK_SIZES:
            raise ValueError(f"default_qdtype must be quantized, got {default_qdtype}")
        self.model_id = model_id
        self.backend = backend
        self.candle_version = candle_version
        self.default_qdtype = default_qdtype
        self._entries: List[dict] = []

    def add_quantized_tensor(self, name: str, out_dim: int, in_dim: int, q_dtype: str, payload,
                             bias: Optional[torch.Tensor] = None) -> None:
        """`payload`: bytes or a tensor (its bytes); `bias`: a tensor of one
        of the reference writer's bias dtypes (f32, f16, i64, u8, u32, f64)."""
        entry = {"name": name, "out_dim": out_dim, "in_dim": in_dim, "q_dtype": q_dtype,
                 "payload": to_bytes(payload) if isinstance(payload, torch.Tensor) else bytes(payload)}
        if bias is not None:
            code = _WRITER_BIAS.get(bias.dtype)
            if code is None:
                raise ValueError(f"unsupported bias dtype {bias.dtype}")
            entry["bias"] = to_bytes(bias)
            entry["bias_dtype"] = code
        self._entries.append(entry)

    def add_float_tensor(self, name: str, weights: torch.Tensor, dtype: str = "F32",
                         bias: Optional[torch.Tensor] = None) -> None:
        if dtype not in FLOAT_DTYPES:
            raise ValueError(dtype)
        out_dim, in_dim = weights.shape
        # through f32, as the reference casts its f32 weights
        payload = weights.float().to(FLOAT_DTYPES[dtype])
        self.add_quantized_tensor(name, out_dim, in_dim, dtype, payload, bias)

    def quantize_and_add(self, name: str, weights: torch.Tensor, q_dtype: Optional[str] = None,
                         bias: Optional[torch.Tensor] = None) -> None:
        """Quantize [out, in] weights where they lie (the card, for the
        exporter) and add them."""
        from .quant import quantize

        q_dtype = q_dtype or self.default_qdtype
        out_dim, in_dim = weights.shape
        payload = quantize(q_dtype, weights.float(), out_dim, in_dim)
        self.add_quantized_tensor(name, out_dim, in_dim, q_dtype, payload, bias)

    def finalize(self, path) -> None:
        header = bytearray(MAGIC)
        header += struct.pack("<I", VERSION)
        header += _pack_string(self.candle_version)
        header += _pack_string(self.model_id)
        header += _pack_string(self.backend)
        header += struct.pack("<III", TENSOR_DTYPE_CODES[self.default_qdtype],
                              BLOCK_SIZES[self.default_qdtype], len(self._entries))
        records_len = sum(4 + len(e["name"].encode("utf-8")) + 48 for e in self._entries)
        offset = len(header) + records_len
        records = bytearray()
        for e in self._entries:
            q_offset = offset
            offset += len(e["payload"])
            bias_offset = bias_len = bias_code = 0
            if "bias" in e:
                bias_offset, bias_len = offset, len(e["bias"])
                bias_code = BIAS_DTYPE_CODES[e["bias_dtype"]]
                offset += bias_len
            records += _pack_string(e["name"])
            records += struct.pack("<III", e["out_dim"], e["in_dim"], TENSOR_DTYPE_CODES[e["q_dtype"]])
            records += struct.pack("<QQQQ", q_offset, len(e["payload"]), bias_offset, bias_len)
            records += struct.pack("<I", bias_code)
        with open(path, "wb") as fh:
            fh.write(header)
            fh.write(records)
            for e in self._entries:
                fh.write(e["payload"])
                if "bias" in e:
                    fh.write(e["bias"])
