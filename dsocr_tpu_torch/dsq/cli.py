"""dsq CLI: info / stats / export (dsocr_tpu/dsq/cli.py, the reference's
dsq-cli).

    python -m dsocr_tpu_torch.dsq info snapshot.dsq
    python -m dsocr_tpu_torch.dsq stats snapshot.dsq
    python -m dsocr_tpu_torch.dsq export --weights model.safetensors \\
        --config config.json --dtype q6k --targets text --output out.dsq

``export`` reads the checkpoint without the safetensors package and
quantizes each linear on the CUDA card (``--device cpu`` runs it on the
host); a linear whose in dim misses the format's block is written as F16.
The flags and printed lines are the reference's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
from collections import Counter

import torch

from .adapters import AdapterScope, infer_adapter
from .format import BLOCK_SIZES, DsqReader, DsqWriter

_DTYPE_ALIASES = {
    "q8_0": "Q8_0", "q8": "Q8_0", "q8k": "Q8_0",
    "q4k": "Q4_K", "q4_k": "Q4_K",
    "q6k": "Q6_K", "q6_k": "Q6_K",
}


def cmd_info(args) -> int:
    reader = DsqReader(args.snapshot)
    h = reader.header
    print(f"path:            {reader.path}")
    print(f"version:         {h.version}")
    print(f"model_id:        {h.model_id}")
    print(f"backend:         {h.backend}")
    print(f"candle_version:  {h.candle_version}")
    print(f"default_qdtype:  {h.default_qdtype} (block {h.block_size})")
    print(f"tensor_count:    {h.tensor_count}")
    reader.close()
    return 0


def cmd_stats(args) -> int:
    reader = DsqReader(args.snapshot)
    counts = Counter(r.q_dtype for r in reader.records)
    payload = sum(r.q_len for r in reader.records)
    params = sum(r.out_dim * r.in_dim for r in reader.records)
    print(f"tensors: {len(reader.records)}  params: {params:,}  payload: {payload:,} B")
    for dtype, count in sorted(counts.items()):
        bytes_for = sum(r.q_len for r in reader.records if r.q_dtype == dtype)
        print(f"  {dtype:5s} x{count:5d}  {bytes_for:,} B")
    if args.verbose:
        for r in reader.records:
            print(f"  {r.name}  [{r.out_dim}x{r.in_dim}] {r.q_dtype} {r.q_len:,} B")
    reader.close()
    return 0


def cmd_export(args) -> int:
    from ..core.device import select_device
    from ..utils.safetensors_io import CheckpointReader

    config = json.loads(pathlib.Path(args.config).read_text())
    adapter = infer_adapter(config)
    if adapter is None:
        print("error: no adapter supports this config", file=sys.stderr)
        return 1
    device = select_device(args.device)
    scope = AdapterScope.TEXT_AND_PROJECTOR if args.targets in ("text+projector", "all") else AdapterScope.TEXT
    specs = adapter.discover(config, scope)
    dtype = _DTYPE_ALIASES.get(args.dtype.lower(), args.dtype.upper())

    reader = CheckpointReader(pathlib.Path(args.weights))
    model_id = args.model_id
    if model_id is None:
        model_id = hashlib.sha256(pathlib.Path(args.weights).name.encode()).hexdigest()[:16]

    writer = DsqWriter(model_id=model_id, default_qdtype=dtype)
    written = skipped = fallback = 0
    for spec in specs:
        weight_name = f"{spec.name}.weight"
        if weight_name not in reader:
            skipped += 1
            continue
        w = reader.get(weight_name).to(device).float()
        bias = reader.get_optional(f"{spec.name}.bias", torch.float32)
        if w.shape[1] % BLOCK_SIZES[dtype]:
            writer.add_float_tensor(spec.name, w, "F16", bias=bias)
            fallback += 1
        else:
            writer.quantize_and_add(spec.name, w, dtype, bias=bias)
        written += 1
    writer.finalize(pathlib.Path(args.output))
    print(f"exported {written} tensors ({fallback} float fallback, {skipped} missing) -> {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dsq", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_info = sub.add_parser("info", help="print snapshot header")
    p_info.add_argument("snapshot")
    p_info.set_defaults(fn=cmd_info)

    p_stats = sub.add_parser("stats", help="per-dtype payload stats")
    p_stats.add_argument("snapshot")
    p_stats.add_argument("--verbose", action="store_true")
    p_stats.set_defaults(fn=cmd_stats)

    p_export = sub.add_parser("export", help="quantize a safetensors checkpoint")
    p_export.add_argument("--weights", required=True)
    p_export.add_argument("--config", required=True)
    p_export.add_argument("--dtype", default="q6k", help="q8_0 | q4k | q6k")
    p_export.add_argument("--targets", default="text", help="text | text+projector")
    p_export.add_argument("--output", required=True)
    p_export.add_argument("--model-id", default=None)
    p_export.add_argument("--device", default=None, help="where to quantize: the CUDA card (default) | cpu")
    p_export.set_defaults(fn=cmd_export)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
