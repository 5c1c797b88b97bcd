"""Model loading dispatch: ModelKind + paths → engine
(dsocr_tpu/models/registry.py).

``load_engine(kind, config_path=..., weights_path=..., snapshot_path=...)``
builds a DeepSeek-OCR engine (v1 or OCR2, as its config.json says), a
PaddleOCR-VL, a DotsOCR or a GLM-OCR engine on ``device`` (the CUDA card
unless the caller names the CPU): weights from a safetensors checkpoint,
a ``.dsq`` snapshot overriding the linears it holds, or seeded random
weights without a checkpoint. A quantized snapshot serves packed in its
own format unless ``quantize`` names another (``_snapshot_quant_method``:
the header's default dtype); GLM-OCR serves float only and takes no
``quantize``, as the reference's branch passes none.

``mesh="dp=N,mp=M[,ep]"`` (parse_mesh_spec) serves DeepSeek-OCR (v1 or
OCR2) over dp × mp rank processes: this process is rank 0 and spawns the
followers, each of which loads the same files itself (``state_fn``).
PaddleOCR-VL, DotsOCR and GLM-OCR under a mesh raise: their dp meshes
wait for ROADMAP Queue 1 #6.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Optional

import torch

from ..core.engine import ModelKind
from ..parallel.mesh import parse_mesh_spec

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "f32": torch.float32,
    "float16": torch.float16,
    "f16": torch.float16,
}


def resolve_dtype(name: Optional[str]) -> torch.dtype:
    if name is None:
        return torch.bfloat16
    dtype = _DTYPES.get(name.lower())
    if dtype is None:
        raise ValueError(f"unsupported dtype {name!r}")
    return dtype


def _snapshot_quant_method(snapshot_path) -> Optional[str]:
    """A snapshot's default dtype → the packed format it serves in."""
    if not snapshot_path:
        return None
    from ..dsq.format import DsqReader

    reader = DsqReader(pathlib.Path(snapshot_path))
    try:
        return {"Q8_0": "q8_0", "Q4_K": "q4_k", "Q6_K": "q6_k"}.get(reader.header.default_qdtype)
    finally:
        reader.close()


def check_mesh(kind: ModelKind, mesh, ep: bool = False):
    """The Mesh that `mesh` (a spec, a Mesh or None) and `ep` ask for;
    raises for a family that cannot serve under one."""
    mesh = parse_mesh_spec(mesh)
    if ep:
        if mesh is None:
            raise ValueError("ep (expert parallelism) needs a mesh")
        mesh = parse_mesh_spec(f"dp={mesh.dp},mp={mesh.mp},ep")
    if mesh is not None and kind is not ModelKind.DEEPSEEK:
        raise NotImplementedError(
            f"{kind.value} under a mesh waits for ROADMAP Queue 1 #6 (its dp mesh: slot-cache "
            "shardings and quant_partition's row-sharded packed matmuls); DeepSeek-OCR serves under one")
    return mesh


def load_engine(
    kind: ModelKind,
    config_path=None,
    weights_path=None,
    snapshot_path=None,
    dtype: Optional[str] = None,
    max_seq_len: int = 8192,
    mesh=None,
    quantize: Optional[str] = None,
    ep: bool = False,
    kv_quant: Optional[str] = None,
    device=None,
):
    tdtype = resolve_dtype(dtype)
    mesh = check_mesh(kind, mesh, ep)
    from ..core.device import select_device

    device = select_device(device)
    if kind is ModelKind.GLM_OCR:
        from .glm import GlmConfig, GlmOcrEngine
        from .glm.loader import load_glm_params

        cfg = GlmConfig.from_json(config_path) if config_path else GlmConfig()
        state = None
        if weights_path:
            state = load_glm_params(weights_path, cfg, dtype=tdtype, snapshot_path=snapshot_path, device=device)
        return GlmOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len, kv_quant=kv_quant,
                            state=state)
    quantize = quantize or _snapshot_quant_method(snapshot_path)
    if kind is ModelKind.DOTS_OCR:
        from .dots import DotsConfig, DotsOcrEngine
        from .dots.loader import load_dots_params

        cfg = DotsConfig.from_json(config_path) if config_path else DotsConfig()
        state = None
        if weights_path:
            state = load_dots_params(weights_path, cfg, dtype=tdtype, snapshot_path=snapshot_path, device=device)
        return DotsOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len, kv_quant=kv_quant,
                             state=state, quantize=quantize)
    if kind is ModelKind.PADDLE_OCR_VL:
        from .paddleocr import PaddleConfig, PaddleOcrEngine
        from .paddleocr.loader import load_paddle_params

        cfg = PaddleConfig.from_json(config_path) if config_path else PaddleConfig()
        state = None
        if weights_path:
            state = load_paddle_params(weights_path, cfg, dtype=tdtype, snapshot_path=snapshot_path,
                                       device=device)
        return PaddleOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len,
                               kv_quant=kv_quant, state=state, quantize=quantize)
    from .deepseek import DeepseekOcrConfig, DeepseekOcrEngine
    from .deepseek.loader import load_deepseek_params

    cfg = DeepseekOcrConfig.from_json(config_path) if config_path else DeepseekOcrConfig()
    state = state_fn = None
    if weights_path and mesh is not None:  # every rank reads the files itself
        state_fn = functools.partial(_deepseek_state, weights_path, cfg, tdtype, snapshot_path)
    elif weights_path:
        state = load_deepseek_params(weights_path, cfg, dtype=tdtype, snapshot_path=snapshot_path,
                                     device=device)
    return DeepseekOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len,
                             kv_quant=kv_quant, state=state, quantize=quantize, mesh=mesh,
                             state_fn=state_fn)


def _deepseek_state(weights_path, cfg, dtype, snapshot_path, device):
    from .deepseek.loader import load_deepseek_params

    return load_deepseek_params(weights_path, cfg, dtype=dtype, snapshot_path=snapshot_path, device=device)
