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

``mesh="dp=N,mp=M[,ep]"`` (parse_mesh_spec) serves every family over dp
× mp rank processes: this process is rank 0 and spawns the followers,
each of which loads the same files itself (``state_fn``). DeepSeek-OCR
(v1 or OCR2) shards its decoder (models/deepseek/mesh.py); PaddleOCR-VL,
DotsOCR and GLM-OCR replicate their params and split slot rows over dp
and KV heads over mp (models/gqa_mesh.py), and ignore ``ep`` as the
reference does, having no routed experts.
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
    """The Mesh that `mesh` (a spec, a Mesh or None) and `ep` ask for. A
    family without routed experts serves without ``ep`` (models/gqa_mesh.py
    says so once in the log); DeepSeek-OCR's ``ep`` needs a mesh."""
    mesh = parse_mesh_spec(mesh)
    if kind is not ModelKind.DEEPSEEK:
        from .gqa_mesh import dense_mesh

        if ep and mesh is not None:
            mesh = parse_mesh_spec(f"dp={mesh.dp},mp={mesh.mp},ep")
        return dense_mesh(mesh, kind.value)
    if ep:
        if mesh is None:
            raise ValueError("ep (expert parallelism) needs a mesh")
        mesh = parse_mesh_spec(f"dp={mesh.dp},mp={mesh.mp},ep")
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

    def weights(load, cfg):
        """(state, state_fn) of the checkpoint: under a mesh every rank
        reads the files itself."""
        if not weights_path:
            return None, None
        if mesh is not None:
            return None, functools.partial(_load_state, load, weights_path, cfg, tdtype, snapshot_path)
        return _load_state(load, weights_path, cfg, tdtype, snapshot_path, device), None

    if kind is ModelKind.GLM_OCR:
        from .glm import GlmConfig, GlmOcrEngine
        from .glm.loader import load_glm_params

        cfg = GlmConfig.from_json(config_path) if config_path else GlmConfig()
        state, state_fn = weights(load_glm_params, cfg)
        return GlmOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len, kv_quant=kv_quant,
                            state=state, mesh=mesh, state_fn=state_fn)
    quantize = quantize or _snapshot_quant_method(snapshot_path)
    if kind is ModelKind.DOTS_OCR:
        from .dots import DotsConfig, DotsOcrEngine
        from .dots.loader import load_dots_params

        cfg = DotsConfig.from_json(config_path) if config_path else DotsConfig()
        state, state_fn = weights(load_dots_params, cfg)
        return DotsOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len, kv_quant=kv_quant,
                             state=state, quantize=quantize, mesh=mesh, state_fn=state_fn)
    if kind is ModelKind.PADDLE_OCR_VL:
        from .paddleocr import PaddleConfig, PaddleOcrEngine
        from .paddleocr.loader import load_paddle_params

        cfg = PaddleConfig.from_json(config_path) if config_path else PaddleConfig()
        state, state_fn = weights(load_paddle_params, cfg)
        return PaddleOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len,
                               kv_quant=kv_quant, state=state, quantize=quantize, mesh=mesh, state_fn=state_fn)
    from .deepseek import DeepseekOcrConfig, DeepseekOcrEngine
    from .deepseek.loader import load_deepseek_params

    cfg = DeepseekOcrConfig.from_json(config_path) if config_path else DeepseekOcrConfig()
    state, state_fn = weights(load_deepseek_params, cfg)
    return DeepseekOcrEngine(cfg, dtype=tdtype, device=device, max_seq_len=max_seq_len,
                             kv_quant=kv_quant, state=state, quantize=quantize, mesh=mesh,
                             state_fn=state_fn)


def _load_state(load, weights_path, cfg, dtype, snapshot_path, device):
    return load(weights_path, cfg, dtype=dtype, snapshot_path=snapshot_path, device=device)
