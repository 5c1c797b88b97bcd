"""The PyTorch port imports without jax or the reference's heavy deps, and
picks its device explicitly."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "dsocr_tpu_torch",
    "dsocr_tpu_torch.core",
    "dsocr_tpu_torch.core.benchmark",
    "dsocr_tpu_torch.core.device",
    "dsocr_tpu_torch.core.params",
    "dsocr_tpu_torch.core.sampling",
    "dsocr_tpu_torch.core.streaming",
    "dsocr_tpu_torch.ops",
    "dsocr_tpu_torch.ops.norms",
    "dsocr_tpu_torch.ops.activations",
    "dsocr_tpu_torch.ops.rope",
    "dsocr_tpu_torch.ops.attention",
    "dsocr_tpu_torch.ops.linear",
    "dsocr_tpu_torch.ops.moe",
    "dsocr_tpu_torch.ops.resize",
    "dsocr_tpu_torch.ops.kernels",
    "dsocr_tpu_torch.ops.kernels.sam_attention",
    "dsocr_tpu_torch.ops.kernels.prefill_attention",
    "dsocr_tpu_torch.ops.kernels.slot_attention",
    "dsocr_tpu_torch.ops.kernels.dequant_matmul",
    "dsocr_tpu_torch.ops.kernels.kquant_matmul",
    "dsocr_tpu_torch.ops.kernels.paged_attention",
    "dsocr_tpu_torch.ops.kernels.gather_matmul",
    "dsocr_tpu_torch.ops.kernels.row_matmul",
    "dsocr_tpu_torch.dsq",
    "dsocr_tpu_torch.dsq.quant",
    "dsocr_tpu_torch.dsq.serve_quant",
    "dsocr_tpu_torch.image",
    "dsocr_tpu_torch.image.resample",
    "dsocr_tpu_torch.native",
    "dsocr_tpu_torch.native.resample",
    "dsocr_tpu_torch.models.deepseek",
    "dsocr_tpu_torch.models.deepseek.config",
    "dsocr_tpu_torch.models.deepseek.sam",
    "dsocr_tpu_torch.models.deepseek.clip",
    "dsocr_tpu_torch.models.deepseek.fusion",
    "dsocr_tpu_torch.models.deepseek.decoder",
    "dsocr_tpu_torch.models.deepseek.engine",
    "dsocr_tpu_torch.models.deepseek.convert",
    "dsocr_tpu_torch.models.deepseek.quantize",
    "dsocr_tpu_torch.runtime.kv_cache",
    "dsocr_tpu_torch.runtime.generate",
    "dsocr_tpu_torch.runtime.slots",
    "dsocr_tpu_torch.runtime.paged",
    "dsocr_tpu_torch.server.prefix_cache",
    "dsocr_tpu_torch.server.scheduler",
]
FORBIDDEN = ["jax", "PIL", "safetensors", "ml_dtypes", "tokenizers", "aiohttp", "triton"]


def test_port_imports_no_jax_nor_heavy_deps():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ['dsocr_tpu']!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: pathlib.Path):
    """Top-level names of every module the file imports (absolute imports;
    the port's relative imports stay inside it)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("where", ["chip_smoke.py", "dsocr_tpu_torch"])
def test_no_line_imports_jax_nor_heavy_deps(where):
    """Every import statement of chip_smoke.py and of every port module,
    whether it runs at import time or inside a function."""
    root = pathlib.Path(REPO) / where
    files = [root] if root.is_file() else sorted(
        p for p in root.rglob("*.py") if "_build" not in p.relative_to(root).parts)
    assert files
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN + ["dsocr_tpu"])
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_cuda_request_without_gpu_raises():
    from dsocr_tpu_torch.core.device import select_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        select_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):  # no name means the card
        select_device(None)
    assert select_device("cpu").type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError):
        select_device("tpu")


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


_MISPLACED_CALLS = {
    "flash_prefill_attention": lambda K: K.flash_prefill_attention(
        _meta(1, 2, 4, 8), _meta(1, 2, 4, 8), _meta(1, 2, 4, 8), _meta(1, dtype=torch.int32), scale=1.0),
    "q8_matmul": lambda K: K.q8_matmul(_meta(4, 32), _meta(64, 32, dtype=torch.int8), _meta(64, 1)),
    "q8_gather_matmul": lambda K: K.q8_gather_matmul(
        _meta(4, 32), _meta(3, 32, 64, dtype=torch.int8), _meta(3, 1, 64), _meta(4, dtype=torch.int32)),
    "q8_dense_experts": lambda K: K.q8_dense_experts(
        _meta(4, 32), _meta(3, 32, 64, dtype=torch.int8), _meta(3, 1, 64)),
    "q8_dense_experts_perx": lambda K: K.q8_dense_experts_perx(
        _meta(3, 4, 32), _meta(3, 32, 64, dtype=torch.int8), _meta(3, 1, 64)),
    "q4k_matmul": lambda K: K.q4k_matmul(
        _meta(4, 256), _meta(64, 128, dtype=torch.uint8), _meta(64, 8), _meta(64, 8)),
    "q4k_gather_matmul": lambda K: K.q4k_gather_matmul(
        _meta(4, 256), _meta(3, 128, 64, dtype=torch.uint8), _meta(3, 8, 64), _meta(3, 8, 64),
        _meta(4, dtype=torch.int32)),
    "q4k_dense_experts": lambda K: K.q4k_dense_experts(
        _meta(4, 256), _meta(3, 128, 64, dtype=torch.uint8), _meta(3, 8, 64), _meta(3, 8, 64)),
    "q4k_dense_experts_perx": lambda K: K.q4k_dense_experts_perx(
        _meta(3, 4, 256), _meta(3, 128, 64, dtype=torch.uint8), _meta(3, 8, 64), _meta(3, 8, 64)),
    "q6k_matmul": lambda K: K.q6k_matmul(
        _meta(4, 256), _meta(64, 128, dtype=torch.uint8), _meta(64, 64, dtype=torch.uint8), _meta(64, 16)),
    "q6k_gather_matmul": lambda K: K.q6k_gather_matmul(
        _meta(4, 256), _meta(3, 128, 64, dtype=torch.uint8), _meta(3, 64, 64, dtype=torch.uint8),
        _meta(3, 16, 64), _meta(4, dtype=torch.int32)),
    "q6k_dense_experts": lambda K: K.q6k_dense_experts(
        _meta(4, 256), _meta(3, 128, 64, dtype=torch.uint8), _meta(3, 64, 64, dtype=torch.uint8),
        _meta(3, 16, 64)),
    "q6k_dense_experts_perx": lambda K: K.q6k_dense_experts_perx(
        _meta(3, 4, 256), _meta(3, 128, 64, dtype=torch.uint8), _meta(3, 64, 64, dtype=torch.uint8),
        _meta(3, 16, 64)),
    "q8_moe_megafused": lambda K: K.q8_moe_megafused(
        _meta(4, 32), _meta(3, 4), _meta(3, 32, 64, dtype=torch.int8), _meta(3, 1, 64),
        _meta(3, 32, 32, dtype=torch.int8), _meta(3, 1, 32)),
    "paged_kv_update": lambda K: K.paged_kv_update(
        _meta(2, 5, 2, 8, 16), _meta(2, 5, 2, 8, 16), None, None, _meta(3, 2, 16), _meta(3, 2, 16),
        None, None, _meta(3, 2, dtype=torch.int32), _meta(3, dtype=torch.int32), 0),
    "paged_kv_write": lambda K: K.paged_kv_write(
        _meta(2, 5, 2, 8, 16), _meta(2, 5, 2, 8, 16), None, None, _meta(3, 2, 1, 16), _meta(3, 2, 1, 16),
        _meta(3, 2, dtype=torch.int32), _meta(3, dtype=torch.int32), 0),
    "slot_kv_write": lambda K: K.slot_kv_write(
        _meta(2, 3, 2, 8, 16, dtype=torch.int8), _meta(2, 3, 2, 8, 16, dtype=torch.int8), _meta(2, 3, 2, 8),
        _meta(2, 3, 2, 8), _meta(3, 2, 1, 16), _meta(3, 2, 1, 16), 0, _meta(3, dtype=torch.int32)),
    "gather_matmul": lambda K: K.gather_matmul(
        _meta(4, 32), _meta(3, 32, 48), _meta(4, dtype=torch.int32)),
    "paged_decode_attention": lambda K: K.paged_decode_attention(
        _meta(3, 4, 16), _meta(2, 5, 2, 8, 16), _meta(2, 5, 2, 8, 16), None, None,
        _meta(3, 2, dtype=torch.int32), _meta(3, dtype=torch.int32), 0, scale=0.25),
}


@pytest.mark.parametrize("wrapper", sorted(_MISPLACED_CALLS))
def test_wrappers_refuse_to_fall_back(wrapper):
    """A wrapper given a non-CPU, non-CUDA tensor raises instead of running
    its twin (a CUDA tensor launches the kernel; only CPU runs the twin)."""
    from dsocr_tpu_torch.ops import kernels as K

    before = K.launch_counts()
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        _MISPLACED_CALLS[wrapper](K)
    assert K.launch_counts() == before
