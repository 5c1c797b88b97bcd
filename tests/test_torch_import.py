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
    "dsocr_tpu_torch.core.conversation",
    "dsocr_tpu_torch.core.device",
    "dsocr_tpu_torch.core.engine",
    "dsocr_tpu_torch.core.memlog",
    "dsocr_tpu_torch.core.params",
    "dsocr_tpu_torch.core.runtime_device",
    "dsocr_tpu_torch.core.sampling",
    "dsocr_tpu_torch.core.streaming",
    "dsocr_tpu_torch.core.text",
    "dsocr_tpu_torch.config",
    "dsocr_tpu_torch.config.app",
    "dsocr_tpu_torch.config.args",
    "dsocr_tpu_torch.config.fs",
    "dsocr_tpu_torch.config.resolver",
    "dsocr_tpu_torch.cli",
    "dsocr_tpu_torch.cli.app",
    "dsocr_tpu_torch.ops",
    "dsocr_tpu_torch.ops.norms",
    "dsocr_tpu_torch.ops.activations",
    "dsocr_tpu_torch.ops.rope",
    "dsocr_tpu_torch.ops.attention",
    "dsocr_tpu_torch.ops.linear",
    "dsocr_tpu_torch.ops.moe",
    "dsocr_tpu_torch.ops.resize",
    "dsocr_tpu_torch.ops.packed_attention",
    "dsocr_tpu_torch.ops.kernels",
    "dsocr_tpu_torch.ops.kernels.sam_attention",
    "dsocr_tpu_torch.ops.kernels.prefill_attention",
    "dsocr_tpu_torch.ops.kernels.slot_attention",
    "dsocr_tpu_torch.ops.kernels.dequant_matmul",
    "dsocr_tpu_torch.ops.kernels.kquant_matmul",
    "dsocr_tpu_torch.ops.kernels.paged_attention",
    "dsocr_tpu_torch.ops.kernels.gather_matmul",
    "dsocr_tpu_torch.ops.kernels.row_matmul",
    "dsocr_tpu_torch.ops.kernels._lib",
    "dsocr_tpu_torch.dsq",
    "dsocr_tpu_torch.dsq.quant",
    "dsocr_tpu_torch.dsq.serve_quant",
    "dsocr_tpu_torch.dsq.format",
    "dsocr_tpu_torch.dsq.runtime",
    "dsocr_tpu_torch.dsq.adapters",
    "dsocr_tpu_torch.dsq.cli",
    "dsocr_tpu_torch.image",
    "dsocr_tpu_torch.image.decode",
    "dsocr_tpu_torch.image.tiff",
    "dsocr_tpu_torch.image.bmp",
    "dsocr_tpu_torch.image.gif",
    "dsocr_tpu_torch.image.webp",
    "dsocr_tpu_torch.image.ops",
    "dsocr_tpu_torch.image.pnm",
    "dsocr_tpu_torch.image.resample",
    "dsocr_tpu_torch.image.tiling",
    "dsocr_tpu_torch.image.smart_resize",
    "dsocr_tpu_torch.native",
    "dsocr_tpu_torch.native.resample",
    "dsocr_tpu_torch.models",
    "dsocr_tpu_torch.models.registry",
    "dsocr_tpu_torch.models.gqa_decoder",
    "dsocr_tpu_torch.models.gqa_mesh",
    "dsocr_tpu_torch.models.gqa_quantize",
    "dsocr_tpu_torch.models.deepseek",
    "dsocr_tpu_torch.models.deepseek.config",
    "dsocr_tpu_torch.models.deepseek.sam",
    "dsocr_tpu_torch.models.deepseek.clip",
    "dsocr_tpu_torch.models.deepseek.fusion",
    "dsocr_tpu_torch.models.deepseek.decoder",
    "dsocr_tpu_torch.models.deepseek.engine",
    "dsocr_tpu_torch.models.deepseek.convert",
    "dsocr_tpu_torch.models.deepseek.quantize",
    "dsocr_tpu_torch.models.deepseek.loader",
    "dsocr_tpu_torch.models.deepseek.ocr2",
    "dsocr_tpu_torch.models.deepseek.mesh",
    "dsocr_tpu_torch.models.paddleocr",
    "dsocr_tpu_torch.models.paddleocr.config",
    "dsocr_tpu_torch.models.paddleocr.vision",
    "dsocr_tpu_torch.models.paddleocr.projector",
    "dsocr_tpu_torch.models.paddleocr.decoder",
    "dsocr_tpu_torch.models.paddleocr.quantize",
    "dsocr_tpu_torch.models.paddleocr.engine",
    "dsocr_tpu_torch.models.paddleocr.loader",
    "dsocr_tpu_torch.models.paddleocr.convert",
    "dsocr_tpu_torch.models.dots",
    "dsocr_tpu_torch.models.dots.config",
    "dsocr_tpu_torch.models.dots.vision",
    "dsocr_tpu_torch.models.dots.decoder",
    "dsocr_tpu_torch.models.dots.quantize",
    "dsocr_tpu_torch.models.dots.engine",
    "dsocr_tpu_torch.models.dots.loader",
    "dsocr_tpu_torch.models.dots.convert",
    "dsocr_tpu_torch.models.glm",
    "dsocr_tpu_torch.models.glm.config",
    "dsocr_tpu_torch.models.glm.vision",
    "dsocr_tpu_torch.models.glm.decoder",
    "dsocr_tpu_torch.models.glm.engine",
    "dsocr_tpu_torch.models.glm.loader",
    "dsocr_tpu_torch.models.glm.convert",
    "dsocr_tpu_torch.parallel",
    "dsocr_tpu_torch.parallel.mesh",
    "dsocr_tpu_torch.parallel.comm",
    "dsocr_tpu_torch.parallel.launch",
    "dsocr_tpu_torch.parallel.runtime",
    "dsocr_tpu_torch.runtime",
    "dsocr_tpu_torch.runtime.kv_cache",
    "dsocr_tpu_torch.runtime.generate",
    "dsocr_tpu_torch.runtime.slots",
    "dsocr_tpu_torch.runtime.paged",
    "dsocr_tpu_torch.server",
    "dsocr_tpu_torch.server.app",
    "dsocr_tpu_torch.server.http",
    "dsocr_tpu_torch.server.messages",
    "dsocr_tpu_torch.server.prefix_cache",
    "dsocr_tpu_torch.server.routes",
    "dsocr_tpu_torch.server.scheduler",
    "dsocr_tpu_torch.server.state",
    "dsocr_tpu_torch.server.stream",
    "dsocr_tpu_torch.utils",
    "dsocr_tpu_torch.utils.logging",
    "dsocr_tpu_torch.utils.onig_regex",
    "dsocr_tpu_torch.utils.safetensors_io",
    "dsocr_tpu_torch.utils.tokenizer",
]
FORBIDDEN = ["jax", "PIL", "safetensors", "ml_dtypes", "tokenizers", "aiohttp", "requests", "triton", "zstandard"]


def test_port_imports_no_jax_nor_heavy_deps():
    """Every module imports with jax, the reference and every package the
    card's machine lacks made unimportable, and pulls none of them in."""
    code = (
        "import importlib, json, sys\n"
        f"for name in {FORBIDDEN + ['dsocr_tpu']!r}: sys.modules[name] = None\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m, mod in sys.modules.items() if mod is not None and "
        f"m.split('.')[0] in {FORBIDDEN + ['dsocr_tpu']!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_mesh_ranks_import_no_jax_nor_heavy_deps(tmp_path):
    """A two-rank mesh serves a tiny engine with jax, the reference and
    every package the card's machine lacks made unimportable in rank 0
    and in the spawned follower (which starts from rank 0's sys.path,
    here led by stand-ins that raise when imported), and answers as the
    single-process engine."""
    poison = tmp_path / "poison"
    for name in FORBIDDEN + ["dsocr_tpu"]:
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(f"raise ImportError('{name} imported by a mesh rank')\n")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(poison)!r})\n"
        "import numpy as np, torch\n"
        "from dsocr_tpu_torch.core import DecodeParameters, VisionSettings\n"
        "from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config\n"
        "class Tok:\n"
        "    def encode(self, t): return [ord(c) % 100 for c in t]\n"
        "    def decode(self, ids, skip_special_tokens=True): return ' '.join(map(str, ids))\n"
        "    def token_to_id(self, t): return 127 if t == '<image>' else None\n"
        "if __name__ == '__main__':\n"
        "    img = np.random.default_rng(0).integers(0, 256, (60, 60, 3), dtype=np.uint8)\n"
        "    args = (Tok(), '<image>x', [img], VisionSettings(64, 64, False),\n"
        "            DecodeParameters(max_new_tokens=4, no_repeat_ngram_size=None))\n"
        "    kw = dict(dtype=torch.float32, device='cpu', max_seq_len=512, seed=3)\n"
        "    one = DeepseekOcrEngine(tiny_deepseek_config(), **kw).decode(*args)\n"
        "    mesh = DeepseekOcrEngine(tiny_deepseek_config(), mesh='dp=1,mp=2', **kw)\n"
        "    got = mesh.decode(*args)\n"
        "    mesh.close()\n"
        "    assert got.generated_tokens == one.generated_tokens, (got, one)\n"
        f"    print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ['dsocr_tpu']!r}))\n"
    )
    script = tmp_path / "mesh_ranks.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _port_files():
    root = pathlib.Path(REPO) / "dsocr_tpu_torch"
    return sorted(p for p in root.rglob("*.py") if "_build" not in p.relative_to(root).parts)


def test_import_check_lists_every_port_module():
    """SLICE_MODULES names every module of the port (``__main__`` runs its
    command when imported: its imports are the static check's)."""
    modules = set()
    for path in _port_files():
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        if parts[-1] != "__main__":
            modules.add(".".join(parts))
    assert modules - set(SLICE_MODULES) == set()


@pytest.mark.parametrize("module", ["dsocr_tpu_torch.server", "dsocr_tpu_torch.cli"])
def test_front_ends_run_with_the_missing_packages_blocked(module):
    """`python -m dsocr_tpu_torch.server --help` and `... .cli --help` with
    jax, the reference and every package the card's machine lacks made
    unimportable."""
    code = (
        "import runpy, sys\n"
        f"for name in {FORBIDDEN + ['dsocr_tpu']!r}: sys.modules[name] = None\n"
        f"sys.argv = [{module!r}, '--help']\n"
        f"runpy.run_module({module!r}, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--config" in out.stdout


def test_chip_smoke_tokenizer_loads_in_the_library_and_reads_alike(tmp_path):
    """chip_smoke.synthetic_tokenizer (its full-vocabulary DeepSeek-shaped
    tokenizer.json, here at 3000 ids) loads in the tokenizers library, and
    the port's reader gives the library's ids, text and token ids."""
    tokenizers = pytest.importorskip("tokenizers")
    import numpy as np

    sys.path.insert(0, REPO)
    import chip_smoke
    from dsocr_tpu_torch.utils.tokenizer import load_tokenizer

    specials = {0: "<｜begin▁of▁sentence｜>", 2001: "<｜end▁of▁sentence｜>", 2999: "<image>"}
    path = chip_smoke.synthetic_tokenizer(tmp_path / "tokenizer.json", 3000, specials)
    ref, mine = tokenizers.Tokenizer.from_file(str(path)), load_tokenizer(path)
    assert ref.get_vocab_size() == mine.vocab_size == 3000
    for token_id, content in specials.items():
        assert ref.token_to_id(content) == mine.token_to_id(content) == token_id
    for text in ["<image>\nFree OCR.", "Invoice 12345: 东京 café ۳", "  spaces\r\n\ttabs", "😀<image>x"]:
        assert mine.encode(text) == ref.encode(text, add_special_tokens=False).ids
    ids = np.random.default_rng(0).integers(0, 3000, 200).tolist() + list(specials)
    for n in range(0, len(ids) + 1, 9):
        for skip in (True, False):
            assert mine.decode(ids[:n], skip) == ref.decode(ids[:n], skip_special_tokens=skip)


def test_dsq_module_runs_with_the_missing_packages_blocked():
    """`python -m dsocr_tpu_torch.dsq --help` with jax, the reference and
    every package the card's machine lacks made unimportable."""
    code = (
        "import runpy, sys\n"
        f"for name in {FORBIDDEN + ['dsocr_tpu']!r}: sys.modules[name] = None\n"
        "sys.argv = ['dsq', '--help']\n"
        "runpy.run_module('dsocr_tpu_torch.dsq', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "export" in out.stdout and "info" in out.stdout


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
    files = [root] if root.is_file() else _port_files()
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


def test_segment_attention_refuses_other_devices():
    """The towers' frame attention runs the plain twin on CPU tensors and
    the fused SDPA backends on CUDA ones; any other device raises."""
    from dsocr_tpu_torch.ops.packed_attention import segment_attention

    with pytest.raises(ValueError, match="cpu or cuda"):
        segment_attention(_meta(8, 2, 16), _meta(8, 2, 16), _meta(8, 2, 16), [0] * 4 + [1] * 4)


@pytest.mark.parametrize("kind", ["DOTS_OCR", "GLM_OCR"])
def test_new_families_load_on_the_card_unless_told(kind, monkeypatch):
    """load_engine of DotsOCR and GLM-OCR without a device means the card
    (raising without one), and builds on the CPU only when named; the
    loaders' default device is the card too."""
    from dsocr_tpu_torch.core.engine import ModelKind
    from dsocr_tpu_torch.models import registry
    from dsocr_tpu_torch.models.dots import loader as dots_loader
    from dsocr_tpu_torch.models.glm import loader as glm_loader

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        registry.load_engine(getattr(ModelKind, kind))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        (dots_loader.load_dots_params if kind == "DOTS_OCR" else glm_loader.load_glm_params)(
            "missing.safetensors", None)
    built = {}

    class Double:
        def __init__(self, cfg, **kw):
            built.update(kw)

    family = "dots" if kind == "DOTS_OCR" else "glm"
    module = __import__(f"dsocr_tpu_torch.models.{family}", fromlist=["x"])
    monkeypatch.setattr(module, "DotsOcrEngine" if family == "dots" else "GlmOcrEngine", Double)
    registry.load_engine(getattr(ModelKind, kind), device="cpu")
    assert built["device"].type == "cpu" and built["state"] is None
