"""The port's CLI (python -m dsocr_tpu_torch.cli) against the reference's
on the same tiny files: a checkpoint, config.json, tokenizer.json and a
PNG and a JPEG page in a cache directory; `weights snapshot`; the
image-slot check."""

import json
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
from PIL import Image  # noqa: E402

from dsocr_tpu.cli.app import main as ref_main  # noqa: E402
from dsocr_tpu.models.deepseek.config import DeepseekOcrConfig as JaxConfig  # noqa: E402
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny  # noqa: E402
from dsocr_tpu_torch.cli.app import main  # noqa: E402
from dsocr_tpu_torch.core.params import normalize_text  # noqa: E402
from dsocr_tpu_torch.models.deepseek import DeepseekOcrConfig, tiny_deepseek_config  # noqa: E402
from tests.test_loaders import _make_deepseek_checkpoint  # noqa: E402
from tests.test_torch_config import dsocr_logging  # noqa: E402,F401  (main's init_logging undone after each test)
from tests.test_torch_server import tiny_tokenizer_json  # noqa: E402

pytestmark = pytest.mark.usefixtures("dsocr_logging")

ARGS = ["--model", "deepseek-ocr", "--base-size", "64", "--image-size", "64", "--crop-mode", "false",
        "--dtype", "float32", "--no-repeat-ngram-size", "0", "--device", "cpu", "--quiet"]


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A cache directory with the tiny DeepSeek model's files and a page."""
    root = tmp_path_factory.mktemp("cache")
    mdir = root / "models" / "deepseek-ocr"
    mdir.mkdir(parents=True)
    _make_deepseek_checkpoint(mdir / "model.safetensors")
    (mdir / "config.json").write_text("{}")  # the tiny towers do not round-trip through config.json
    tiny_tokenizer_json(mdir / "tokenizer.json")
    page = np.random.default_rng(0).integers(0, 256, (60, 70, 3), dtype=np.uint8)
    Image.fromarray(page).save(root / "page.png")
    Image.fromarray(page).save(root / "page.jpg", quality=90)
    Image.fromarray(page).save(root / "page.webp", lossless=True)
    return root


def paddle_files(home):
    """The tiny PaddleOCR-VL model's files (seeded weights, config.json,
    the tiny tokenizer) under the cache directory's paddleocr-vl."""
    import torch

    import chip_smoke
    from dsocr_tpu_torch.models.paddleocr import PaddleOcrEngine, tiny_paddle_config

    mdir = home / "models" / "paddleocr-vl"
    if not (mdir / "tokenizer.json").exists():
        mdir.mkdir(parents=True, exist_ok=True)
        cfg = tiny_paddle_config()
        state = PaddleOcrEngine(cfg, dtype=torch.float32, device="cpu", seed=2).model.state_dict()
        chip_smoke.write_checkpoint(torch, state, cfg, str(mdir))
        tiny_tokenizer_json(mdir / "tokenizer.json")
    return mdir


@pytest.fixture()
def env(home, monkeypatch):
    monkeypatch.setenv("DEEPSEEK_OCR_CACHE_DIR", str(home))
    monkeypatch.setenv("DEEPSEEK_OCR_CONFIG_DIR", str(home / "cfg"))
    monkeypatch.delenv("DSOCR_KV_QUANT", raising=False)
    monkeypatch.setattr(JaxConfig, "from_json", classmethod(lambda cls, path: jax_tiny()))
    monkeypatch.setattr(DeepseekOcrConfig, "from_json", classmethod(lambda cls, path: tiny_deepseek_config()))
    return home


@pytest.mark.parametrize("prompt, new", [("<image>\nFree OCR.", 8), ("Read <image> now", 5)])
def test_output_json_equals_reference(env, tmp_path, capsys, prompt, new):
    argv = ARGS + ["--prompt", prompt, "--image", str(env / "page.png"), "--max-new-tokens", str(new)]
    assert ref_main(argv + ["--output-json", str(tmp_path / "ref.json")]) == 0
    assert main(argv + ["--output-json", str(tmp_path / "port.json")]) == 0
    ref, port = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("ref", "port"))
    assert port == ref
    assert 0 < port["response_tokens"] <= new and port["prompt_tokens"] > 0


def test_output_json_equals_reference_for_a_jpeg(env, tmp_path, capsys):
    argv = ARGS + ["--prompt", "<image>\nFree OCR.", "--image", str(env / "page.jpg"), "--max-new-tokens", "8"]
    assert ref_main(argv + ["--output-json", str(tmp_path / "ref.json")]) == 0
    assert main(argv + ["--output-json", str(tmp_path / "port.json")]) == 0
    ref, port = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("ref", "port"))
    assert port == ref and port["prompt_tokens"] > 0


def test_a_webp_page_answers_as_the_same_pixels_in_png(env, tmp_path, capsys):
    """A lossless WebP of the PNG page's pixels: the port's answer equals
    its answer for the PNG and the reference's (Pillow) for the WebP."""
    argv = ARGS + ["--prompt", "<image>\nFree OCR.", "--max-new-tokens", "8"]
    assert main(argv + ["--image", str(env / "page.webp"), "--output-json", str(tmp_path / "webp.json")]) == 0
    assert main(argv + ["--image", str(env / "page.png"), "--output-json", str(tmp_path / "png.json")]) == 0
    assert ref_main(argv + ["--image", str(env / "page.webp"), "--output-json", str(tmp_path / "ref.json")]) == 0
    webp, png, ref = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("webp", "png", "ref"))
    assert webp["text"] == png["text"] and webp == ref and webp["prompt_tokens"] > 0


@pytest.mark.parametrize("magic", ["P6", "P3"])
def test_a_pnm_page_answers_as_the_same_pixels_in_png(env, tmp_path, capsys, magic):
    """A PPM of the PNG page's pixels, raw and plain: the port's answer
    equals its answer for the PNG and the reference's (Pillow) for the PPM."""
    page = np.asarray(Image.open(env / "page.png").convert("RGB"))
    body = page.tobytes() if magic == "P6" else " ".join(map(str, page.ravel().tolist())).encode()
    ppm = tmp_path / "page.ppm"
    ppm.write_bytes(b"%s\n%d %d\n255\n" % (magic.encode(), page.shape[1], page.shape[0]) + body)
    argv = ARGS + ["--prompt", "<image>\nFree OCR.", "--max-new-tokens", "8"]
    assert main(argv + ["--image", str(ppm), "--output-json", str(tmp_path / "ppm.json")]) == 0
    assert main(argv + ["--image", str(env / "page.png"), "--output-json", str(tmp_path / "png.json")]) == 0
    assert ref_main(argv + ["--image", str(ppm), "--output-json", str(tmp_path / "ref.json")]) == 0
    got, png, ref = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("ppm", "png", "ref"))
    assert got["text"] == png["text"] and got == ref and got["prompt_tokens"] > 0


def test_streamed_stdout_and_bench_output(env, tmp_path, capsys):
    argv = ARGS + ["--prompt", "<image>\nFree OCR.", "--image", str(env / "page.png"), "--max-new-tokens", "6"]
    assert main(argv + ["--output-json", str(tmp_path / "o.json")]) == 0
    text = json.loads((tmp_path / "o.json").read_text())["text"]
    capsys.readouterr()
    bench = tmp_path / "bench.json"
    assert main(argv + ["--bench-output", str(bench)]) == 0
    out = capsys.readouterr().out
    assert normalize_text(out) == text  # the streamed deltas, before normalize_text
    totals = json.loads(bench.read_text())["stage_totals"]
    for stage in ("model.load", "prompt.render", "decode.prefill", "decode.generate"):
        assert stage in totals


def test_image_slot_mismatch(env, capsys):
    argv = ["--model", "deepseek-ocr", "--prompt", "<image> x <image>", "--image", str(env / "page.png"), "--quiet"]
    assert ref_main(argv) == 1
    ref_err = capsys.readouterr().err
    assert main(argv) == 1
    assert capsys.readouterr().err == ref_err
    assert "2 <image> slots but 1 images" in ref_err


def test_unknown_model_and_missing_prompt(env, capsys):
    assert main(["--model", "nope", "--prompt", "x", "--quiet"]) == 1
    assert "unknown model `nope`" in capsys.readouterr().err
    assert main(["--quiet"]) == 1
    assert "--prompt or --prompt-file required" in capsys.readouterr().err


def test_weights_snapshot_prints_the_port_export(env, capsys):
    assert main(["weights", "snapshot", "--model", "deepseek-ocr", "--dtype", "q4k"]) == 0
    out = capsys.readouterr().out.strip()
    assert ref_main(["weights", "snapshot", "--model", "deepseek-ocr", "--dtype", "q4k"]) == 0
    ref = capsys.readouterr().out.strip()
    assert out == ref.replace("python -m dsocr_tpu.dsq", "python -m dsocr_tpu_torch.dsq")
    assert out.startswith("python -m dsocr_tpu_torch.dsq export --weights ")
    assert str(env / "models" / "deepseek-ocr-q4k" / "snapshot.dsq") in out


def test_tpu_device_and_mesh_raise(env, tmp_path):
    config = tmp_path / "config.toml"
    config.write_text('[inference]\ndevice = "tpu"\n')
    argv = ["--config", str(config), "--prompt", "<image>", "--image", str(env / "page.png"), "--quiet"]
    with pytest.raises(ValueError, match=r"'tpu'; expected one of \['cuda', 'cpu'\]"):
        main(argv)
    # PaddleOCR-VL under --mesh (DeepSeek's: test_torch_mesh_launch.py): the
    # tiny checkpoint in the cache directory, answered as one process answers
    paddle_files(env)
    argv = ARGS[:1] + ["paddleocr-vl"] + ARGS[2:] + ["--prompt", "<image>", "--image", str(env / "page.png"),
                                                     "--max-new-tokens", "5"]
    assert main(argv + ["--output-json", str(tmp_path / "one.json")]) == 0
    assert main(argv + ["--mesh", "dp=1,mp=2", "--output-json", str(tmp_path / "mesh.json")]) == 0
    one, mesh = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("one", "mesh"))
    assert mesh == one and mesh["response_tokens"] > 0


def test_module_entry_points_help():
    for module in ("dsocr_tpu_torch.cli", "dsocr_tpu_torch.server"):
        out = subprocess.run([sys.executable, "-m", module, "--help"], capture_output=True, text=True, timeout=30)
        assert out.returncode == 0, out.stderr
        assert "--device" in out.stdout and "--model" in out.stdout
