"""The reference's last knobs in the port, against the reference package on
the same weights (params_from_jax of the reference engine, tiny config):

- ``DSOCR_NATIVE_CACHE``: where native/resample.py's ``build`` (the
  resampler and image/decode.py's decoders) and ops/kernels/_lib.py put
  their libraries, read at each build; the package's ``_build/`` without
  it; a failed build under it raises;
- ``DSOCR_VISION_F32``: SAM and CLIP load and compute in f32 while the
  projector and the decoder keep the model dtype (bf16 here), in the
  engine and in the loader; greedy tokens equal the reference's under the
  same knob, and the towers' projected tokens agree within atol = rtol =
  1e-4 (f32 on both sides, sums in another order);
- ``DSOCR_DEBUG_VISION_PATH``: ``decode``'s vision dump carries the
  reference's stage names and shapes, each stat within atol = rtol = 1e-4
  (f32 engines);
- ``DSOCR_DEBUG_LOGITS_STEP`` / ``DSOCR_DEBUG_LOGITS_PATH``: the port's
  dump, with the cache and without it, has the reference's (no-cache)
  step, top1_id, top2_id and chosen, and logits within 1e-4.

The mesh case (a follower's towers in f32 under the knob) is in
test_torch_mesh_launch.py, which starts its ranks under the knob.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.clip import clip_forward
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.fusion import build_clip_sam_tokens, project
from dsocr_tpu.models.deepseek.ocr2 import tiny_qwen2_encoder_params as jax_tiny_q
from dsocr_tpu.models.deepseek.sam import sam_forward
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.image import resample as T
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.models.deepseek.config import vision_compute_dtype
from dsocr_tpu_torch.models.deepseek.ocr2 import tiny_qwen2_encoder_params
from dsocr_tpu_torch import native
from dsocr_tpu_torch.native import resample as N
from dsocr_tpu_torch.ops.kernels import _lib

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = "<image>\nFree OCR."


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


def _image(seed=3, size=(60, 60)):
    return np.random.default_rng(seed).integers(0, 256, size=(*size, 3), dtype=np.uint8)


# -- DSOCR_NATIVE_CACHE -------------------------------------------------------------------------


def test_build_dir_is_read_at_each_build(tmp_path, monkeypatch):
    monkeypatch.delenv("DSOCR_NATIVE_CACHE", raising=False)
    assert native.build_dir() == native.BUILD_DIR == REPO / "dsocr_tpu_torch" / "_build"
    assert N.library_path().parent == _lib.library_path().parent == native.BUILD_DIR
    monkeypatch.setenv("DSOCR_NATIVE_CACHE", str(tmp_path / "cache"))
    assert native.build_dir() == tmp_path / "cache"
    assert N.library_path().parent == tmp_path / "cache"
    assert _lib.library_path().parent == tmp_path / "cache"
    assert _lib.library_path().name.startswith("libdsocr_kernels_")


_BUILD_UNDER_KNOB = """
import sys, numpy as np
sys.path.insert(0, {repo!r})
from dsocr_tpu_torch.native import resample as N
from dsocr_tpu_torch.image.decode import decode_image
img = np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)
out = N.resize_bicubic_native(img, 33, 41)
png = bytes.fromhex({png!r})
print(N.library_path(), int(out.astype(np.int64).sum()), decode_image(png).tobytes().hex())
"""


def test_native_cache_builds_the_resampler_and_decoders_there(tmp_path):
    """A process with DSOCR_NATIVE_CACHE set builds the resampler and the
    PNG decoder's library into it and nowhere else; the resampler's output
    equals the NumPy twin's."""
    import zlib

    rows = b"".join(b"\x00" + bytes([i * 40, 255 - i * 40, 7] * 3) for i in range(2))  # 3 × 2 RGB, filter 0
    ihdr = (3).to_bytes(4, "big") + (2).to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])

    def chunk(kind, body):
        return len(body).to_bytes(4, "big") + kind + body + zlib.crc32(kind + body).to_bytes(4, "big")

    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DSOCR_NATIVE_CACHE"] = str(cache)
    proc = subprocess.run([sys.executable, "-c", _BUILD_UNDER_KNOB.format(repo=str(REPO), png=png.hex())],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    path, total, pixels = proc.stdout.split()
    assert pathlib.Path(path).parent == cache and pathlib.Path(path).exists()
    want = T.resize_bicubic_numpy(np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8), 33, 41)
    assert int(total) == int(want.astype(np.int64).sum())
    assert bytes.fromhex(pixels) == bytes(np.frombuffer(rows, np.uint8).reshape(2, 10)[:, 1:].tobytes())
    stems = sorted(p.name.split("_")[1] for p in cache.iterdir() if p.suffix == ".so")
    assert stems == ["png", "resample"]


def test_failed_build_under_the_knob_raises(tmp_path, monkeypatch):
    bad = tmp_path / "resample.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("DSOCR_NATIVE_CACHE", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.build(bad)
    assert not [p for p in (tmp_path / "cache").iterdir() if p.suffix == ".so"]


# -- DSOCR_VISION_F32 ---------------------------------------------------------------------------


def test_vision_compute_dtype_follows_the_knob(monkeypatch):
    monkeypatch.delenv("DSOCR_VISION_F32", raising=False)
    assert vision_compute_dtype(torch.bfloat16) == torch.bfloat16
    monkeypatch.setenv("DSOCR_VISION_F32", "1")
    assert vision_compute_dtype(torch.bfloat16) == torch.float32


@pytest.fixture(scope="module")
def f32_tower_engines():
    """(reference, port) bf16 engines with f32 towers, on the same weights,
    and a port engine on those weights with bf16 towers."""
    os.environ["DSOCR_VISION_F32"] = "1"
    try:
        ref = JaxEngine(jax_tiny(), dtype=jnp.bfloat16, max_seq_len=512, seed=5)
        state = params_from_jax(jax.device_get(ref.params))
        port = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.bfloat16, device="cpu", max_seq_len=512,
                                 state=state)
    finally:
        os.environ.pop("DSOCR_VISION_F32")
    bf16 = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.bfloat16, device="cpu", max_seq_len=512,
                             state=state)
    return ref, port, bf16


def test_f32_towers_load_in_f32_and_the_rest_in_the_model_dtype(f32_tower_engines):
    ref, port, bf16 = f32_tower_engines
    assert ref.params["sam"]["patch_embed"]["w"].dtype == jnp.float32
    for name, p in port.model.named_parameters():
        part = name.split(".")[0]
        want = torch.float32 if part in ("sam", "clip") else torch.bfloat16
        assert p.dtype == want, name
    assert port.vision_dtype == torch.float32
    assert {p.dtype for p in bf16.model.sam.parameters()} == {torch.bfloat16}


def _reference_tower(ref, views):
    pixels = (jnp.asarray(views).astype(jnp.float32) / 255.0 - 0.5) / 0.5
    p = ref.params
    sam_out = sam_forward(p["sam"], ref.cfg.sam, pixels)
    clip_out = clip_forward(p["clip"], ref.cfg.clip, sam_out)
    return np.asarray(project(p["projector"], build_clip_sam_tokens(clip_out, sam_out)), np.float32)


def test_f32_towers_match_the_reference(f32_tower_engines):
    """The projected tokens of two global views; bf16 towers on the same
    weights land farther off than the tolerance."""
    ref, port, bf16 = f32_tower_engines
    views = np.stack([port.prepare_vision_input(_image(s), VisionSettings(64, 64, False)).global_pixels[0]
                      for s in (3, 4)])
    want = _reference_tower(ref, views)
    got = port._tower(views)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(bf16._tower(views).float().numpy(), want, **TOL)


@pytest.mark.parametrize("use_cache", [True, False])
def test_f32_towers_decode_tokens_match_the_reference(f32_tower_engines, use_cache):
    ref, port, _ = f32_tower_engines
    n = 8 if use_cache else 3
    want = ref.decode(_Tok(), PROMPT, [_image()], JaxVision(64, 64, False),
                      JaxParams(max_new_tokens=n, use_cache=use_cache))
    got = port.decode(_Tok(), PROMPT, [_image()], VisionSettings(64, 64, False),
                      DecodeParameters(max_new_tokens=n, use_cache=use_cache))
    assert got.generated_tokens == want.generated_tokens and len(got.generated_tokens) == n


def test_f32_towers_from_the_loader(tmp_path, monkeypatch):
    """load_deepseek_params reads SAM and CLIP in f32 under the knob (the
    checkpoint holds bf16 values), the rest in the model dtype."""
    import chip_smoke
    from dsocr_tpu_torch.models.deepseek.loader import load_deepseek_params

    cfg = tiny_deepseek_config()
    seeded = DeepseekOcrEngine(cfg, dtype=torch.bfloat16, device="cpu", max_seq_len=128, seed=2)
    index, _, _ = chip_smoke.write_checkpoint(torch, seeded.model.state_dict(), cfg, str(tmp_path), shards=1)
    monkeypatch.setenv("DSOCR_VISION_F32", "1")
    state = load_deepseek_params(index, cfg, dtype=torch.bfloat16, device="cpu")
    for key, t in state.items():
        assert t.dtype == (torch.float32 if key.split(".")[0] in ("sam", "clip") else torch.bfloat16), key
    want = seeded.model.state_dict()
    assert torch.equal(state["sam.blocks.0.qkv.w"], want["sam.blocks.0.qkv.w"].float())


# -- the debug dumps ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_engines():
    ref = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512, seed=6)
    port = DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu", max_seq_len=512,
                             state=params_from_jax(jax.device_get(ref.params)))
    return ref, port


def _assert_same_stages(got, want):
    assert [s["stage"] for s in got["stages"]] == [s["stage"] for s in want["stages"]]
    for g, w in zip(got["stages"], want["stages"]):
        assert set(g) == set(w) == {"stage", "shape", "mean", "std", "min", "max"}
        assert g["shape"] == w["shape"], g["stage"]
        np.testing.assert_allclose([g[k] for k in ("mean", "std", "min", "max")],
                                   [w[k] for k in ("mean", "std", "min", "max")], **TOL, err_msg=g["stage"])


def test_vision_dump_matches_the_reference(f32_engines, tmp_path, monkeypatch):
    ref, port = f32_engines
    monkeypatch.setenv("DSOCR_DEBUG_VISION_PATH", str(tmp_path / "ref.json"))
    ref.decode(_Tok(), PROMPT, [_image(41, (50, 50))], JaxVision(64, 64, False),
               JaxParams(max_new_tokens=2, no_repeat_ngram_size=None))
    monkeypatch.setenv("DSOCR_DEBUG_VISION_PATH", str(tmp_path / "port.json"))
    port.decode(_Tok(), PROMPT, [_image(41, (50, 50))], VisionSettings(64, 64, False),
                DecodeParameters(max_new_tokens=2, no_repeat_ngram_size=None))
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert [s["stage"] for s in got["stages"]] == ["sam", "clip", "fusion", "projector"]
    _assert_same_stages(got, want)


def test_ocr2_vision_dump_matches_the_reference():
    jcfg = dataclasses.replace(jax_tiny(), variant="ocr2", clip=None)
    ref = JaxEngine(jcfg, dtype=jnp.float32, max_seq_len=512, ocr2_params=jax_tiny_q())
    port = DeepseekOcrEngine(dataclasses.replace(tiny_deepseek_config(), variant="ocr2", clip=None),
                             dtype=torch.float32, device="cpu", max_seq_len=512,
                             state=params_from_jax(jax.device_get(ref.params)),
                             ocr2_params=tiny_qwen2_encoder_params())
    img = _image(7, (70, 50))
    want = ref.vision_debug_trace(ref.prepare_vision_input(img, JaxVision(256, 128, False)))
    got = port.vision_debug_trace(port.prepare_vision_input(img, VisionSettings(256, 128, False)))
    assert [s["stage"] for s in got["stages"]] == ["sam", "ocr2_encoder"]
    _assert_same_stages(got, want)


@pytest.mark.parametrize("step", [0, 2])
@pytest.mark.parametrize("use_cache", [True, False])
def test_logits_dump_matches_the_reference(f32_engines, tmp_path, monkeypatch, step, use_cache):
    """The reference dumps on its no-cache path; the port's cached decode
    dumps the same step's logits too."""
    ref, port = f32_engines
    monkeypatch.setenv("DSOCR_DEBUG_LOGITS_STEP", str(step))
    monkeypatch.setenv("DSOCR_DEBUG_LOGITS_PATH", str(tmp_path / "ref.json"))
    want_out = ref.decode(_Tok(), PROMPT, [_image(31, (50, 50))], JaxVision(64, 64, False),
                          JaxParams(max_new_tokens=4, no_repeat_ngram_size=None, use_cache=False))
    monkeypatch.setenv("DSOCR_DEBUG_LOGITS_PATH", str(tmp_path / "port.json"))
    got_out = port.decode(_Tok(), PROMPT, [_image(31, (50, 50))], VisionSettings(64, 64, False),
                          DecodeParameters(max_new_tokens=4, no_repeat_ngram_size=None, use_cache=use_cache))
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want) == {"step", "top1_id", "top1_logit", "top2_id", "top2_logit", "margin", "chosen"}
    for key in ("step", "top1_id", "top2_id", "chosen"):
        assert got[key] == want[key], key
    np.testing.assert_allclose([got[k] for k in ("top1_logit", "top2_logit", "margin")],
                               [want[k] for k in ("top1_logit", "top2_logit", "margin")], **TOL)
    assert got["step"] == step and got["margin"] >= 0.0
    assert got["chosen"] == got_out.generated_tokens[step] == want_out.generated_tokens[step]


def test_no_logits_dump_without_both_knobs(f32_engines, tmp_path, monkeypatch):
    _, port = f32_engines
    monkeypatch.setenv("DSOCR_DEBUG_LOGITS_STEP", "1")
    monkeypatch.delenv("DSOCR_DEBUG_LOGITS_PATH", raising=False)
    port.decode(_Tok(), PROMPT, [_image()], VisionSettings(64, 64, False), DecodeParameters(max_new_tokens=3))
    assert not list(tmp_path.iterdir())
