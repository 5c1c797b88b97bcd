"""Weights from files, the model side: the port's DeepSeek-OCR loader,
weight source and registry against the reference's
(dsocr_tpu/models/deepseek/loader.py, dsocr_tpu/dsq/runtime.py,
dsocr_tpu/models/registry.py), on checkpoints made by the reference's
test writer (tests/test_loaders.py, the tiny config) and by chip_smoke's
writer (hidden 256, where the K-quants' super-blocks fit), with snapshots
made by the reference's exporter.

- The loader's state equals params_from_jax of the reference loader's tree
  bit for bit, f32 and bf16, without a snapshot and with Q8_0, Q4_K and
  Q6_K snapshots; its raw payload table holds the reference's bytes.
- An engine built from it packs what the reference's engine packs from the
  same files (published codes where the snapshot has them, the float
  fallback records' values as Q8_0).
- load_engine's greedy tokens through ContinuousScheduler equal the
  reference load_engine's, int8 KV: a bf16 checkpoint, a Q8_0 and a Q6_K
  snapshot (served in f32: XLA's CPU backend cannot run the reference
  engine in bf16).
- chip_smoke's on-card check of a snapshot engine (its packed tensors
  against the port's packing of the floats the snapshot stands for) holds
  here, and so does its checkpoint writer against the reference's reader.
- The registry: resolve_dtype, the snapshot's default method, the families,
  PaddleOCR-VL served under a dp mesh; config.json parsing equals the
  reference's, OCR2 included (OCR2 and PaddleOCR-VL loading:
  tests/test_torch_ocr2.py, tests/test_torch_paddle.py).
"""

import asyncio
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import chip_smoke
from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.core.engine import ModelKind as JaxKind
from dsocr_tpu.dsq import cli as jax_cli
from dsocr_tpu.models import registry as jax_registry
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import DeepseekOcrConfig as JaxConfig
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.loader import load_deepseek_params as jax_load
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.core.engine import ModelKind
from dsocr_tpu_torch.dsq.runtime import WeightSource
from dsocr_tpu_torch.models import registry
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.models.deepseek.config import DeepseekOcrConfig
from dsocr_tpu_torch.models.deepseek.engine import RAW_QUANT_KEY
from dsocr_tpu_torch.models.deepseek.loader import load_deepseek_params
from dsocr_tpu_torch.models.deepseek.quantize import quantize_decoder_params
from dsocr_tpu_torch.models.paddleocr import PaddleOcrEngine, tiny_paddle_config
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler
from tests.test_loaders import _make_deepseek_checkpoint

BUDGETS = [3, 8, 8]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread per test (the suite runs under several workers) and
    the reference's NumPy quantizers (the bytes of its native build)."""
    monkeypatch.setenv("DSOCR_NO_NATIVE", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kq(cfg):
    """The tiny config at hidden 256: the K-quants' projections fit their
    super-blocks; the expert down projections (in 32) fall back."""
    lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=32)
    return dataclasses.replace(cfg, projector_n_embed=256, language=lang)


def _export(weights, config, out, method):
    assert jax_cli.main(["export", "--weights", str(weights), "--config", str(config), "--dtype", method,
                         "--model-id", "t", "--output", str(out)]) == 0
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: (port cfg, reference cfg, weights, snapshots by method)}:
    "tiny" (f32 file from the reference's writer), "tiny_bf16" (its tensors
    in bf16), "kq" (hidden 256, a two-shard set from chip_smoke's writer)."""
    import os

    os.environ["DSOCR_NO_NATIVE"] = "1"
    root = tmp_path_factory.mktemp("weights")
    out = {}
    cfg = tiny_deepseek_config()
    config = root / "config.json"
    config.write_text(json.dumps(chip_smoke.config_json(cfg)))
    _, tensors = _make_deepseek_checkpoint(root / "tiny.safetensors")
    save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in tensors.items()}, str(root / "tiny_bf16.safetensors"))
    out["tiny"] = (cfg, jax_tiny(), root / "tiny.safetensors",
                   {"q8_0": _export(root / "tiny.safetensors", config, root / "tiny_q8.dsq", "q8_0")})
    out["tiny_bf16"] = (cfg, jax_tiny(), root / "tiny_bf16.safetensors", {})
    kq = _kq(cfg)
    (root / "kq").mkdir()
    seeded = DeepseekOcrEngine(kq, dtype=torch.float32, device="cpu", max_seq_len=128, seed=8)
    index, kq_config, _ = chip_smoke.write_checkpoint(torch, seeded.model.state_dict(), kq, str(root / "kq"))
    out["kq"] = (kq, _kq(jax_tiny()), pathlib.Path(index), {
        m: _export(index, kq_config, root / f"kq_{m}.dsq", m) for m in ("q4_k", "q6_k")})
    os.environ.pop("DSOCR_NO_NATIVE")
    return out


def _reference_state(tree):
    tree = dict(tree)
    tree["decoder"] = dict(tree["decoder"])
    raw = tree["decoder"].pop("__raw_quant__", None)
    return params_from_jax(jax.device_get(tree)), raw


def _raw_bytes(raw):
    def b(p):
        return bytes(p.numpy()) if isinstance(p, torch.Tensor) else bytes(p)

    return {key: (ent["method"], [[b(p) for p in l] if isinstance(l, list) else b(l) for l in ent["layers"]])
            for key, ent in (raw or {}).items()}


@pytest.mark.parametrize("name,dtype,method", [
    ("tiny", "f32", None), ("tiny_bf16", "bf16", None), ("tiny", "bf16", None), ("tiny", "f32", "q8_0"),
    ("tiny", "bf16", "q8_0"), ("kq", "f32", "q4_k"), ("kq", "f32", "q6_k"), ("kq", "bf16", "q6_k"),
])
def test_loader_state_equals_reference(files, name, dtype, method):
    cfg, jcfg, weights, snaps = files[name]
    snap = snaps[method] if method else None
    tdtype, jdtype = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    want, want_raw = _reference_state(jax_load(weights, jcfg, dtype=jdtype, snapshot_path=snap))
    got = load_deepseek_params(weights, cfg, dtype=tdtype, snapshot_path=snap, device="cpu")
    got_raw = got.pop(RAW_QUANT_KEY, None)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == tdtype, key
        assert torch.equal(got[key].float(), want[key]), key
    assert _raw_bytes(got_raw) == _raw_bytes(want_raw)
    assert bool(got_raw) == bool(method)


@pytest.mark.parametrize("name,method", [("tiny", "q8_0"), ("kq", "q4_k"), ("kq", "q6_k")])
def test_snapshot_engine_packs_as_reference(files, name, method):
    cfg, jcfg, weights, snaps = files[name]
    tree = jax_load(weights, jcfg, dtype=jnp.float32, snapshot_path=snaps[method])
    jax_engine = JaxEngine(jcfg, params=tree, dtype=jnp.float32, max_seq_len=128, quantize=method)
    want = params_from_jax(jax.device_get(jax_engine.params))
    state = load_deepseek_params(weights, cfg, dtype=torch.float32, snapshot_path=snaps[method], device="cpu")
    got = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=128, state=state,
                            quantize=method).model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key].float() if got[key].is_floating_point() else got[key], want[key]), key


@pytest.mark.parametrize("method", ["q4_k", "q6_k"])
def test_chip_smoke_snapshot_check_holds(files, method):
    """The weights phase's check, at hidden 256 on the CPU: the snapshot
    engine's packed tensors equal the port's packing of the checkpoint's
    floats with the fallback records' values in place."""
    from dsocr_tpu_torch.dsq.format import DsqReader

    cfg, _, weights, snaps = files["kq"]
    base = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=128,
                             state=load_deepseek_params(weights, cfg, dtype=torch.float32, device="cpu"))
    loaded = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=128, quantize=method,
                               state=load_deepseek_params(weights, cfg, dtype=torch.float32,
                                                          snapshot_path=snaps[method], device="cpu"))
    reader = DsqReader(snaps[method])
    assert any(r.q_dtype == "F16" for r in reader.records)
    floats = chip_smoke.snapshot_floats(torch, base.model.state_dict(), cfg, reader, "cpu")
    want = quantize_decoder_params(floats, method)
    got = loaded.model.state_dict()
    packed = [k for k in want if k.rsplit(".", 1)[-1] in ("codes", "scales", "mins", "highs")]
    assert any(k.endswith(".highs" if method == "q6_k" else ".mins") for k in packed)
    for key in packed:
        assert torch.equal(got[key], want[key]), key


def _serve(sched, params_cls, vision):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in BUDGETS]

    async def run():
        return await asyncio.gather(*(
            sched.submit("<image>q", [img], vision, params_cls(max_new_tokens=n, no_repeat_ngram_size=None))
            for img, n in zip(images, BUDGETS)))

    return [o.generated_tokens for o in asyncio.run(run())]


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


@pytest.mark.parametrize("name,method", [("tiny_bf16", None), ("tiny", "q8_0"), ("kq", "q6_k")])
def test_load_engine_serves_the_reference_tokens(files, monkeypatch, tmp_path, name, method):
    """Both load_engines from the same files; config.json cannot carry the
    tiny towers' window and neck widths, so both read the test's config."""
    cfg, jcfg, weights, snaps = files[name]
    monkeypatch.setattr(JaxConfig, "from_json", classmethod(lambda cls, path: jcfg))
    monkeypatch.setattr(DeepseekOcrConfig, "from_json", classmethod(lambda cls, path: cfg))
    config = tmp_path / "config.json"
    config.write_text("{}")
    snap = snaps[method] if method else None
    jax_engine = jax_registry.load_engine(JaxKind.DEEPSEEK, config_path=config, weights_path=weights,
                                          snapshot_path=snap, dtype="float32", max_seq_len=256, kv_quant="int8")
    engine = registry.load_engine(ModelKind.DEEPSEEK, config_path=config, weights_path=weights,
                                  snapshot_path=snap, dtype="float32", max_seq_len=256, kv_quant="int8",
                                  device="cpu")
    assert engine.quantize == method and jax_engine.quantize_ == method
    want = _serve(JaxScheduler(jax_engine, _Tok(), n_slots=2, max_len=256, chunk_steps=4), JaxParams,
                  JaxVision(64, 64, False))
    got = _serve(ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=4), DecodeParameters,
                 VisionSettings(64, 64, False))
    assert got == want
    assert [len(t) for t in got] == BUDGETS


def test_weight_source_counts_and_raw_records(files):
    cfg, _, weights, snaps = files["tiny"]
    source = WeightSource.open(weights, snaps["q8_0"], device="cpu")
    assert source.get("model.layers.0.self_attn.q_proj.weight").dtype == torch.float32
    assert source.get("model.norm.weight").dtype == torch.float32
    assert (source.quantized_hits, source.float_hits) == (1, 1)
    payload, dtype, out_dim, in_dim = source.raw_quant("model.layers.0.self_attn.q_proj.weight")
    assert (dtype, out_dim, in_dim, payload.numel()) == ("Q8_0", 32, 32, 32 * 34)
    assert source.raw_quant("model.layers.1.mlp.experts.0.down_proj.weight") is None  # an F16 fallback
    assert source.raw_quant("model.norm.weight") is None
    assert "lm_head" in source and source.get_optional("nope") is None
    with pytest.raises(KeyError):
        source.get("nope")


def test_registry(files, tmp_path):
    assert registry.resolve_dtype(None) is torch.bfloat16
    for name in ("bf16", "float32", "F16"):
        want = jax_registry.resolve_dtype(name)
        assert str(registry.resolve_dtype(name)).split(".")[-1] == jnp.dtype(want).name
    with pytest.raises(ValueError):
        registry.resolve_dtype("int8")
    snaps = {**files["tiny"][3], **files["kq"][3]}
    for path in snaps.values():
        assert registry._snapshot_quant_method(path) == jax_registry._snapshot_quant_method(path)
    assert {registry._snapshot_quant_method(p) for p in snaps.values()} == {"q8_0", "q4_k", "q6_k"}
    assert registry._snapshot_quant_method(None) is None
    # every family loads under a mesh: PaddleOCR-VL's slot rows over dp,
    # through load_engine on its config.json, served as one process serves
    # (tests/test_torch_mesh_dense.py holds the families against the reference)
    pcfg = tiny_paddle_config()
    (tmp_path / "paddle").mkdir()
    _, paddle_config, _ = chip_smoke.write_checkpoint(
        torch, PaddleOcrEngine(pcfg, dtype=torch.float32, device="cpu").model.state_dict(), pcfg,
        str(tmp_path / "paddle"))
    kw = dict(config_path=paddle_config, dtype="float32", max_seq_len=512, device="cpu")
    single = registry.load_engine(ModelKind.PADDLE_OCR_VL, **kw)
    meshed = registry.load_engine(ModelKind.PADDLE_OCR_VL, mesh="dp=2,mp=1", **kw)
    page = np.random.default_rng(31).integers(0, 256, (60, 70, 3), dtype=np.uint8)
    try:
        cache = meshed.new_slot_cache(2, 256)
        assert cache.rows_split and cache.k.shape[1] == 1 and meshed.mesh_runtime.share is None

        def serve(engine):
            sched = ContinuousScheduler(engine, _Tok(), n_slots=2, max_len=256)
            try:
                return asyncio.run(sched.submit("<image>o", [page], VisionSettings(64, 64, False),
                                                DecodeParameters(max_new_tokens=5))).generated_tokens
            finally:
                asyncio.run(sched.close())

        assert serve(meshed) == serve(single) and serve(single)
    finally:
        meshed.close()
    with pytest.raises(ValueError, match="needs a mesh"):  # DeepSeek serves under one (test_torch_mesh*.py)
        registry.load_engine(ModelKind.DEEPSEEK, ep=True, device="cpu")
    with pytest.raises(NotImplementedError, match="expert-parallel only"):  # packed serving needs ep
        registry.load_engine(ModelKind.DEEPSEEK, mesh="dp=1,mp=2", quantize="q8_0", device="cpu")
    if not torch.cuda.is_available():  # the card unless the caller names the CPU
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            registry.load_engine(ModelKind.DEEPSEEK, weights_path=files["tiny"][2])


def test_config_from_dict_equals_reference():
    full = chip_smoke.config_json(DeepseekOcrConfig())
    assert DeepseekOcrConfig.from_dict(full) == DeepseekOcrConfig()
    flat = {"hidden_size": 640, "num_hidden_layers": 4, "vision_config": {"image_size": 512, "width": {
        "sam_vit_b": {"layers": 6, "global_attn_indexes": [1, 3]}}}, "projector_config": {"n_embed": 640}}
    ocr2 = {"language_config": {"hidden_size": 512}, "vision_config": {"model_name": "deepencoderv2"}}
    for data in (full, flat, ocr2):
        got, want = DeepseekOcrConfig.from_dict(data), JaxConfig.from_dict(data)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert DeepseekOcrConfig.from_dict(ocr2).variant == "ocr2"
    # OCR2 loads (tests/test_torch_ocr2.py); a missing file raises in the reader
    with pytest.raises(FileNotFoundError):
        load_deepseek_params("unused.safetensors", DeepseekOcrConfig.from_dict(ocr2), device="cpu")
    with pytest.raises(ValueError, match="projector_type"):
        DeepseekOcrConfig.from_dict({"projector_config": {"projector_type": "mlp"}})


def test_checkpoint_writer_reads_back_in_the_reference_reader(files):
    """chip_smoke's shard-set writer (the weights phase's checkpoint):
    every tensor the reference's safetensors reader returns equals the
    state it was written from."""
    from dsocr_tpu.utils.safetensors_io import CheckpointReader as JaxReader

    cfg, _, weights, _ = files["kq"]
    reader = JaxReader(weights)
    seeded = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=128, seed=8)
    written = dict(chip_smoke.hf_tensors(torch, seeded.model.state_dict(), cfg))
    assert sorted(reader.keys()) == sorted(written)
    assert len({str(p) for p in reader._files.values()}) == 2
    for name, t in written.items():
        np.testing.assert_array_equal(reader.get(name), t.numpy(), err_msg=name)


def _resummed(monkeypatch):
    """Every packed holder's matmuls with the same bf16 products summed in
    f64: results that differ from the twins' in the last bits, as the
    card's tensor-core order does (tests/test_torch_q6k.py's check, with
    Q4_K)."""
    from dsocr_tpu_torch.ops import linear
    from dsocr_tpu_torch.ops.kernels.kquant_matmul import dequant_q4k, dequant_q6k

    def row_w(h):  # [out, in] bf16
        if isinstance(h, linear.PackedQ6K):
            return dequant_q6k(h.codes, h.highs, h.scales, -1)
        if isinstance(h, linear.PackedQ4K):
            return dequant_q4k(h.codes, h.scales, h.mins, -1)
        return (h.codes.float() * h.scales.repeat_interleave(32, dim=-1)).to(torch.bfloat16)

    def x64(x):
        return x.to(torch.bfloat16).double()

    for cls in (linear.PackedQ8, linear.PackedQ4K, linear.PackedQ6K):
        monkeypatch.setattr(cls, "matmul", lambda self, x: (x64(x) @ row_w(self).double().t()).float())
        monkeypatch.setattr(cls, "gather", lambda self, x, idx: torch.bmm(
            x64(x)[:, None], self.dequant().double()[idx.long()])[:, 0].float())
        monkeypatch.setattr(cls, "dense", lambda self, x: torch.matmul(x64(x)[None], self.dequant().double()).float())
        monkeypatch.setattr(cls, "dense_perx", lambda self, x: torch.matmul(x64(x), self.dequant().double()).float())


def test_smoke_files_parity_has_no_near_tie(tmp_path, monkeypatch):
    """chip_smoke.py's phase-5 files case (FILES_PARITY_SEED's weights
    through a checkpoint and Q4_K / Q6_K snapshots, 4 slots, int8 KV): the
    twins' greedy tokens, and the same with every packed matmul summed in
    f64, so that the card's summation order cannot flip a token."""
    cfg = _kq(tiny_deepseek_config())
    index, snaps = chip_smoke.files_parity(torch, cfg, str(tmp_path), device="cpu")
    rng = np.random.default_rng(3)  # chip_smoke.parity_phase's requests
    images = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in range(3)]

    def tokens(method):
        engine = chip_smoke.file_engine(torch, cfg, index, snaps[method], method, "cpu", kv_quant="int8")
        outs, _ = chip_smoke.serve(engine, chip_smoke.TinyTokenizer(), images, VisionSettings(64, 64, False),
                                   DecodeParameters(max_new_tokens=16, no_repeat_ngram_size=None),
                                   n_slots=4, max_len=256, chunk=8)
        return [o.generated_tokens for o in outs]

    want = {m: tokens(m) for m in snaps}
    _resummed(monkeypatch)
    assert {m: tokens(m) for m in snaps} == want
