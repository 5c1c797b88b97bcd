"""PaddleOCR-VL in the port against the reference (tiny config, f32, the
same weights through params_from_jax; the tiny decoder has 4 query heads
over 2 KV heads, and a variant 4 over 1, so the grouped heads are
exercised):

- M-RoPE tables, ``compute_position_ids`` with and without images,
  ``interpolate_pos_grid``, ``build_2d_rope`` and ``merge_reshape``: exact
  or within atol = rtol = 1e-5;
- SigLIP's query-blocked attention against the unblocked one on a block
  smaller than N (equal within 1e-6: each query's softmax is its own);
- ``SiglipTower``, the projector and the Ernie decoder (fused and split,
  plain attention and the flash prefill) within 1e-5; prefill then
  decode steps, through the contiguous cache and the slot cache, equal
  to the full forward;
- the tiny engine's greedy tokens through ``decode`` and through
  ``ContinuousScheduler`` (streaming included, and an EOS that the
  engine appends before it stops) equal to the reference engine's;
- Q8_0-packed trees against the reference's ``quantize_ernie_params`` and
  the Q8_0 engine's tokens against the reference's;
- ``load_paddle_params`` and a DSQ snapshot written by the Paddle adapter
  against the reference loader and exporter on the same files;
- ``load_engine`` for both new families through the port's registry.
"""

import asyncio
import dataclasses as dc
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.core.engine import ModelKind as JaxKind
from dsocr_tpu.dsq import cli as jax_cli
from dsocr_tpu.models import registry as jax_registry
from dsocr_tpu.models.paddleocr import PaddleOcrEngine as JaxEngine
from dsocr_tpu.models.paddleocr.config import PaddleConfig as JaxConfig
from dsocr_tpu.models.paddleocr.config import tiny_paddle_config as jax_tiny
from dsocr_tpu.models.paddleocr.loader import load_paddle_params as jax_load
from dsocr_tpu.models.paddleocr.quantize import quantize_ernie_params as jax_quantize
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.core.engine import ModelKind
from dsocr_tpu_torch.dsq import cli
from dsocr_tpu_torch.models import registry
from dsocr_tpu_torch.models.paddleocr import PaddleOcrEngine, params_from_jax, tiny_paddle_config
from dsocr_tpu_torch.models.paddleocr.config import PaddleConfig
from dsocr_tpu_torch.models.paddleocr.decoder import ErnieDecoder, compute_position_ids, mrope_cos_sin
from dsocr_tpu_torch.models.paddleocr.loader import load_paddle_params
from dsocr_tpu_torch.models.paddleocr.projector import PaddleProjector, merge_reshape
from dsocr_tpu_torch.models.paddleocr.quantize import quantize_ernie_params
from dsocr_tpu_torch.models.paddleocr.vision import (
    SiglipTower,
    blocked_attention,
    build_2d_rope,
    interpolate_pos_grid,
)
from dsocr_tpu_torch.ops import attention
from dsocr_tpu_torch.runtime.kv_cache import bump_length
from dsocr_tpu_torch.runtime.slots import alloc_slot_cache
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

jdec = importlib.import_module("dsocr_tpu.models.paddleocr.decoder")
jvis = importlib.import_module("dsocr_tpu.models.paddleocr.vision")
jproj = importlib.import_module("dsocr_tpu.models.paddleocr.projector")

F32 = dict(atol=1e-5, rtol=1e-5)
VISION, JAX_VISION = VisionSettings(64, 64, False), JaxVision(64, 64, False)
IMAGE_END = 252


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 + 3 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return IMAGE_END if token == "<|IMAGE_END|>" else None


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def _pair(cfg, jcfg, **kw):
    jax_engine = JaxEngine(jcfg, dtype=jnp.float32, max_seq_len=512, **kw)
    state = params_from_jax(jax.device_get(jax_engine.params))
    port = PaddleOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, state=state, **kw)
    return jax_engine, port


@pytest.fixture(scope="module")
def engines():
    return _pair(tiny_paddle_config(), jax_tiny())


# -- modules --------------------------------------------------------------------------------


def test_mrope_tables_and_position_ids_equal_reference():
    cfg, jcfg = tiny_paddle_config(), jax_tiny()
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 3000, (3, 2, 40)).astype(np.int32)
    for got, want in zip(mrope_cos_sin(torch.from_numpy(pos), cfg), jdec.mrope_cos_sin(jnp.asarray(pos), jcfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    img = cfg.image_token_id
    rows = [
        ([1, 5, 6, 7], []),
        ([1, 251] + [img] * 6 + [252, 9, 9], [(1, 4, 6)]),
        ([1, 251] + [img] * 4 + [252, 8, 251] + [img] * 12 + [252], [(1, 4, 4), (1, 6, 8)]),
        ([251] + [img] * 2 + [252], [(1, 2, 4)]),
    ]
    for ids, grids in rows:
        got, delta = compute_position_ids(cfg, ids, grids)
        want, want_delta = jdec.compute_position_ids(jcfg, np.asarray(ids, np.int64), grids)
        assert got.dtype == np.int32 and np.array_equal(got, want) and delta == want_delta


@pytest.mark.parametrize("target", [(2, 2), (5, 7), (26, 30), (1, 9), (40, 3)])
def test_pos_grid_rope_and_merge_equal_reference(target):
    rng = np.random.default_rng(sum(target))
    grid = rng.standard_normal((4, 8)).astype(np.float32)
    got = interpolate_pos_grid(torch.from_numpy(grid), 2, *target)
    np.testing.assert_allclose(got.numpy(), np.asarray(jvis.interpolate_pos_grid(jnp.asarray(grid), 2, *target)),
                               **F32)
    h_ids = np.repeat(np.arange(target[0]), target[1])
    w_ids = np.tile(np.arange(target[1]), target[0])
    for head_dim in (16, 72):
        got = build_2d_rope(torch.from_numpy(h_ids), torch.from_numpy(w_ids), head_dim)
        want = jvis.build_2d_rope(jnp.asarray(h_ids, jnp.int32), jnp.asarray(w_ids, jnp.int32), head_dim)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    if target[0] % 2 == 0 and target[1] % 2 == 0:
        feats = rng.standard_normal((target[0] * target[1], 6)).astype(np.float32)
        got = merge_reshape(torch.from_numpy(feats), (1, *target), 2)
        assert np.array_equal(got.numpy(), np.asarray(jproj.merge_reshape(jnp.asarray(feats), (1, *target), 2)))


def test_blocked_attention_equals_unblocked():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 37, 8)).astype(np.float32)) for _ in range(3))
    want = attention(q, k, v)
    for block in (1, 5, 16, 36, None):
        torch.testing.assert_close(blocked_attention(q, k, v, block), want, atol=1e-6, rtol=1e-6)


def _vision_inputs(cfg, seed=3, grid=(1, 4, 6)):
    v = cfg.vision_config
    n = grid[1] * grid[2]
    patches = np.random.default_rng(seed).standard_normal((n, v.num_channels, v.patch_size, v.patch_size))
    h_ids = np.repeat(np.arange(grid[1]), grid[2]).astype(np.int32)
    w_ids = np.tile(np.arange(grid[2]), grid[1]).astype(np.int32)
    return patches.astype(np.float32), grid, h_ids, w_ids


def test_siglip_and_projector_match_reference():
    cfg, jcfg = tiny_paddle_config(), jax_tiny()
    params = jax.device_get(jvis.init_siglip_params(jcfg.vision_config, jax.random.PRNGKey(2), jnp.float32))
    proj = jax.device_get(jproj.init_projector_params(jcfg, jax.random.PRNGKey(4), jnp.float32))
    state = params_from_jax({"vision": params, "projector": proj, "decoder": {"layers": {}}})
    tower = SiglipTower(cfg.vision_config, torch.float32, "cpu")
    tower.load_state_dict({k[len("vision."):]: v for k, v in state.items() if k.startswith("vision.")})
    projector = PaddleProjector(cfg, torch.float32, "cpu")
    projector.load_state_dict({k[len("projector."):]: v for k, v in state.items() if k.startswith("projector.")})
    patches, grid, h_ids, w_ids = _vision_inputs(cfg)
    want = jvis.siglip_forward(params, jcfg.vision_config, jnp.asarray(patches), grid, jnp.asarray(h_ids),
                               jnp.asarray(w_ids))
    for block in (None, 5):
        got = tower(torch.from_numpy(patches)[None], grid, torch.from_numpy(h_ids), torch.from_numpy(w_ids),
                    block=block)
        np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want), **F32)
    merged = projector(torch.from_numpy(np.array(want))[None], grid)
    np.testing.assert_allclose(merged[0].detach().numpy(),
                               np.asarray(jproj.projector_forward(proj, jcfg, want, grid)), **F32)


@pytest.mark.parametrize("kv_heads", [2, 1])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("flash", [False, True])
def test_ernie_forward_matches_reference(kv_heads, fused, flash):
    cfg = dc.replace(tiny_paddle_config(), num_key_value_heads=kv_heads)
    jcfg = dc.replace(jax_tiny(), num_key_value_heads=kv_heads)
    params = jax.device_get(jdec.init_ernie_params(jcfg, jax.random.PRNGKey(kv_heads), jnp.float32))
    if fused:
        params = jax.device_get(jdec.fuse_ernie_params(params))
    state = {k[len("decoder."):]: v for k, v in params_from_jax({"vision": {}, "projector": {}, "decoder": params})
             .items()}
    decoder = ErnieDecoder(cfg, torch.float32, "cpu", split=not fused)
    decoder.load_state_dict(state)
    rng = np.random.default_rng(7)
    S = 24
    embeds = rng.standard_normal((2, S, cfg.hidden_size)).astype(np.float32)
    pos = np.stack([np.arange(S)] * 3)[:, None].repeat(2, 1).astype(np.int32)
    pos[1, 1, 4:10] += 3  # image-like offsets on one row
    want, _ = jdec.ernie_forward(params, jcfg, jnp.asarray(embeds), jnp.asarray(pos),
                                 jdec.new_cache(jcfg, 2, S, jnp.float32), full_logits=not flash,
                                 flash_prefill=flash)
    got, _ = decoder(torch.from_numpy(embeds), torch.from_numpy(pos).long(),
                     decoder_cache(decoder, 2, S), full_logits=not flash, flash_prefill=flash)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def decoder_cache(decoder, batch, length):
    from dsocr_tpu_torch.runtime.kv_cache import init_kv_cache

    cfg = decoder.cfg
    return init_kv_cache(cfg.num_hidden_layers, batch, cfg.resolved_num_key_value_heads, length, cfg.head_dim,
                         cfg.head_dim, torch.float32, "cpu")


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefill_then_decode_equals_full_forward(engines, kv_quant):
    """Prefill S − 3 tokens, then 3 one-token steps through the contiguous
    cache and through the slot cache: each step's logits equal the full
    forward's at that position (the int8 slot cache within its
    quantization error)."""
    decoder = engines[1].model.decoder
    cfg = decoder.cfg
    rng = np.random.default_rng(11)
    S = 20
    embeds = torch.from_numpy(rng.standard_normal((1, S, cfg.hidden_size)).astype(np.float32))
    pos = torch.arange(S)[None, None].expand(3, 1, S) + torch.tensor([0, 2, 5])[:, None, None]
    full, _ = decoder(embeds, pos, decoder_cache(decoder, 1, S), full_logits=True)
    n = S - 3
    logits, cache = decoder(embeds[:, :n], pos[:, :, :n], decoder_cache(decoder, 1, S), flash_prefill=True)
    np.testing.assert_allclose(logits.numpy(), full[:, n - 1].numpy(), **F32)
    cache = bump_length(cache, n)
    _, k, v = decoder.prefill(embeds[:, :n], pos[:, :, :n])
    slots = alloc_slot_cache(cfg.num_hidden_layers, 2, cfg.resolved_num_key_value_heads, 32, cfg.head_dim,
                             cfg.head_dim, torch.float32, kv_quant, "cpu")
    from dsocr_tpu_torch.ops import quantize_kv_int8

    for plane, block in ((slots.k, k), (slots.v, v)):
        if kv_quant:
            codes, scale = quantize_kv_int8(block[:, 0])
            plane[:, 1, :, :n] = codes
            (slots.k_scale if plane is slots.k else slots.v_scale)[:, 1, :, :n] = scale
        else:
            plane[:, 1, :, :n] = block[:, 0]
    slots.lengths[1] = n
    tol = F32 if kv_quant is None else dict(atol=0.05, rtol=0.05)
    for i in range(n, S):
        step, cache = decoder(embeds[:, i : i + 1], pos[:, :, i : i + 1], cache)
        cache = bump_length(cache, 1)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(), **F32)
        two = torch.cat([embeds[:, i : i + 1]] * 2)
        slot = decoder.slot_step(two, pos[:, :, i : i + 1].expand(3, 2, 1), slots)
        slots.lengths[1] += 1
        np.testing.assert_allclose(slot[1].numpy(), full[0, i].numpy(), **tol)


# -- engines ----------------------------------------------------------------------------------


def test_engine_embeddings_and_prompt_equal_reference(engines):
    jax_engine, port = engines
    for img in _images(5, [(60, 70), (90, 40), (30, 500)]):
        want = jax_engine.encode_image(img, JAX_VISION)
        got = port.encode_image(img, VISION)
        assert got.original_grid == want.original_grid and got.merged_grid == want.merged_grid
        np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings), **F32)
        for tok in (_Tok(), type("NoEnd", (_Tok,), {"token_to_id": lambda self, t: None})()):
            assert port.build_prompt_tokens(tok, "a<image>b", [got.original_grid]) == \
                jax_engine.build_prompt_tokens(tok, "a<image>b", [want.original_grid])


@pytest.mark.parametrize("n", [3, 12])
def test_decode_tokens_equal_reference(engines, n):
    jax_engine, port = engines
    for img in _images(n, [(60, 70), (90, 40)]):
        want = jax_engine.decode(_Tok(), "<image>ocr", [img], JAX_VISION,
                                 JaxParams(max_new_tokens=n, no_repeat_ngram_size=None))
        got = port.decode(_Tok(), "<image>ocr", [img], VISION,
                          DecodeParameters(max_new_tokens=n, no_repeat_ngram_size=None))
        assert (got.generated_tokens, got.prompt_tokens) == (want.generated_tokens, want.prompt_tokens)


def _serve(engine, sched_cls, params_cls, images, streams=None, max_new=10):
    async def go():
        sched = sched_cls(engine, _Tok(), n_slots=2, max_len=256, chunk_steps=3)
        return await asyncio.gather(*(
            sched.submit(f"<image>o{i}", [im], JAX_VISION if sched_cls is JaxScheduler else VISION,
                         params_cls(max_new_tokens=max_new, no_repeat_ngram_size=None),
                         **({"stream_cb": streams[i]} if streams else {}))
            for i, im in enumerate(images)))

    return [o.generated_tokens for o in asyncio.run(go())]


def test_scheduler_tokens_equal_reference(engines):
    """Four requests over two slots (two pages of one grid pool through the
    tower), streamed in the port: every callback extends the last."""
    jax_engine, port = engines
    images = _images(17, [(60, 70), (60, 70), (90, 40), (40, 120)])
    want = _serve(jax_engine, JaxScheduler, JaxParams, images)
    seen = [[] for _ in images]
    got = _serve(port, ContinuousScheduler, DecodeParameters, images,
                 streams=[lambda n, toks, i=i: seen[i].append(list(toks)) for i in range(len(images))])
    assert got == want
    for i, calls in enumerate(seen):
        assert calls and calls[-1] == got[i]
        assert all(calls[j] == calls[j + 1][: len(calls[j])] for j in range(len(calls) - 1))


def test_eos_is_appended_then_stops_like_reference(engines):
    """With the most frequent generated token as EOS, both packages append
    it and stop, through decode and through the scheduler."""
    jax_engine, port = engines
    images = _images(17, [(60, 70), (90, 40)])
    # the first token of a row that comes after a different first token
    eos = next(t for toks in _serve(port, ContinuousScheduler, DecodeParameters, images)
               for j, t in enumerate(toks) if j and t not in toks[:j])
    jax_eos = JaxEngine(dc.replace(jax_tiny(), eos_token_id=eos), params=jax_engine.params, dtype=jnp.float32,
                        max_seq_len=512)
    port_eos = PaddleOcrEngine(dc.replace(tiny_paddle_config(), eos_token_id=eos), dtype=torch.float32,
                               device="cpu", max_seq_len=512, state=port.model.state_dict())
    want = _serve(jax_eos, JaxScheduler, JaxParams, images)
    assert want == _serve(port_eos, ContinuousScheduler, DecodeParameters, images)
    assert any(t and t[-1] == eos for t in want)
    for img in images:
        a = jax_eos.decode(_Tok(), "<image>x", [img], JAX_VISION, JaxParams(max_new_tokens=10))
        b = port_eos.decode(_Tok(), "<image>x", [img], VISION, DecodeParameters(max_new_tokens=10))
        assert a.generated_tokens == b.generated_tokens


def test_q8_trees_and_tokens_equal_reference(engines):
    jax_engine, port = engines
    tree = jax.device_get(jax_engine.params)
    state = params_from_jax(tree)
    want = params_from_jax(dict(tree, decoder=jax.device_get(jax_quantize(tree["decoder"], "q8_0"))))
    got = quantize_ernie_params(state, "q8_0")
    assert set(got) == set(want)
    assert any(k.endswith(".codes") for k in got)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    jq = JaxEngine(jax_tiny(), params=tree, dtype=jnp.float32, max_seq_len=512, quantize="q8_0")
    pq = PaddleOcrEngine(tiny_paddle_config(), dtype=torch.float32, device="cpu", max_seq_len=512, state=state,
                         quantize="q8_0")
    images = _images(19, [(60, 70), (90, 40), (60, 70)])
    assert _serve(pq, ContinuousScheduler, DecodeParameters, images) == _serve(jq, JaxScheduler, JaxParams, images)


# -- files --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(engines, tmp_path_factory):
    """The tiny engine written under the published names, and Q8_0
    snapshots of it from both exporters."""
    _, port = engines
    directory = tmp_path_factory.mktemp("paddle")
    index, config, _ = chip_smoke.write_checkpoint(torch, port.model.state_dict(), port.cfg, str(directory))
    common = ["export", "--weights", index, "--config", config, "--dtype", "q8_0", "--model-id", "tiny"]
    snaps = {"ref": str(directory / "ref.dsq"), "mine": str(directory / "mine.dsq")}
    assert jax_cli.main(common + ["--output", snaps["ref"]]) == 0
    assert cli.main(common + ["--output", snaps["mine"], "--device", "cpu"]) == 0
    return index, config, snaps


def test_config_json_round_trips(files):
    _, config, _ = files
    assert PaddleConfig.from_json(config) == tiny_paddle_config()
    data = json.loads(open(config).read())
    assert dc.asdict(PaddleConfig.from_dict(data)) == dc.asdict(JaxConfig.from_dict(data))


def test_snapshot_export_equals_reference(files):
    _, _, snaps = files
    assert open(snaps["mine"], "rb").read() == open(snaps["ref"], "rb").read()


@pytest.mark.parametrize("snapshot", [False, True])
def test_loader_matches_reference_loader(engines, files, snapshot):
    index, _, snaps = files
    snap = snaps["mine"] if snapshot else None
    got = load_paddle_params(index, tiny_paddle_config(), dtype=torch.float32, snapshot_path=snap, device="cpu")
    tree = jax_load(index, jax_tiny(), dtype=jnp.float32, snapshot_path=snap)
    raw = tree["decoder"].pop("__raw_quant__", None)
    got_raw = got.pop("__raw_quant__", None)
    want = params_from_jax(jax.device_get(tree))
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    if snapshot:
        assert got_raw.keys() == raw.keys() and len(raw) == 7
        for key in raw:
            assert got_raw[key]["method"] == raw[key]["method"]
            assert [np.asarray(p).tobytes() for p in got_raw[key]["layers"]] == \
                [np.asarray(p).tobytes() for p in raw[key]["layers"]]
    else:
        state = engines[1].model.state_dict()
        engine = PaddleOcrEngine(tiny_paddle_config(), dtype=torch.float32, device="cpu", state=got)
        assert all(torch.equal(v, state[k]) for k, v in engine.model.state_dict().items())


def test_load_engine_paddle_tokens_equal_reference(files):
    index, config, snaps = files
    images = _images(23, [(60, 70), (90, 40)])
    for snapshot in (None, snaps["mine"]):
        port = registry.load_engine(ModelKind.PADDLE_OCR_VL, config_path=config, weights_path=index,
                                    snapshot_path=snapshot, dtype="float32", max_seq_len=512, kv_quant="int8",
                                    device="cpu")
        assert isinstance(port, PaddleOcrEngine) and port.quantize == ("q8_0" if snapshot else None)
        ref = jax_registry.load_engine(JaxKind.PADDLE_OCR_VL, config_path=config, weights_path=index,
                                       snapshot_path=snapshot, dtype="float32", max_seq_len=512, kv_quant="int8")
        assert _serve(port, ContinuousScheduler, DecodeParameters, images) == \
            _serve(ref, JaxScheduler, JaxParams, images)
    if not torch.cuda.is_available():  # the card unless the caller names the CPU
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            registry.load_engine(ModelKind.PADDLE_OCR_VL, config_path=config, weights_path=index)


def test_load_engine_ocr2_through_the_registry(tmp_path, monkeypatch):
    """An OCR2 config.json builds an OCR2 engine through load_engine, from
    a checkpoint: the same state as load_deepseek_params gives (the tiny
    encoder patched in as the registry's default widths)."""
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config
    from dsocr_tpu_torch.models.deepseek import engine as ds_engine
    from dsocr_tpu_torch.models.deepseek import loader as ds_loader
    from dsocr_tpu_torch.models.deepseek.config import DeepseekOcrConfig
    from dsocr_tpu_torch.models.deepseek.ocr2 import tiny_qwen2_encoder_params

    cfg = dc.replace(tiny_deepseek_config(), variant="ocr2", clip=None)
    seeded = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=4,
                               ocr2_params=tiny_qwen2_encoder_params())
    index, config, _ = chip_smoke.write_checkpoint(torch, seeded.model.state_dict(), cfg, str(tmp_path),
                                                   ocr2=tiny_qwen2_encoder_params())
    assert DeepseekOcrConfig.from_json(config).variant == "ocr2"
    monkeypatch.setattr(DeepseekOcrConfig, "from_json", classmethod(lambda cls, path: cfg))
    for module in (ds_engine, ds_loader):
        monkeypatch.setattr(module, "Qwen2EncoderParams", tiny_qwen2_encoder_params)
    engine = registry.load_engine(ModelKind.DEEPSEEK, config_path=config, weights_path=index, dtype="float32",
                                  max_seq_len=512, device="cpu")
    assert engine.cfg.variant == "ocr2"
    want = seeded.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in engine.model.state_dict().items())
    # the other dense families load under a mesh (``ep`` dropped: they have
    # no experts) and serve as one process does (tests/test_torch_mesh_dense.py)
    from dsocr_tpu_torch.models import dots, glm

    images = _images(29, [(60, 70)])
    for module, tiny in ((dots, dots.tiny_dots_config()), (glm, glm.tiny_glm_config())):
        config_cls = type(tiny)
        monkeypatch.setattr(config_cls, "from_json", classmethod(lambda cls, path, tiny=tiny: tiny))
        kind = ModelKind.DOTS_OCR if module is dots else ModelKind.GLM_OCR
        single = registry.load_engine(kind, config_path="tiny", dtype="float32", max_seq_len=1024, device="cpu")
        meshed = registry.load_engine(kind, config_path="tiny", dtype="float32", max_seq_len=1024, device="cpu",
                                      mesh="dp=1,mp=2,ep")
        try:
            assert meshed.mesh.mp == 2 and not meshed.mesh.ep and meshed.mesh_runtime.share.nkv == 1
            sched = ContinuousScheduler(meshed, _Tok(), n_slots=2, max_len=1024, chunk_steps=3)
            got = asyncio.run(sched.submit("<image>o", images, VISION, DecodeParameters(max_new_tokens=5)))
            asyncio.run(sched.close())
            want = asyncio.run(ContinuousScheduler(single, _Tok(), n_slots=2, max_len=1024).submit(
                "<image>o", images, VISION, DecodeParameters(max_new_tokens=5)))
            assert got.generated_tokens == want.generated_tokens and got.generated_tokens
        finally:
            meshed.close()
        assert meshed.mesh_runtime.ranks.closed and not meshed.alive


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("family", ["ocr2", "paddle"])
def test_smoke_family_parity_seed_has_no_near_tie(family, kv_quant):
    """chip_smoke.py's parity for the new families (FAMILY_PARITY_SEED, its
    requests and settings): on the CPU every greedy selection, the first
    tokens from the prefill packets and every decode step's rows, has a
    top-1 logit at least 1e-3 above the next, far beyond the card's f32
    summation differences, so CUDA and CPU tokens may be required equal."""
    rng = np.random.default_rng(3)  # chip_smoke.parity_phase's requests
    images = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in range(3)]
    engine = chip_smoke.family_parity_engine(torch, family, "cpu", kv_quant)
    gaps = []

    def gap(logits):
        top = torch.topk(logits.float().reshape(-1, logits.shape[-1]), 2).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))

    step, prefill = engine.slot_step_fn, engine.prefill_for_slots

    def slot_step_fn(*args):
        out = step(*args)
        gap(out)
        return out

    def prefill_for_slots(*args):
        packets = prefill(*args)
        for pkt in packets:
            gap(pkt["logits"])
        return packets

    engine.slot_step_fn, engine.prefill_for_slots = slot_step_fn, prefill_for_slots
    outs, _ = chip_smoke.serve(engine, chip_smoke.TinyTokenizer(), images,
                               VisionSettings(*chip_smoke.FAMILY_PARITY_VISION[family]),
                               DecodeParameters(max_new_tokens=16, no_repeat_ngram_size=None),
                               n_slots=2, max_len=256, chunk=8)
    assert all(o.generated_tokens for o in outs)
    assert min(gaps) > 1e-3, sorted(gaps)[:5]
