"""GLM-OCR in the port against the reference (the same weights through
params_from_jax; the tiny config's decoder has 4 query heads over 2 KV
heads of 16 with the rotary on 8 of them):

- ``glm_smart_resize``, ``glm_norm_table``, the uint8 patch layout and its
  host normalization, ``grouped_axis_ids``, ``build_rotary_np``,
  ``compute_glm_position_ids`` (text, images, video spans) and the prompt
  scaffold: exact;
- the interleaved partial M-RoPE tables (an ulp of XLA's cos: 1e-6), and
  a case where they differ from PaddleOCR-VL's layout;
- the GLM tower against the reference's eager and jitted packed paths in
  f32 (atol = rtol = 1e-5), and in bf16 activations over f32 weights
  within bf16's tolerance;
- the decoder (plain attention and the flash prefill) in f32 within 1e-5,
  prefill then steps through both caches equal to the full forward;
- greedy tokens through ``decode`` and ``ContinuousScheduler`` (a
  two-image request, the early stop on each of the three EOS ids);
- sampling refused by ``decode``, by ``validate_slot_params`` and through
  the scheduler with the engine's ValueError;
- ``load_glm_params`` from a written checkpoint against the reference's
  loader, and ``load_engine`` on the CPU against the reference's.
"""

import asyncio
import dataclasses as dc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.core.engine import ModelKind as JaxKind
from dsocr_tpu.models import registry as jax_registry
from dsocr_tpu.models.glm import GlmOcrEngine as JaxEngine
from dsocr_tpu.models.glm.config import GlmConfig as JaxConfig
from dsocr_tpu.models.glm.config import tiny_glm_config as jax_tiny
from dsocr_tpu.models.glm.loader import load_glm_params as jax_load
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.core.engine import ModelKind
from dsocr_tpu_torch.models import registry
from dsocr_tpu_torch.models.glm import GlmConfig, GlmOcrEngine, params_from_jax, tiny_glm_config
from dsocr_tpu_torch.models.glm.decoder import GlmDecoder, compute_glm_position_ids, fuse_glm_params, glm_mrope_cos_sin
from dsocr_tpu_torch.models.glm.engine import (
    glm_norm_table,
    glm_smart_resize,
    preprocess_glm_image_raw,
)
from dsocr_tpu_torch.models.glm.loader import load_glm_params
from dsocr_tpu_torch.models.glm.vision import GlmVisionTower, build_rotary_np, grouped_axis_ids
from dsocr_tpu_torch.models.paddleocr import tiny_paddle_config
from dsocr_tpu_torch.models.paddleocr.decoder import mrope_cos_sin
from dsocr_tpu_torch.runtime.kv_cache import bump_length, init_kv_cache
from dsocr_tpu_torch.runtime.slots import alloc_slot_cache
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

jdec = importlib.import_module("dsocr_tpu.models.glm.decoder")
jvis = importlib.import_module("dsocr_tpu.models.glm.vision")
jeng = importlib.import_module("dsocr_tpu.models.glm.engine")

F32 = dict(atol=1e-5, rtol=1e-5)
VISION, JAX_VISION = VisionSettings(64, 64, False), JaxVision(64, 64, False)


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 + 3 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512)
    state = params_from_jax(jax.device_get(jax_engine.params))
    return jax_engine, GlmOcrEngine(tiny_glm_config(), dtype=torch.float32, device="cpu", max_seq_len=512,
                                    state=state)


# -- preprocessing, tables, positions ------------------------------------------------------------


def glm_normalize_host(u8_patches: np.ndarray, cfg) -> np.ndarray:
    """[N, 3, p, p] uint8 → [N, C·T·p·p] f32 (the reference's layout): the
    port's table, then the frame repeated over T, as the engine does on
    the device."""
    n = u8_patches.shape[0]
    vals = glm_norm_table(cfg)[np.arange(3)[None, :, None], u8_patches.reshape(n, 3, -1)]
    return np.repeat(vals[:, :, None], cfg.vision.temporal_patch_size, axis=2).reshape(n, -1)


def test_smart_resize_norm_table_and_patches_equal_reference():
    cfg, jcfg = tiny_glm_config(), jax_tiny()
    full, jfull = GlmConfig(), JaxConfig()
    for h, w in [(1, 1), (27, 28), (60, 90), (1756, 2852), (3000, 20), (500, 500)]:
        for c, jc in ((cfg, jcfg), (full, jfull)):
            args = (h, w, 28, 2, c.min_pixels, c.max_pixels)
            assert glm_smart_resize(*args) == jeng.glm_smart_resize(*args)
    assert np.array_equal(glm_norm_table(full), jeng.glm_norm_table(jfull))
    for img in _images(1, [(60, 90), (31, 45), (28, 28)]):
        got, grid = preprocess_glm_image_raw(img, cfg)
        want, jgrid = jeng.preprocess_glm_image_raw(img, jcfg)
        assert grid == jgrid and got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(glm_normalize_host(got, cfg), jeng.glm_normalize_host(want, jcfg))
    for grids in ([(1, 4, 6)], [(1, 2, 2), (2, 4, 4)]):
        assert np.array_equal(grouped_axis_ids(*grids[0][1:], 2), jvis.grouped_axis_ids(*grids[0][1:], 2))
        for a, b in zip(build_rotary_np(grids, cfg.vision), jvis.build_rotary_np(grids, jcfg.vision)):
            assert np.array_equal(a, b)


def test_position_ids_equal_reference():
    cfg = tiny_glm_config()
    img, vs, ve = cfg.image_token_id, cfg.video_start_token_id, cfg.video_end_token_id
    rows = [
        ([7, 8, 9], []),
        ([7, 8, img, img, img, img, 9], [(1, 4, 4)]),
        ([5, img, img, 6, 6, img, img, img, img, img, img, 2], [(1, 2, 4), (1, 4, 6)]),
        ([vs, img, img, ve, 3, img, img, 4], [(1, 2, 4)]),
        ([img] * 8, [(2, 4, 4)]),
    ]
    for ids, grids in rows:
        got, base = compute_glm_position_ids(img, vs, ve, ids, grids, 2)
        want, jbase = jdec.compute_glm_position_ids(img, vs, ve, np.asarray(ids, np.int64), grids, 2)
        assert got.dtype == np.int32 and np.array_equal(got, want) and base == jbase


def test_mrope_tables_equal_reference_and_differ_from_paddle():
    cfg, jcfg = tiny_glm_config().text, jax_tiny().text
    pos = np.random.default_rng(0).integers(0, 3000, (3, 2, 40)).astype(np.int32)
    got = glm_mrope_cos_sin(torch.from_numpy(pos), cfg)
    for a, b in zip(got, jdec.glm_mrope_cos_sin(jnp.asarray(pos), jcfg)):
        assert a.shape == (2, 40, cfg.rope_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    # the same sections and head dim through PaddleOCR-VL's layout
    paddle = dc.replace(tiny_paddle_config(), head_dim=cfg.rope_dim, rope_theta=cfg.rope_theta,
                        mrope_section=cfg.mrope_section)
    other = mrope_cos_sin(torch.from_numpy(pos), paddle)
    assert other[0].shape == got[0].shape and not torch.allclose(other[0], got[0], atol=1e-3)
    same = torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy())  # all axes equal: still reordered
    assert not torch.allclose(mrope_cos_sin(same, paddle)[0], glm_mrope_cos_sin(same, cfg)[0], atol=1e-3)


def test_prompt_scaffold_equals_reference(engines):
    jax_engine, port = engines
    for prompt, grids in (("<image>x", [(1, 4, 4)]), ("a<image>b<image>", [(1, 2, 4), (1, 4, 4)]), ("t", [])):
        assert port.build_prompt_tokens(_Tok(), prompt, grids) == jax_engine.build_prompt_tokens(_Tok(), prompt,
                                                                                                 grids)
    with pytest.raises(ValueError, match="placeholders"):
        port.build_prompt_tokens(_Tok(), "<image>", [])


# -- modules ------------------------------------------------------------------------------------


@pytest.mark.parametrize("grids", [[(1, 4, 6)], [(1, 4, 4), (1, 2, 6), (1, 4, 4)]])
def test_tower_matches_reference(grids):
    cfg, jcfg = tiny_glm_config(), jax_tiny()
    params = jax.device_get(jvis.init_glm_vision_params(jcfg.vision, jax.random.PRNGKey(3)))
    state = params_from_jax({"vision": params, "decoder": {"layers": {}}})
    tower = GlmVisionTower(cfg.vision, torch.float32, "cpu")
    tower.load_state_dict({k[len("vision."):]: v for k, v in state.items()})
    n = sum(t * h * w for t, h, w in grids)
    v = cfg.vision
    patches = np.random.default_rng(4).standard_normal(
        (n, v.in_channels * v.temporal_patch_size * v.patch_size ** 2)).astype(np.float32)
    got = tower(torch.from_numpy(patches), grids)
    eager = jvis.glm_vision_forward(params, jcfg.vision, jnp.asarray(patches), grids)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(eager), **F32)
    pad = 24
    cos, sin = jvis.build_rotary_np(grids, jcfg.vision)
    seg = np.concatenate([np.repeat(np.arange(len(grids)), [h * w for _, h, w in grids]), np.full(pad, -1)])
    packed = jvis.glm_vision_forward_packed(
        params, jnp.asarray(np.concatenate([patches, np.zeros((pad, patches.shape[1]), np.float32)])),
        jnp.asarray(np.concatenate([cos, np.ones((pad, cos.shape[1]), np.float32)])),
        jnp.asarray(np.concatenate([sin, np.zeros((pad, sin.shape[1]), np.float32)])),
        jnp.asarray(seg, jnp.int32), cfg=jcfg.vision)[: n // 4]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(packed), **F32)
    got16 = tower(torch.from_numpy(patches).to(torch.bfloat16), grids)
    want16 = jvis.glm_vision_forward(params, jcfg.vision, jnp.asarray(patches, jnp.bfloat16), grids)
    np.testing.assert_allclose(got16.float().detach().numpy(), np.asarray(want16.astype(jnp.float32)),
                               atol=0.05, rtol=0.05)


def _decoder(seed=1):
    cfg, jcfg = tiny_glm_config().text, jax_tiny().text
    params = jax.device_get(jdec.init_glm_text_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    for key in ("q_bias", "k_bias", "v_bias"):
        params["layers"][key] = rng.standard_normal(params["layers"][key].shape).astype(np.float32) * 0.2
    for key in ("post_self_attn_layernorm", "post_mlp_layernorm"):
        params["layers"][key] = 1 + rng.standard_normal(params["layers"][key].shape).astype(np.float32) * 0.1
    state = fuse_glm_params({k[len("decoder."):]: v for k, v in params_from_jax({"decoder": params}).items()})
    decoder = GlmDecoder(cfg, torch.float32, "cpu")
    decoder.load_state_dict(state)
    return params, decoder


def _cache(cfg, batch, length):
    return init_kv_cache(cfg.num_hidden_layers, batch, cfg.num_key_value_heads, length, cfg.head_dim,
                         cfg.head_dim, torch.float32, "cpu")


@pytest.mark.parametrize("flash", [False, True])
def test_decoder_matches_reference(flash):
    params, decoder = _decoder()
    cfg, jcfg = decoder.cfg, jax_tiny().text
    S = 24
    embeds = np.random.default_rng(7).standard_normal((2, S, cfg.hidden_size)).astype(np.float32)
    pos = np.stack([np.arange(S)] * 3)[:, None].repeat(2, 1).astype(np.int32)
    pos[1, 1, 4:10] += 3
    want, _ = jdec.glm_forward(params, jcfg, jnp.asarray(embeds), jnp.asarray(pos),
                               jdec.new_cache(jcfg, 2, S, jnp.float32), full_logits=not flash, flash_prefill=flash)
    got, _ = decoder(torch.from_numpy(embeds), torch.from_numpy(pos).long(), _cache(cfg, 2, S),
                     full_logits=not flash, flash_prefill=flash)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def test_qkv_held_in_f32_with_the_model_dtypes_values():
    """A bf16 engine holds each layer's q/k/v weight and bias in f32 (no
    cast a step) with bf16 values, seeded or loaded from a bf16 state; the
    other projections stay bf16."""
    seeded = GlmOcrEngine(tiny_glm_config(), dtype=torch.bfloat16, device="cpu", max_seq_len=256, seed=3)
    state = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in seeded.model.state_dict().items()}
    loaded = GlmOcrEngine(tiny_glm_config(), dtype=torch.bfloat16, device="cpu", max_seq_len=256, state=state)
    for engine in (seeded, loaded):
        for mine, theirs in zip(engine.model.decoder.layers, seeded.model.decoder.layers, strict=True):
            for name in ("qkv_proj", "qkv_bias"):
                w = getattr(mine, name)
                assert w.dtype == torch.float32 and torch.equal(w, w.to(torch.bfloat16).float())
                assert torch.equal(w, getattr(theirs, name))
            assert mine.o_proj.dtype == torch.bfloat16 and mine.gateup_proj.dtype == torch.bfloat16


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefill_then_steps_equal_full_forward(kv_quant):
    _, decoder = _decoder(seed=5)
    cfg = decoder.cfg
    S, n = 20, 17
    embeds = torch.from_numpy(np.random.default_rng(11).standard_normal((1, S, cfg.hidden_size)).astype(np.float32))
    pos = torch.arange(S)[None, None].expand(3, 1, S) + torch.tensor([0, 2, 5])[:, None, None]
    full, _ = decoder(embeds, pos, _cache(cfg, 1, S), full_logits=True)
    logits, cache = decoder(embeds[:, :n], pos[:, :, :n], _cache(cfg, 1, S), flash_prefill=True)
    np.testing.assert_allclose(logits.numpy(), full[:, n - 1].numpy(), **F32)
    cache = bump_length(cache, n)
    _, k, v = decoder.prefill(embeds[:, :n], pos[:, :, :n])
    slots = alloc_slot_cache(cfg.num_hidden_layers, 2, cfg.num_key_value_heads, 32, cfg.head_dim, cfg.head_dim,
                             torch.float32, kv_quant, "cpu")
    from dsocr_tpu_torch.ops import quantize_kv_int8

    for plane, scales, block in ((slots.k, slots.k_scale, k), (slots.v, slots.v_scale, v)):
        if kv_quant:
            plane[:, 1, :, :n], scales[:, 1, :, :n] = quantize_kv_int8(block[:, 0])
        else:
            plane[:, 1, :, :n] = block[:, 0]
    slots.lengths[1] = n
    tol = F32 if kv_quant is None else dict(atol=0.05, rtol=0.05)
    for i in range(n, S):
        step, cache = decoder(embeds[:, i : i + 1], pos[:, :, i : i + 1], cache)
        cache = bump_length(cache, 1)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(), **F32)
        slot = decoder.slot_step(torch.cat([embeds[:, i : i + 1]] * 2), pos[:, :, i : i + 1].expand(3, 2, 1), slots)
        slots.lengths[1] += 1
        np.testing.assert_allclose(slot[1].numpy(), full[0, i].numpy(), **tol)


# -- engines ----------------------------------------------------------------------------------------


def _serve(engine, requests, max_new=10, params=None):
    jax_side = isinstance(engine, JaxEngine)
    cls, pcls = (JaxScheduler, JaxParams) if jax_side else (ContinuousScheduler, DecodeParameters)

    async def go():
        sched = cls(engine, _Tok(), n_slots=2, max_len=512, chunk_steps=3)
        return await asyncio.gather(*(
            sched.submit(prompt, images, JAX_VISION if jax_side else VISION,
                         pcls(max_new_tokens=max_new, no_repeat_ngram_size=None, **(params or {})))
            for prompt, images in requests), return_exceptions=True)

    return [o if isinstance(o, Exception) else o.generated_tokens for o in asyncio.run(go())]


def _requests(seed=17):
    images = _images(seed, [(60, 70), (60, 70), (90, 40), (40, 120)])
    return [("<image>o0", images[:1]), ("<image> and <image>", images[1:3]), ("<image>o2", images[3:]),
            ("<image>o3", images[:1])]


def test_decode_and_scheduler_tokens_equal_reference(engines):
    jax_engine, port = engines
    requests = _requests()
    assert _serve(port, requests) == _serve(jax_engine, requests)
    for prompt, images in requests[:2]:
        want = jax_engine.decode(_Tok(), prompt, images, JAX_VISION, JaxParams(max_new_tokens=8))
        got = port.decode(_Tok(), prompt, images, VISION, DecodeParameters(max_new_tokens=8))
        assert (got.generated_tokens, got.prompt_tokens) == (want.generated_tokens, want.prompt_tokens)


def test_early_stop_on_each_eos_id(engines):
    """Three EOS ids, each taken from a token the engines would generate:
    both packages stop before it (never emitted), through the scheduler
    and through decode."""
    jax_engine, port = engines
    requests = _requests(19)[:2]
    free = _serve(port, requests, max_new=12)
    tokens = [t for toks in free for j, t in enumerate(toks) if j and t not in toks[:j]]
    for eos in tokens[:3]:
        ids = (eos, 1, 2)
        jax_eos = JaxEngine(dc.replace(jax_tiny(), text=dc.replace(jax_tiny().text, eos_token_ids=ids)),
                            params=jax_engine.params, dtype=jnp.float32, max_seq_len=512)
        port_eos = GlmOcrEngine(dc.replace(tiny_glm_config(), text=dc.replace(tiny_glm_config().text,
                                                                             eos_token_ids=ids)),
                                dtype=torch.float32, device="cpu", max_seq_len=512, state=port.model.state_dict())
        want = _serve(jax_eos, requests, max_new=12)
        assert _serve(port_eos, requests, max_new=12) == want
        assert all(eos not in t for t in want) and want != free
        prompt, images = requests[0]
        a = jax_eos.decode(_Tok(), prompt, images, JAX_VISION, JaxParams(max_new_tokens=12))
        b = port_eos.decode(_Tok(), prompt, images, VISION, DecodeParameters(max_new_tokens=12))
        assert a.generated_tokens == b.generated_tokens


def test_sampling_is_refused_like_reference(engines):
    jax_engine, port = engines
    images = _images(2, [(60, 70)])
    for params in (dict(do_sample=True), dict(temperature=0.7)):
        with pytest.raises(ValueError, match="greedy") as mine:
            port.decode(_Tok(), "<image>", images, VISION, DecodeParameters(**params))
        with pytest.raises(ValueError, match="greedy") as ref:
            jax_engine.decode(_Tok(), "<image>", images, JAX_VISION, JaxParams(**params))
        assert str(mine.value) == str(ref.value)
        with pytest.raises(ValueError, match="greedy"):
            port.validate_slot_params(DecodeParameters(**params))
        got, want = _serve(port, [("<image>", images)], params=params), _serve(jax_engine, [("<image>", images)],
                                                                              params=params)
        assert isinstance(got[0], ValueError) and str(got[0]) == str(want[0])
    port.validate_slot_params(DecodeParameters())


# -- files ----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(engines, tmp_path_factory):
    _, port = engines
    directory = tmp_path_factory.mktemp("glm")
    index, config, _ = chip_smoke.write_checkpoint(torch, port.model.state_dict(), port.cfg, str(directory))
    return index, config


def test_config_json_round_trips(files):
    _, config = files
    assert GlmConfig.from_json(config) == tiny_glm_config()
    assert dc.asdict(GlmConfig.from_json(config)) == dc.asdict(JaxConfig.from_json(config))


def test_loader_matches_reference_loader(engines, files):
    index, _ = files
    got = load_glm_params(index, tiny_glm_config(), dtype=torch.float32, device="cpu")
    want = params_from_jax(jax.device_get(jax_load(index, jax_tiny(), dtype=jnp.float32)))
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    engine = GlmOcrEngine(tiny_glm_config(), dtype=torch.float32, device="cpu", state=got)
    state = engines[1].model.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in engine.model.state_dict().items())


def test_load_engine_tokens_equal_reference(files):
    index, config = files
    port = registry.load_engine(ModelKind.GLM_OCR, config_path=config, weights_path=index, dtype="float32",
                                max_seq_len=512, kv_quant="int8", device="cpu")
    ref = jax_registry.load_engine(JaxKind.GLM_OCR, config_path=config, weights_path=index, dtype="float32",
                                   max_seq_len=512, kv_quant="int8")
    assert isinstance(port, GlmOcrEngine) and port.quantize is None
    requests = _requests(23)[:3]
    assert _serve(port, requests) == _serve(ref, requests)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("family", ["dots", "glm"])
def test_smoke_family_parity_seed_has_no_near_tie(family, kv_quant):
    """chip_smoke.py's parity for DotsOCR and GLM-OCR (FAMILY_PARITY_SEED,
    its requests, settings and slot rows): on the CPU every greedy
    selection, the first tokens from the prefill packets and every decode
    step's rows, has a top-1 logit at least 1e-3 above the next, far beyond
    the card's f32 summation differences, so CUDA and CPU tokens may be
    required equal."""
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
                               n_slots=2, max_len=chip_smoke.FAMILY_PARITY_SLOT_SEQ.get(family, 256), chunk=8)
    assert all(o.generated_tokens for o in outs)
    assert min(gaps) > 1e-3, sorted(gaps)[:5]
