"""DeepSeek-OCR2 in the port against the reference (tiny config, f32, the
same weights through params_from_jax):

- ``ocr2_attention_mask`` equal; the Qwen2 encoder (``Ocr2Encoder``) at
  both query lengths within atol = rtol = 1e-5, and an unsupported length
  raising;
- ``PreprocessParams.ocr2``'s tiles and the flat OCR2 placeholders equal;
- an engine's image embeddings, one image at a time and pooled across a
  wave, within the repo's SAM-path tolerance (1e-4: the SAM stage differs
  by up to ~4e-5 between the packages, the encoder by ~4e-6);
- greedy tokens through ``decode`` and through ``ContinuousScheduler``
  equal to the reference engine's;
- ``load_ocr2_params`` and the router's ``gate_bias`` from a checkpoint
  written here, against the reference loader's tree of the same file, and
  the router with ``aux_bias`` against the reference's;
- the DSQ DeepSeek adapter listing the same linears for OCR2 as the
  reference's (its encoder stays float in both).
"""

import asyncio
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.dsq.adapters import AdapterScope as JaxScope
from dsocr_tpu.dsq.adapters import DeepseekOcrAdapter as JaxAdapter
from dsocr_tpu.image.tiling import PreprocessParams as JaxPreprocess
from dsocr_tpu.image.tiling import dynamic_preprocess as jax_dynamic
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.fusion import build_image_placeholders as jax_placeholders
from dsocr_tpu.models.deepseek.ocr2 import init_ocr2_params, ocr2_encode_view
from dsocr_tpu.models.deepseek.ocr2 import ocr2_attention_mask as jax_mask
from dsocr_tpu.models.deepseek.ocr2 import tiny_qwen2_encoder_params as jax_tiny_q
from dsocr_tpu.ops.moe import MoeConfig as JaxMoeConfig
from dsocr_tpu.ops.moe import moe_router as jax_router
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.dsq.adapters import AdapterScope, DeepseekOcrAdapter
from dsocr_tpu_torch.image import PreprocessParams, dynamic_preprocess
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.models.deepseek.config import DeepseekOcrConfig
from dsocr_tpu_torch.models.deepseek.fusion import build_image_placeholders
from dsocr_tpu_torch.models.deepseek.loader import load_deepseek_params
from dsocr_tpu_torch.models.deepseek.ocr2 import Ocr2Encoder, ocr2_attention_mask, tiny_qwen2_encoder_params
from dsocr_tpu_torch.ops.moe import MoeConfig, moe_router
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

F32 = dict(atol=1e-5, rtol=1e-5)
TOWER = dict(atol=1e-4, rtol=1e-4)
VISION = ((VisionSettings(256, 128, True), JaxVision(256, 128, True)),
          (VisionSettings(128, 128, False), JaxVision(128, 128, False)))


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


def _ocr2(cfg):
    return dc.replace(cfg, variant="ocr2", clip=None)


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxEngine(_ocr2(jax_tiny()), dtype=jnp.float32, max_seq_len=512, ocr2_params=jax_tiny_q())
    state = params_from_jax(jax.device_get(jax_engine.params))
    port = DeepseekOcrEngine(_ocr2(tiny_deepseek_config()), dtype=torch.float32, device="cpu", max_seq_len=512,
                             state=state, ocr2_params=tiny_qwen2_encoder_params())
    return jax_engine, port


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


@pytest.mark.parametrize("seq", [1, 2, 4, 16, 144])
def test_ocr2_attention_mask_equals_reference(seq):
    assert torch.equal(ocr2_attention_mask(seq), torch.from_numpy(np.array(jax_mask(seq))))


@pytest.mark.parametrize("grid", [2, 4])
def test_ocr2_encoder_matches_reference(grid):
    """Both query lengths (4 and 16 at the tiny widths), with nonzero qkv
    biases, and an unsupported length raising."""
    p = jax_tiny_q()
    params = jax.device_get(init_ocr2_params(p, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(grid)
    for key in ("q_bias", "k_bias", "v_bias"):
        params["layers"][key] = rng.standard_normal(params["layers"][key].shape).astype(np.float32) * 0.1
    encoder = Ocr2Encoder(tiny_qwen2_encoder_params(), torch.float32, "cpu")
    state = params_from_jax({"ocr2": params, "decoder": {}})
    encoder.load_state_dict({k[len("ocr2."):]: v for k, v in state.items()})
    sam = rng.standard_normal((2, p.hidden_size, grid, grid)).astype(np.float32)
    want = np.asarray(ocr2_encode_view(params, p, jnp.asarray(sam)))
    got = encoder(torch.from_numpy(sam))
    assert got.shape == (2, grid * grid, p.projector_out)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    with pytest.raises(ValueError, match="unsupported Qwen2 query length 9"):
        encoder(torch.zeros(1, p.hidden_size, 3, 3))


@pytest.mark.parametrize("size", [(300, 500), (1000, 200), (100, 900), (640, 640), (90, 120)])
def test_ocr2_tiling_and_placeholders_equal(size):
    assert dc.asdict(PreprocessParams.ocr2(1024, 768)) == dc.asdict(JaxPreprocess.ocr2(1024, 768))
    image = _images(sum(size), [size])[0]
    got = dynamic_preprocess(image, PreprocessParams.ocr2(1024, 256))
    want = jax_dynamic(image, JaxPreprocess.ocr2(1024, 256), use_thumbnail=False)
    assert got.ratio == want.ratio and len(got.tiles) == len(want.tiles) <= 6
    assert all(np.array_equal(a, b) for a, b in zip(got.tiles, want.tiles))
    for variant in ("ocr1", "ocr2"):
        for crop in (True, False):
            args = (5, got.ratio, 1024, 768, crop)
            assert build_image_placeholders(*args, variant) == jax_placeholders(*args, variant)


@pytest.mark.parametrize("vision", VISION, ids=["crop", "flat"])
def test_ocr2_embeddings_match_reference(engines, vision):
    """compute_image_embedding of each image and the pooled wave against
    the reference's (the wave mixes grids, crop tiles pool by shape)."""
    jax_engine, port = engines
    images = _images(13, [(300, 500), (100, 100), (128, 70), (700, 300)])
    port_vins = [port.prepare_vision_input(img, vision[0]) for img in images]
    jax_vins = [jax_engine.prepare_vision_input(img, vision[1]) for img in images]
    for a, b in zip(port_vins, jax_vins):
        assert np.array_equal(a.global_pixels, b.global_pixels) and a.crop_shape == b.crop_shape
        assert (a.patches is None) == (b.patches is None)
    wave = port._compute_image_embeddings_batched(port_vins)
    jax_wave = jax_engine._compute_image_embeddings_batched(jax_vins)
    for vin, jvin, got, want in zip(port_vins, jax_vins, wave, jax_wave):
        single = port.compute_image_embedding(vin)
        np.testing.assert_allclose(single.numpy(), np.asarray(jax_engine.compute_image_embedding(jvin)), **TOWER)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER)
        np.testing.assert_allclose(got.numpy(), single.numpy(), **F32)


@pytest.mark.parametrize("vision", VISION, ids=["crop", "flat"])
def test_ocr2_decode_tokens_equal_reference(engines, vision):
    jax_engine, port = engines
    image = _images(21, [(300, 500)])[0]
    for n in (3, 12):
        want = jax_engine.decode(_Tok(), "<image>ocr", [image], vision[1],
                                 JaxParams(max_new_tokens=n, no_repeat_ngram_size=None))
        got = port.decode(_Tok(), "<image>ocr", [image], vision[0],
                          DecodeParameters(max_new_tokens=n, no_repeat_ngram_size=None))
        assert got.generated_tokens == want.generated_tokens
        assert got.prompt_tokens == want.prompt_tokens


def test_ocr2_scheduler_tokens_equal_reference(engines):
    """Three requests over two slots, a crop-mode page among flat ones."""
    jax_engine, port = engines
    images = _images(14, [(100, 100), (300, 500), (90, 140)])
    settings = [VISION[1], VISION[0], VISION[1]]

    async def go(sched, params_cls, which):
        return await asyncio.gather(*(
            sched.submit(f"<image>o{i}", [im], vis[which], params_cls(max_new_tokens=6, no_repeat_ngram_size=None))
            for i, (im, vis) in enumerate(zip(images, settings))))

    want = asyncio.run(go(JaxScheduler(jax_engine, _Tok(), n_slots=2, max_len=256, chunk_steps=2), JaxParams, 1))
    got = asyncio.run(go(ContinuousScheduler(port, _Tok(), n_slots=2, max_len=256, chunk_steps=2),
                         DecodeParameters, 0))
    assert [o.generated_tokens for o in got] == [o.generated_tokens for o in want]


def test_router_aux_bias_matches_reference():
    rng = np.random.default_rng(5)
    tokens = rng.standard_normal((7, 32)).astype(np.float32)
    gate = rng.standard_normal((16, 32)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    for scoring, norm in (("softmax", False), ("sigmoid", True)):
        w, i = moe_router(torch.from_numpy(tokens), torch.from_numpy(gate), MoeConfig(16, 4, scoring, norm),
                          aux_bias=torch.from_numpy(bias))
        jw, ji = jax_router(jnp.asarray(tokens), jnp.asarray(gate), JaxMoeConfig(16, 4, scoring, norm),
                            aux_bias=jnp.asarray(bias))
        assert np.array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **F32)


@pytest.fixture(scope="module")
def checkpoint(engines, tmp_path_factory):
    """The port engine's state with a router bias on every MoE layer,
    written under the published names (chip_smoke's writer)."""
    _, port = engines
    state = dict(port.model.state_dict())
    n_moe = len(port.model.decoder.moe_layers)
    rng = np.random.default_rng(8)
    for j in range(n_moe):
        state[f"decoder.moe_layers.{j}.gate_bias"] = torch.from_numpy(
            rng.standard_normal(port.cfg.language.n_routed_experts).astype(np.float32))
    directory = tmp_path_factory.mktemp("ocr2")
    index, _, _ = chip_smoke.write_checkpoint(torch, state, port.cfg, str(directory),
                                              ocr2=tiny_qwen2_encoder_params())
    return state, index


def test_ocr2_loader_matches_reference_loader(checkpoint):
    """load_deepseek_params of an OCR2 checkpoint (encoder, SAM, decoder
    with the routers' e_score_correction_bias) equals params_from_jax of
    the reference loader's functions on the same file, and the state the
    checkpoint was written from."""
    from dsocr_tpu.models.deepseek import loader as jax_loader
    from dsocr_tpu.utils.safetensors_io import CheckpointReader as JaxReader

    state, index = checkpoint
    cfg = _ocr2(tiny_deepseek_config())
    got = load_deepseek_params(index, cfg, dtype=torch.float32, device="cpu", ocr2=tiny_qwen2_encoder_params())
    reader = JaxReader(index)
    jcfg = _ocr2(jax_tiny())
    tree = {"sam": jax_loader.load_sam_params(reader, jcfg, jnp.float32),
            "ocr2": jax_loader.load_ocr2_params(reader, jax_tiny_q(), jnp.float32),
            "decoder": jax_loader.load_decoder_params(reader, jcfg, jnp.float32)}
    want = params_from_jax(jax.device_get(tree))
    assert "decoder.moe_layers.0.gate_bias" in want
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    engine = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, state=got,
                               ocr2_params=tiny_qwen2_encoder_params())
    for key, value in engine.model.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_ocr2_router_bias_serves_like_reference(checkpoint):
    """An engine with router biases from the checkpoint gives the reference
    engine's greedy tokens on the same tree (its gate_bias reaches the
    router in both)."""
    from dsocr_tpu.models.deepseek import loader as jax_loader
    from dsocr_tpu.utils.safetensors_io import CheckpointReader as JaxReader

    _, index = checkpoint
    reader = JaxReader(index)
    jcfg = _ocr2(jax_tiny())
    params = {"sam": jax_loader.load_sam_params(reader, jcfg, jnp.float32),
              "ocr2": jax_loader.load_ocr2_params(reader, jax_tiny_q(), jnp.float32),
              "decoder": jax_loader.load_decoder_params(reader, jcfg, jnp.float32)}
    jax_engine = JaxEngine(jcfg, params=params, dtype=jnp.float32, max_seq_len=512, ocr2_params=jax_tiny_q())
    cfg = _ocr2(tiny_deepseek_config())
    port = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512,
                             state=load_deepseek_params(index, cfg, dtype=torch.float32, device="cpu",
                                                        ocr2=tiny_qwen2_encoder_params()),
                             ocr2_params=tiny_qwen2_encoder_params())
    assert hasattr(port.model.decoder.moe_layers[0], "gate_bias")
    image = _images(30, [(300, 500)])[0]
    want = jax_engine.decode(_Tok(), "<image>ocr", [image], VISION[0][1],
                             JaxParams(max_new_tokens=10, no_repeat_ngram_size=None))
    got = port.decode(_Tok(), "<image>ocr", [image], VISION[0][0],
                      DecodeParameters(max_new_tokens=10, no_repeat_ngram_size=None))
    assert got.generated_tokens == want.generated_tokens


def test_dsq_adapter_lists_the_reference_linears_for_ocr2():
    config = chip_smoke.config_json(_ocr2(DeepseekOcrConfig(clip=None)))
    assert DeepseekOcrConfig.from_dict(config).variant == "ocr2"
    for scope, jscope in ((AdapterScope.TEXT, JaxScope.TEXT),
                          (AdapterScope.TEXT_AND_PROJECTOR, JaxScope.TEXT_AND_PROJECTOR)):
        got = [dc.astuple(s) for s in DeepseekOcrAdapter().discover(config, scope)]
        want = [dc.astuple(s) for s in JaxAdapter().discover(config, jscope)]
        assert got == want
        assert not any("qwen2" in name for name, _, _ in got)
