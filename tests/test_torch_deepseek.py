"""The port's DeepSeek-OCR v1 modules against the reference engine
(tiny config, f32) on the same weights, loaded through params_from_jax:
SAM (plain and global-attention-kernel paths), CLIP, projector and token
assembly, the prompt layout, decoder prefill and one slot decode step.
Tolerance atol = rtol = 1e-4. Also the position-embedding resize
against jax.image.resize at the main path's two sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters, VisionSettings
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.clip import clip_forward
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.fusion import build_clip_sam_tokens, project
from dsocr_tpu.models.deepseek.sam import sam_forward
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.models.deepseek import sam as torch_sam
from dsocr_tpu_torch.ops.resize import resize_grid

TOL = dict(atol=1e-4, rtol=1e-4)


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512)
    state = params_from_jax(jax.device_get(jax_engine.params))
    port = DeepseekOcrEngine(
        tiny_deepseek_config(), dtype=torch.float32, device="cpu", max_seq_len=512, state=state
    )
    return jax_engine, port


def _image(seed, h=60, w=60):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pixels(vin):
    return (np.asarray(vin.global_pixels).astype(np.float32) / 255.0 - 0.5) / 0.5


def test_params_from_jax_covers_every_parameter(engines):
    _, port = engines
    state = params_from_jax(jax.device_get(engines[0].params))
    assert set(state) == set(port.model.state_dict())


def test_unfused_decoder_tree_is_fused_like_the_reference(engines):
    """params_from_jax keeps a split tree split; the port's state fuser (what
    the engine applies at init) gives the reference's fused tree."""
    from dsocr_tpu.models.deepseek.decoder import fuse_decoder_params, init_deepseek_params
    from dsocr_tpu_torch.models.deepseek.decoder import fuse_decoder_params as fuse_state

    tree = dict(jax.device_get(engines[0].params))
    unfused = init_deepseek_params(engines[0].cfg.language, jax.random.PRNGKey(5), jnp.float32)
    unfused = jax.device_get(unfused)
    split = params_from_jax(dict(tree, decoder=unfused))
    assert "decoder.moe_layers.0.experts_gate" in split and "decoder.dense_layers.0.q_proj" in split
    got = fuse_state(split)
    want = params_from_jax(dict(tree, decoder=jax.device_get(fuse_decoder_params(unfused))))
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("kernel_path", [False, True])
def test_towers_and_projector_match(engines, kernel_path, monkeypatch):
    """kernel_path routes the global SAM block through sam_flash_attention
    (its twin on the CPU) as S >= 1024 does at full size."""
    jax_engine, port = engines
    if kernel_path:
        monkeypatch.setattr(torch_sam, "FLASH_MIN_S", 1)
    vin = jax_engine.prepare_vision_input(_image(1), VisionSettings(64, 64, False))
    pixels = _pixels(vin)
    params = jax_engine.params
    sam_j = sam_forward(params["sam"], jax_engine.cfg.sam, jnp.asarray(pixels))
    clip_j = clip_forward(params["clip"], jax_engine.cfg.clip, sam_j)
    proj_j = project(params["projector"], build_clip_sam_tokens(clip_j, sam_j))
    with torch.no_grad():
        sam_t = port.model.sam(torch.from_numpy(pixels))
        clip_t = port.model.clip(sam_t)
        proj_t = port._tower(np.asarray(vin.global_pixels))
    np.testing.assert_allclose(sam_t.numpy(), np.asarray(sam_j), **TOL)
    np.testing.assert_allclose(clip_t.numpy(), np.asarray(clip_j), **TOL)
    np.testing.assert_allclose(proj_t.numpy(), np.asarray(proj_j), **TOL)


@pytest.mark.parametrize("vision,size", [
    (VisionSettings(64, 64, False), (60, 60)),
    (VisionSettings(64, 32, True), (50, 120)),  # crop mode: 2+ tiles plus newlines
])
def test_image_tokens_and_prompt_match(engines, vision, size):
    jax_engine, port = engines
    img = _image(2, *size)
    vin_j = jax_engine.prepare_vision_input(img, vision)
    vin_t = port.prepare_vision_input(img, vision)
    np.testing.assert_array_equal(vin_t.global_pixels, np.asarray(vin_j.global_pixels))
    assert vin_t.crop_shape == vin_j.crop_shape
    if vin_j.patches is not None:
        np.testing.assert_array_equal(vin_t.patches, np.asarray(vin_j.patches))
    emb_j = jax_engine.compute_image_embedding(vin_j)
    emb_t = port.compute_image_embedding(vin_t)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), **TOL)
    tokens_j = jax_engine.build_prompt_tokens(_Tok(), "<image>\nocr", [vin_j], [emb_j], vision)
    tokens_t = port.build_prompt_tokens(_Tok(), "<image>\nocr", [vin_t], [emb_t], vision)
    assert tokens_t == tokens_j


def test_prefill_and_slot_step_match(engines):
    """Prefill logits and K/V rows, then one joined slot decode step."""
    jax_engine, port = engines
    vision = VisionSettings(64, 64, False)
    requests = [("<image>a", [_image(3)], vision), ("<image>\nlonger prompt", [_image(4)], vision)]
    pres_j = jax_engine.prefill_for_slots(_Tok(), requests)
    pres_t = port.prefill_for_slots(_Tok(), requests)
    for pj, pt in zip(pres_j, pres_t):
        assert pt["prompt_ids"] == list(pj["prompt_ids"])
        np.testing.assert_allclose(pt["logits"].numpy(), np.asarray(pj["logits"]), **TOL)
        np.testing.assert_allclose(pt["row_k"].numpy(), np.asarray(pj["row_k"]), **TOL)
        np.testing.assert_allclose(pt["row_v"].numpy(), np.asarray(pj["row_v"]), **TOL)

    params = DecodeParameters(max_new_tokens=4, no_repeat_ngram_size=None)
    runner_j = jax_engine.make_slot_runner()
    state_j = runner_j.init_state(jax_engine.new_slot_cache(2, 256), context_len=256)
    runner_t = port.make_slot_runner()
    state_t = runner_t.init_state(port.new_slot_cache(2, 256), context_len=256)
    firsts = []
    for row, (pj, pt) in enumerate(zip(pres_j, pres_t)):
        state_j, _, first_j = runner_j.join(
            state_j, row, pj["row_k"], pj["row_v"], pj["prompt_ids"], pj["logits"], params, 4,
            pos0=pj["pos0"],
        )
        state_t, _, first_t = runner_t.join(state_t, row, pt, params, 4)
        assert first_t == first_j
        firsts.append(first_t)
    logits_j, _ = jax_engine.slot_step_fn(
        jax_engine.params, jnp.asarray(firsts, jnp.int32), state_j.cache, state_j.pos
    )
    with torch.no_grad():
        logits_t = port.slot_step_fn(port.params, torch.tensor(firsts), state_t.cache, state_t.pos)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)


@pytest.mark.parametrize("src,dst,hidden", [(64, 40, 8), (16, 10, 12)])
def test_pos_embed_resize_matches_jax_image_resize(src, dst, hidden):
    """SAM's 64→40 (640 tiles) and CLIP's 16→10 grid resizes."""
    grid = np.random.default_rng(src).normal(size=(1, src, src, hidden)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid), (1, dst, dst, hidden), method="bicubic", antialias=True)
    got = resize_grid(torch.from_numpy(grid), dst, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
