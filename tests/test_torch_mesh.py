"""DeepSeek-OCR under a two-rank mesh (dp=1, mp=2) on the CPU, over gloo
processes, against the reference package on the same weights
(params_from_jax of the reference engine, tiny config, f32): prefill
logits within rtol = atol = 1e-4 and greedy tokens equal.

The ranks are started once for the module (parallel.launch.start) and
every engine of it is built on them; each test re-arms the ranks'
deadline (DEADLINE_S), so a rank that hangs is killed and named instead of
hanging the run. The cases, each with its counterpart in the reference's
tests/test_parallel.py: tensor-parallel decode (:99), flash prefill under
the mesh against the reference's XLA attention (:319), slot serving
through ContinuousScheduler with an f32 and an int8 KV cache (:260,
:417), the same with paged KV (tests/test_paged_slots.py:147, :167),
expert-parallel decode with Q8_0, Q4_K and Q6_K weights (:359, :596),
the vision towers split over the ranks with a padded chunk (:215), and
one OCR2 decode. The world-4 cases are in test_torch_mesh4.py, the
launcher's failure paths, the front ends and the followers' f32 towers
under DSOCR_VISION_F32 (ranks started under the knob) in
test_torch_mesh_launch.py.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu.models.deepseek.ocr2 import tiny_qwen2_encoder_params as jax_tiny_q
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config
from dsocr_tpu_torch.models.deepseek.ocr2 import tiny_qwen2_encoder_params
from dsocr_tpu_torch.parallel import launch
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

DEADLINE_S = 60.0
TOL = dict(rtol=1e-4, atol=1e-4)
BUDGETS = [3, 8, 8]  # the first row leaves early; the third request joins mid-flight
PROMPTS = ["<image>a", "<image>bb longer", "<image>c"]


class Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 127 if token == "<image>" else None


def mesh_cfg(cfg):
    """The tiny config with Q8_0-sized MLPs (every contraction dim % 32):
    4 heads, 4 experts, 128 tokens split over mp 2 and 4 alike."""
    lang = dataclasses.replace(cfg.language, moe_intermediate_size=32, intermediate_size=64)
    return dataclasses.replace(cfg, language=lang)


def kq_cfg(cfg):
    """K-quant super-blocks need in dims % 256 (hidden 256); one dense and
    one MoE layer."""
    lang = dataclasses.replace(cfg.language, hidden_size=256, moe_intermediate_size=32, num_hidden_layers=2)
    return dataclasses.replace(cfg, projector_n_embed=256, language=lang)


def images(seed=3, n=3, size=(60, 60)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(*size, 3), dtype=np.uint8) for _ in range(n)]


def jax_decode(engine, prompt, image, n=6, vision=(64, 64, False)):
    out = engine.decode(Tok(), prompt, [image], JaxVision(*vision),
                        JaxParams(max_new_tokens=n, no_repeat_ngram_size=None))
    return out.generated_tokens


def port_decode(engine, prompt, image, n=6, vision=(64, 64, False)):
    out = engine.decode(Tok(), prompt, [image], VisionSettings(*vision),
                        DecodeParameters(max_new_tokens=n, no_repeat_ngram_size=None))
    return out.generated_tokens


def serve(sched, params_cls, vision, budgets=BUDGETS):
    async def run():
        return await asyncio.gather(*(
            sched.submit(p, [img], vision, params_cls(max_new_tokens=n, no_repeat_ngram_size=None))
            for p, img, n in zip(PROMPTS, images(), budgets)
        ))

    return [o.generated_tokens for o in asyncio.run(run())]


def jax_serve(engine, n_slots=2):
    return serve(JaxScheduler(engine, Tok(), n_slots=n_slots, max_len=256, chunk_steps=2), JaxParams,
                 JaxVision(64, 64, False))


def port_serve(engine, n_slots=2):
    sched = ContinuousScheduler(engine, Tok(), n_slots=n_slots, max_len=256, chunk_steps=2)
    try:
        return serve(sched, DecodeParameters, VisionSettings(64, 64, False))
    finally:
        asyncio.run(sched.close())


def port_on_mesh(jax_engine, cfg, ranks, mesh, **kw):
    state = params_from_jax(jax.device_get(jax_engine.params))
    return DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, state=state,
                             mesh=mesh, ranks=ranks, **kw)


def prefill_logits(engine, vision, prompt="<image>ocr this"):
    pkt = engine.prefill_for_slot(Tok(), prompt, [images(5, 1)[0]], vision)
    return np.asarray(pkt["logits"], np.float32) if not torch.is_tensor(pkt["logits"]) \
        else pkt["logits"].float().numpy()


@pytest.fixture(scope="module")
def ranks():
    ranks = launch.start(2, "cpu", deadline=DEADLINE_S)
    yield ranks
    ranks.close()


@pytest.fixture(autouse=True)
def deadline(ranks):
    ranks.set_deadline(DEADLINE_S)
    yield
    ranks.set_deadline(None)


@pytest.fixture(scope="module")
def jax_engines():
    """The reference's f32 engines on one device: the float one and, from
    its parameters, the int8-KV and Q8_0 ones."""
    base = JaxEngine(mesh_cfg(jax_tiny()), dtype=jnp.float32, max_seq_len=512, seed=3)

    def derived(**kw):
        params = jax.tree_util.tree_map(lambda x: x, base.params)
        return JaxEngine(mesh_cfg(jax_tiny()), params=params, dtype=jnp.float32, max_seq_len=512, **kw)

    return {"f32": base, "int8": derived(kv_quant="int8"), "q8_0": derived(quantize="q8_0")}


@pytest.fixture(scope="module")
def jax_served(jax_engines):
    """The reference scheduler's tokens, f32 and int8 KV, 2 slots."""
    return {kvq: jax_serve(jax_engines["int8" if kvq else "f32"]) for kvq in (None, "int8")}


def test_tp_decode_and_prefill_match_reference(ranks, jax_engines):
    jax_engine = jax_engines["f32"]
    port = port_on_mesh(jax_engine, mesh_cfg(tiny_deepseek_config()), ranks, "dp=1,mp=2")
    assert port.model.decoder.shard.attn_split and port.model.decoder.n_heads == 2
    img = images()[1]
    assert port_decode(port, PROMPTS[1], img) == jax_decode(jax_engine, PROMPTS[1], img)
    np.testing.assert_allclose(prefill_logits(port, VisionSettings(64, 64, False)),
                               prefill_logits(jax_engine, JaxVision(64, 64, False)), **TOL)
    calls = port.mesh_runtime.comm.calls
    assert calls["all_reduce"] > 0 and calls["gather"] > 0 and calls["broadcast"] > 0


def test_flash_prefill_under_mesh_matches_xla_attention(ranks, jax_engines, monkeypatch):
    """The port's mesh prefill runs flash_prefill_attention on each rank's
    heads; the reference engine here attends in plain XLA."""
    monkeypatch.setenv("DSOCR_FLASH_PREFILL", "0")
    params = jax.tree_util.tree_map(lambda x: x, jax_engines["f32"].params)
    xla = JaxEngine(mesh_cfg(jax_tiny()), params=params, dtype=jnp.float32, max_seq_len=512)
    assert not xla._flash_prefill
    monkeypatch.delenv("DSOCR_FLASH_PREFILL")
    port = port_on_mesh(jax_engines["f32"], mesh_cfg(tiny_deepseek_config()), ranks, "dp=1,mp=2")
    assert port._flash_prefill
    for prompt in ("<image>ocr this", "<image>" + "long text " * 20):
        np.testing.assert_allclose(prefill_logits(port, VisionSettings(64, 64, False), prompt),
                                   prefill_logits(xla, JaxVision(64, 64, False), prompt), **TOL)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_slot_serving_matches_reference_scheduler(ranks, jax_engines, jax_served, kv_quant):
    jax_engine = jax_engines["int8" if kv_quant else "f32"]
    port = port_on_mesh(jax_engine, mesh_cfg(tiny_deepseek_config()), ranks, "dp=1,mp=2",
                        kv_quant=kv_quant)
    got = port_serve(port)
    assert [len(t) for t in got] == BUDGETS
    assert got == jax_served[kv_quant]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_serving_matches_reference_scheduler(ranks, jax_engines, jax_served, kv_quant, monkeypatch):
    monkeypatch.setenv("DSOCR_PAGED_KV", "1")
    jax_engine = jax_engines["int8" if kv_quant else "f32"]
    port = port_on_mesh(jax_engine, mesh_cfg(tiny_deepseek_config()), ranks, "dp=1,mp=2",
                        kv_quant=kv_quant)
    sched = ContinuousScheduler(port, Tok(), n_slots=2, max_len=256, chunk_steps=2)
    try:
        got = serve(sched, DecodeParameters, VisionSettings(64, 64, False))
        assert sched._runner.__class__.__name__ == "MeshPagedSlotRunner"
    finally:
        asyncio.run(sched.close())
    assert got == jax_served[kv_quant]


def test_q8_expert_parallel_decode_matches_reference(ranks, jax_engines):
    jax_engine = jax_engines["q8_0"]
    cfg = mesh_cfg(tiny_deepseek_config())
    with pytest.raises(NotImplementedError, match="expert-parallel only"):
        DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", quantize="q8_0", mesh="dp=1,mp=2")
    port = port_on_mesh(jax_engine, cfg, ranks, "dp=1,mp=2,ep", quantize="q8_0")
    shard = port.model.decoder.shard
    assert shard.experts_split == "E" and shard.experts == 2 and not shard.attn_split
    assert port.model.decoder.moe_layers[0].experts_down.codes.shape[0] == 2
    img = images()[1]
    assert port_decode(port, PROMPTS[1], img) == jax_decode(jax_engine, PROMPTS[1], img)
    assert port_serve(port, n_slots=4) == jax_serve(jax_engine, n_slots=4)  # the dense sweep


@pytest.mark.parametrize("method", ["q4_k", "q6_k"])
def test_kquant_expert_parallel_decode_matches_reference(ranks, method, monkeypatch):
    float_engine = kquant_float()
    monkeypatch.setenv("DSOCR_NO_NATIVE", "1")
    jax_engine = JaxEngine(kq_cfg(jax_tiny()), params=jax.tree_util.tree_map(lambda x: x, float_engine.params),
                           dtype=jnp.float32, max_seq_len=512, quantize=method)
    monkeypatch.delenv("DSOCR_NO_NATIVE")
    port = port_on_mesh(jax_engine, kq_cfg(tiny_deepseek_config()), ranks, "dp=1,mp=2,ep", quantize=method)
    assert port.model.decoder.moe_layers[0].experts_gate.codes.shape[0] == 2
    img = images(11, 1)[0]
    assert port_decode(port, "<image>q", img, 4) == jax_decode(jax_engine, "<image>q", img, 4)


_KQ = {}


def kquant_float():
    if "f32" not in _KQ:
        _KQ["f32"] = JaxEngine(kq_cfg(jax_tiny()), dtype=jnp.float32, max_seq_len=512, seed=0)
    return _KQ["f32"]


def test_towers_split_over_ranks_with_a_padded_chunk(ranks, jax_engines):
    jax_engine = jax_engines["f32"]
    port = port_on_mesh(jax_engine, mesh_cfg(tiny_deepseek_config()), ranks, "dp=1,mp=2")
    views = []
    runtime = port.mesh_runtime
    orig = runtime.towers

    def spy(fn, v):
        views.append(len(v))
        return orig(fn, v)

    runtime.towers = spy
    imgs = images(8, 3, (50, 70))
    vision = VisionSettings(64, 64, False)
    got = port._compute_image_embeddings_batched([port.prepare_vision_input(im, vision) for im in imgs])
    assert views == [3]  # one chunk of three views, padded to four over two ranks
    for im, emb in zip(imgs, got):
        want = jax_engine.compute_image_embedding(jax_engine.prepare_vision_input(im, JaxVision(64, 64, False)))
        np.testing.assert_allclose(emb.float().numpy(), np.asarray(want, np.float32), **TOL)


def test_ocr2_decode_under_mp2_matches_reference(ranks):
    ocr2 = lambda cfg: dataclasses.replace(cfg, variant="ocr2", clip=None)  # noqa: E731
    jax_engine = JaxEngine(ocr2(jax_tiny()), dtype=jnp.float32, max_seq_len=512, ocr2_params=jax_tiny_q())
    port = port_on_mesh(jax_engine, ocr2(tiny_deepseek_config()), ranks, "dp=1,mp=2",
                        ocr2_params=tiny_qwen2_encoder_params())
    img = images(4, 1, (300, 200))[0]  # two 128-pixel tiles beside the 256-pixel global view
    vision = (256, 128, True)
    assert port_decode(port, "<image>ocr", img, vision=vision) == jax_decode(jax_engine, "<image>ocr", img,
                                                                             vision=vision)
