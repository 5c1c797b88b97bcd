"""PaddleOCR-VL, DotsOCR and GLM-OCR under two-rank meshes on the CPU, over
gloo processes, against the reference package on the same weights
(params_from_jax of the reference engine, tiny configs, f32): greedy
tokens through the port's ContinuousScheduler equal the reference
scheduler's and the port's single-process engine's.

The counterparts of the reference's tests/test_parallel.py:657-850
(Paddle f32 and Q8_0, Dots and GLM, Dots Q8_0 under a dp mesh), each at
dp=2 (slot rows over dp) and, for the float engines, at mp=2 (KV heads
over mp: one KV head and its two query heads a rank). Each rank's slot
cache holds exactly the share that ``slot_cache_sharding`` names; an mp
that does not divide the KV heads replicates them and warns once. Three
requests over two slots, the third joining mid-flight, so a join lands
on the second dp rank's row.

The ranks are started once for the module (parallel.launch.start) and
every engine of it is built on them; each test re-arms the ranks'
deadline (DEADLINE_S). The four-rank GLM case is in test_torch_mesh4.py,
the CLI and the server in test_torch_mesh_launch.py.
"""

import asyncio
import dataclasses as dc
import logging
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsocr_tpu.core import DecodeParameters as JaxParams
from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.dots import DotsOcrEngine as JaxDots
from dsocr_tpu.models.dots.config import tiny_dots_config as jax_tiny_dots
from dsocr_tpu.models.glm import GlmOcrEngine as JaxGlm
from dsocr_tpu.models.glm.config import tiny_glm_config as jax_tiny_glm
from dsocr_tpu.models.paddleocr import PaddleOcrEngine as JaxPaddle
from dsocr_tpu.models.paddleocr.config import tiny_paddle_config as jax_tiny_paddle
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.models import dots, glm, paddleocr
from dsocr_tpu_torch.parallel import launch
from dsocr_tpu_torch.parallel import mesh as mesh_rules
from dsocr_tpu_torch.parallel.mesh import parse_mesh_spec, shard_tensor, slot_cache_sharding
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

DEADLINE_S = 60.0
BUDGETS = [3, 6, 6]  # the first row leaves early; the third request joins mid-flight
VISION, JAX_VISION = VisionSettings(64, 64, False), JaxVision(64, 64, False)


class Tok:
    def encode(self, text):
        return [ord(c) % 100 + 3 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def token_to_id(self, token):
        return 252 if token == "<|IMAGE_END|>" else None


class Family(NamedTuple):
    port: Callable[..., Any]
    port_cfg: Callable[[], Any]
    params_from_jax: Callable[[Any], Any]
    jax: Callable[..., Any]
    jax_cfg: Callable[[], Any]
    max_len: int  # slot rows (Dots' smart-resize floor makes a 60 × 70 page ~200 tokens)


FAMILIES = {
    "paddle": Family(paddleocr.PaddleOcrEngine, paddleocr.tiny_paddle_config, paddleocr.params_from_jax, JaxPaddle,
                     jax_tiny_paddle, 256),
    "dots": Family(dots.DotsOcrEngine, dots.tiny_dots_config, dots.params_from_jax, JaxDots, jax_tiny_dots, 1024),
    "glm": Family(glm.GlmOcrEngine, glm.tiny_glm_config, glm.params_from_jax, JaxGlm, jax_tiny_glm, 512),
}


def images(seed=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in [(60, 70), (90, 40), (60, 70)]]


def serve(engine, max_len, n_slots=2):
    """Three requests through the engine's scheduler → their tokens."""
    jax_side = not isinstance(engine, tuple(f.port for f in FAMILIES.values()))
    cls, pcls, vision = (JaxScheduler, JaxParams, JAX_VISION) if jax_side else \
        (ContinuousScheduler, DecodeParameters, VISION)

    async def go():
        sched = cls(engine, Tok(), n_slots=n_slots, max_len=max_len, chunk_steps=2)
        try:
            return await asyncio.gather(*(
                sched.submit(f"<image>o{i}", [img], vision, pcls(max_new_tokens=n, no_repeat_ngram_size=None))
                for i, (img, n) in enumerate(zip(images(), BUDGETS))))
        finally:
            if not jax_side:
                await sched.close()

    return [o.generated_tokens for o in asyncio.run(go())]


_REFS = {}


def reference(family: str, quantize=None):
    """(the reference's float parameters, its scheduler's tokens with
    them packed as `quantize` says), once per family and format."""
    key = (family, quantize)
    if key not in _REFS:
        f = FAMILIES[family]
        if quantize is None:
            engine = f.jax(f.jax_cfg(), dtype=jnp.float32, max_seq_len=f.max_len + 512, seed=3)
            tree = jax.device_get(engine.params)
        else:
            tree = reference(family)[0]
            engine = f.jax(f.jax_cfg(), params=jax.tree_util.tree_map(lambda x: x, tree), dtype=jnp.float32,
                           max_seq_len=f.max_len + 512, quantize=quantize)
        _REFS[key] = tree, serve(engine, f.max_len)
    return _REFS[key]


def port(family: str, quantize=None, **kw):
    """The port's engine on the reference's weights (`kw`: mesh, ranks,
    kv_quant)."""
    f = FAMILIES[family]
    state = f.params_from_jax(reference(family)[0])
    extra = dict(quantize=quantize) if quantize else {}
    return f.port(f.port_cfg(), dtype=torch.float32, device="cpu", max_seq_len=f.max_len + 512, state=state,
                  **extra, **kw)


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


def assert_cache_shares(engine, n_slots, max_len):
    """Every rank's slot-cache planes are its shard of the whole cache
    under slot_cache_sharding."""
    cfg = engine.model.decoder.cfg
    mesh = engine.mesh
    nkv = cfg.resolved_num_key_value_heads
    spec = slot_cache_sharding(mesh, nkv, n_slots)
    whole = torch.empty((cfg.num_hidden_layers, n_slots, nkv, max_len, cfg.head_dim), device="meta")
    cache = engine.new_slot_cache(n_slots, max_len)
    shapes = engine.mesh_runtime.cache_shapes(cache)
    assert len(shapes) == mesh.size
    for rank, got in enumerate(shapes):
        want = tuple(shard_tensor(whole, spec, mesh, rank).shape)
        assert got["k"] == want and got["v"] == want
        if engine.kv_quant:
            assert got["k_scale"] == want[:4] and got["v_scale"] == want[:4]
    return spec


CASES = [
    ("paddle", None, "dp=2,mp=1"),
    ("paddle", None, "dp=1,mp=2"),
    ("paddle", "q8_0", "dp=2,mp=1"),
    ("dots", None, "dp=2,mp=1"),
    ("dots", None, "dp=1,mp=2"),
    ("dots", "q8_0", "dp=2,mp=1"),
    ("glm", None, "dp=2,mp=1"),
    ("glm", None, "dp=1,mp=2"),
]


@pytest.mark.parametrize("family,quantize,mesh", CASES)
def test_mesh_serving_matches_reference_and_single_process(ranks, family, quantize, mesh):
    want = reference(family, quantize)[1]
    f = FAMILIES[family]
    single = port(family, quantize)
    assert serve(single, f.max_len) == want
    engine = port(family, quantize, mesh=mesh, ranks=ranks)
    assert assert_cache_shares(engine, 2, f.max_len) == (None, "dp", "mp", None, None)  # each axis divides
    share = engine.mesh_runtime.share
    if mesh.endswith("mp=2"):  # one KV head and its two query heads on rank 0
        assert (share.kv0, share.nkv, share.q0, share.nq) == (0, 1, 0, 2)
    else:
        assert share is None
    if quantize:
        assert engine.quantize == quantize and any(k.endswith(".codes") for k in engine.model.state_dict())
    calls = engine.mesh_runtime.comm.calls
    calls.clear()
    got = serve(engine, f.max_len)
    assert [len(t) for t in got] == BUDGETS
    assert got == want
    assert calls["broadcast"] > 0
    assert calls["all_gather" if mesh.endswith("mp=2") else "gather"] > 0  # heads joined, or rows gathered


def test_int8_cache_shares_heads_and_serves_as_one_process(ranks):
    """int8 KV under mp=2: each rank's codes and scales hold its KV head;
    the tokens equal the single-process int8 engine's."""
    engine = port("paddle", mesh="dp=1,mp=2", ranks=ranks, kv_quant="int8")
    assert_cache_shares(engine, 2, 256)
    assert serve(engine, 256) == serve(port("paddle", kv_quant="int8"), 256)


def test_mp_that_does_not_divide_the_kv_heads_replicates_them(ranks, caplog, monkeypatch):
    """Paddle with one KV head under mp=2: the heads replicate (no share),
    each rank holds the whole cache, the warning is logged once, and the
    tokens are the single process's."""
    monkeypatch.setattr(mesh_rules, "_warned_fallbacks", set())
    cfg = dc.replace(paddleocr.tiny_paddle_config(), num_key_value_heads=1)
    jcfg = dc.replace(jax_tiny_paddle(), num_key_value_heads=1)
    state = paddleocr.params_from_jax(jax.device_get(JaxPaddle(jcfg, dtype=jnp.float32, max_seq_len=768, seed=5).params))
    single = paddleocr.PaddleOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=768, state=state)
    engine = paddleocr.PaddleOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=768, state=state,
                                       mesh="dp=1,mp=2", ranks=ranks)
    assert engine.mesh_runtime.share is None
    with caplog.at_level(logging.WARNING, logger="dsocr.mesh"):
        for _ in range(2):
            engine.new_slot_cache(2, 256)
    warned = [r for r in caplog.records if "does not divide num_kv_heads=1" in r.getMessage()]
    assert len(warned) == 1
    assert assert_cache_shares(engine, 2, 256) == (None, "dp", None, None, None)
    assert serve(engine, 256) == serve(single, 256)


def test_ep_is_ignored_for_a_family_without_experts(ranks, caplog):
    """``ep`` in a dense family's mesh spec means the same mesh without it,
    said in the log; a quantized engine needs no ep."""
    from dsocr_tpu_torch.models.gqa_mesh import dense_mesh

    with caplog.at_level(logging.WARNING, logger="dsocr.mesh"):
        mesh = dense_mesh("dp=2,mp=1,ep", "test-family")
        assert dense_mesh("dp=2,mp=1,ep", "test-family") == mesh
    assert mesh == parse_mesh_spec("dp=2,mp=1") and not mesh.ep
    assert sum("ep is ignored" in r.getMessage() for r in caplog.records) == 1
    engine = port("dots", "q8_0", mesh="dp=2,mp=1,ep", ranks=ranks)
    assert engine.mesh == mesh and engine.mesh_runtime.rows_of(engine.new_slot_cache(2, 64)) == slice(0, 1)


def test_decode_runs_on_rank_zero_alone(ranks):
    """engine.decode under a mesh: rank 0's whole model, no collective,
    the single process's tokens."""
    single = port("glm")
    engine = port("glm", mesh="dp=1,mp=2", ranks=ranks)
    engine.mesh_runtime.comm.calls.clear()
    params = DecodeParameters(max_new_tokens=5, no_repeat_ngram_size=None)
    got = engine.decode(Tok(), "<image>o", images()[:1], VISION, params).generated_tokens
    assert got == single.decode(Tok(), "<image>o", images()[:1], VISION, params).generated_tokens
    assert not engine.mesh_runtime.comm.calls
