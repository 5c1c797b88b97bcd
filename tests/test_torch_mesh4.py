"""DeepSeek-OCR under four-rank meshes on the CPU, over gloo processes,
against the reference engine on one device (tiny configs, f32): prefill
logits within rtol = atol = 1e-4 and greedy tokens equal
(tests/test_torch_mesh.py holds the two-rank cases and the helpers).

Tensor parallelism at mp 4 and at dp 2 × mp 2 (the reference's
tests/test_parallel.py:99), slot serving with the slot rows split over dp
(:260, dp=2), and the reference's multichip dry run
(__graft_entry__.py:68-200: 64 routed experts, top-6, vocab 128·mp, heads
2·mp) served over dp 2 × mp 2, with the experts split over their
intermediate dim and, with ``ep``, over E. GLM-OCR over dp 2 × mp 2: each
rank one slot row and one KV head (tests/test_torch_mesh_dense.py holds
the two-rank dense cases)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dsocr_tpu.core import VisionSettings as JaxVision
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny
from dsocr_tpu_torch.core import VisionSettings
from dsocr_tpu_torch.models.deepseek import tiny_deepseek_config
from dsocr_tpu_torch.parallel import launch
from tests.test_torch_mesh import (
    BUDGETS,
    PROMPTS,
    TOL,
    images,
    jax_decode,
    jax_serve,
    mesh_cfg,
    port_decode,
    port_on_mesh,
    port_serve,
    prefill_logits,
)
from tests.test_torch_mesh_dense import BUDGETS as DENSE_BUDGETS
from tests.test_torch_mesh_dense import FAMILIES, assert_cache_shares, reference
from tests.test_torch_mesh_dense import port as dense_port
from tests.test_torch_mesh_dense import serve as dense_serve

DEADLINE_S = 90.0


def dry_run_cfg(cfg, mp=2):
    """The dry run's decoder (__graft_entry__.py:116-134) behind the tiny
    towers."""
    lang = dataclasses.replace(
        cfg.language, vocab_size=128 * mp, hidden_size=64, intermediate_size=32 * mp,
        moe_intermediate_size=8 * mp, num_hidden_layers=3, num_attention_heads=2 * mp, n_shared_experts=1,
        n_routed_experts=64, num_experts_per_tok=6, first_k_dense_replace=1, qk_rope_head_dim=None)
    return dataclasses.replace(cfg, projector_n_embed=64, language=lang)


@pytest.fixture(scope="module")
def ranks():
    ranks = launch.start(4, "cpu", deadline=DEADLINE_S)
    yield ranks
    ranks.close()


@pytest.fixture(autouse=True)
def deadline(ranks):
    ranks.set_deadline(DEADLINE_S)
    yield
    ranks.set_deadline(None)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(mesh_cfg(jax_tiny()), dtype=jnp.float32, max_seq_len=512, seed=3)


@pytest.mark.parametrize("mesh", ["dp=1,mp=4", "dp=2,mp=2"])
def test_tp_decode_matches_reference(ranks, jax_engine, mesh):
    port = port_on_mesh(jax_engine, mesh_cfg(tiny_deepseek_config()), ranks, mesh)
    mp = 4 if mesh.endswith("4") else 2
    assert port.model.decoder.n_heads == 4 // mp and port.model.decoder.embed_tokens.shape[0] == 128 // mp
    for prompt, img in zip(PROMPTS[:2], images()):
        assert port_decode(port, prompt, img) == jax_decode(jax_engine, prompt, img)
    np.testing.assert_allclose(prefill_logits(port, VisionSettings(64, 64, False)),
                               prefill_logits(jax_engine, JaxVision(64, 64, False)), **TOL)


def test_slot_rows_split_over_dp(ranks, jax_engine):
    port = port_on_mesh(jax_engine, mesh_cfg(tiny_deepseek_config()), ranks, "dp=2,mp=2")
    cache = port.new_slot_cache(2, 256)
    assert cache.rows_split and cache.k.shape[1] == 1 and cache.n_slots == 2 and cache.k.shape[2] == 2
    got = port_serve(port)
    assert [len(t) for t in got] == BUDGETS
    assert got == jax_serve(jax_engine)


@pytest.mark.parametrize("mesh", ["dp=2,mp=2", "dp=2,mp=2,ep"])
def test_dry_run_64_experts_top6(ranks, mesh):
    jax_ref = JaxEngine(dry_run_cfg(jax_tiny()), dtype=jnp.float32, max_seq_len=512, seed=0)
    port = port_on_mesh(jax_ref, dry_run_cfg(tiny_deepseek_config()), ranks, mesh)
    shard = port.model.decoder.shard
    layer = port.model.decoder.moe_layers[0]
    if mesh.endswith("ep"):
        assert shard.experts_split == "E" and layer.experts_gate.shape == (32, 64, 16)
    else:
        assert shard.experts_split == "I" and layer.experts_gate.shape == (64, 64, 8)
    img = images(2, 1)[0]
    assert port_decode(port, "<image>q", img, 5) == jax_decode(jax_ref, "<image>q", img, 5)
    np.testing.assert_allclose(prefill_logits(port, VisionSettings(64, 64, False)),
                               prefill_logits(jax_ref, JaxVision(64, 64, False)), **TOL)


def test_glm_rows_over_dp_heads_over_mp(ranks):
    """GLM at dp=2,mp=2: rank (d, m) holds slot row d and KV head m, its
    attention outputs gathered over its dp row's mp group; the tokens are
    the reference scheduler's."""
    engine = dense_port("glm", mesh="dp=2,mp=2", ranks=ranks)
    max_len = FAMILIES["glm"].max_len
    assert assert_cache_shares(engine, 2, max_len) == (None, "dp", "mp", None, None)
    share = engine.mesh_runtime.share
    assert (share.kv0, share.nkv, share.q0, share.nq) == (0, 1, 0, 2)
    got = dense_serve(engine, max_len)
    assert [len(t) for t in got] == DENSE_BUDGETS
    assert got == reference("glm")[1]
