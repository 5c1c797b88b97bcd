"""The port's mesh rules (dsocr_tpu_torch/parallel/mesh.py) against the
reference's (dsocr_tpu/parallel/mesh.py), without processes: every leaf of
deepseek_param_shardings (float and ep=True) splits the same dimension
over the same axis, per layer; every cache, scale, row and pool rule gives
the reference's spec at divisible and non-divisible head and slot counts;
the slot-cache fallback warns once. Also the pieces the ranks build on:
parse_mesh_spec, shard_tensor, unfuse_decoder_params (fusion undone
exactly), decoder_shard's local sizes and the logits join."""

import logging

import jax
import numpy as np
import pytest
import torch

from dsocr_tpu import parallel as jpar
from dsocr_tpu.models.deepseek.config import DeepseekV2Config as JaxV2Config
from dsocr_tpu.models.deepseek.decoder import init_deepseek_params
from dsocr_tpu.models.registry import parse_mesh_spec as jax_parse_mesh_spec
from dsocr_tpu_torch.models.deepseek.config import DeepseekV2Config
from dsocr_tpu_torch.models.deepseek.decoder import (
    DeepseekDecoder,
    decoder_shard,
    fuse_decoder_params,
    unfuse_decoder_params,
)
from dsocr_tpu_torch.parallel import mesh as pmesh
from dsocr_tpu_torch.parallel.comm import join_gathered

CFG = dict(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
           num_hidden_layers=3, num_attention_heads=8, n_shared_experts=1, n_routed_experts=4,
           num_experts_per_tok=2, first_k_dense_replace=1, qk_rope_head_dim=None,
           max_position_embeddings=128)
SHAPES = [(1, 2), (2, 2), (1, 4), (2, 4), (4, 2), (1, 8)]


def _norm(spec) -> tuple:
    """A spec without its trailing Nones (P() and (None, None) alike)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.fixture(scope="module")
def jax_params():
    return init_deepseek_params(JaxV2Config(**CFG), jax.random.PRNGKey(0), jax.numpy.float32)


@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("dp, mp", [(1, 8), (2, 4)])
def test_param_shardings_match_every_reference_leaf(jax_params, ep, dp, mp):
    jspecs = jpar.deepseek_param_shardings(jax_params, jpar.make_mesh(dp * mp, dp=dp), ep=ep)
    decoder = DeepseekDecoder(DeepseekV2Config(**CFG), torch.float32, "meta", split=True)
    shapes = {k: tuple(v.shape) for k, v in decoder.state_dict().items()}
    port = pmesh.deepseek_param_shardings(shapes, pmesh.make_mesh(dp * mp, dp=dp), ep=ep)
    seen = set()
    for name, spec in port.items():
        parts = name.split(".")
        if parts[0] in ("dense_layers", "moe_layers"):
            group, _, leaf = parts
            want = tuple(jspecs[group][leaf].spec)[1:]  # the reference's [L, ...] stacks
            seen.add((group, leaf))
        else:
            want = tuple(jspecs[name].spec)
            seen.add(name)
        assert _norm(spec) == _norm(want), name
    reference = {k if not isinstance(v, dict) else None for k, v in jspecs.items()}
    reference |= {(g, leaf) for g in ("dense_layers", "moe_layers") for leaf in jspecs[g]}
    assert reference - {None} == seen


def test_packed_params_split_only_the_routed_experts():
    for name, want in [("moe_layers.0.experts_gate.codes", 0), ("moe_layers.1.experts_down.scales", 0),
                       ("moe_layers.0.q_proj.codes", None), ("lm_head.codes", None),
                       ("embed_tokens", None), ("dense_layers.0.gate_proj", None)]:
        assert pmesh.param_split_dim(name, packed=True) == want, name
    assert pmesh.param_split_dim("decoder.moe_layers.0.experts_up", ep=False) == -1
    assert pmesh.param_split_dim("decoder.moe_layers.0.experts_up", ep=True) == 0


@pytest.mark.parametrize("dp, mp", SHAPES)
@pytest.mark.parametrize("heads", [8, 10, 6, 3])
def test_cache_rules_match(dp, mp, heads):
    jm, pm = jpar.make_mesh(dp * mp, dp=dp), pmesh.make_mesh(dp * mp, dp=dp)
    assert tuple(jpar.cache_sharding(jm, heads).spec) == pmesh.cache_sharding(pm, heads)
    assert tuple(jpar.scale_sharding(jm, heads).spec) == pmesh.scale_sharding(pm, heads)
    assert tuple(jpar.row_cache_sharding(jm, heads).spec) == pmesh.row_cache_sharding(pm, heads)
    for q_heads in (heads, 2 * heads, 5):
        assert tuple(jpar.pool_sharding(jm, heads, q_heads).spec) == pmesh.pool_sharding(pm, heads, q_heads)
        assert (tuple(jpar.pool_scale_sharding(jm, heads, q_heads).spec)
                == pmesh.pool_scale_sharding(pm, heads, q_heads))
    for slots in (8, 4, 3, 1):
        assert (tuple(jpar.slot_cache_sharding(jm, heads, slots).spec)
                == pmesh.slot_cache_sharding(pm, heads, slots))
        assert (tuple(jpar.slot_scale_sharding(jm, heads, slots).spec)
                == pmesh.slot_scale_sharding(pm, heads, slots))


def test_slot_fallback_warns_once(monkeypatch, caplog):
    monkeypatch.setattr(pmesh, "_warned_fallbacks", set())
    mesh = pmesh.make_mesh(4, dp=2)
    with caplog.at_level(logging.WARNING, logger="dsocr.mesh"):
        for _ in range(3):
            assert pmesh.slot_cache_sharding(mesh, 10, 3) == (None, None, "mp", None, None)
            pmesh.slot_scale_sharding(mesh, 10, 3)
    msgs = [r.getMessage() for r in caplog.records if r.name == "dsocr.mesh"]
    assert len(msgs) == 1 and "'dp' (size 2) does not divide n_slots=3" in msgs[0]


@pytest.mark.parametrize("spec", ["dp=1,mp=4,ep", "dp=2,mp=2", "mp=2", "dp=2, mp=4, ep=1"])
def test_parse_mesh_spec_matches(spec):
    jm, ep = jax_parse_mesh_spec(spec)
    pm = pmesh.parse_mesh_spec(spec)
    assert pm.shape == dict(jm.shape) and pm.ep == ep and pm.size == jm.size
    assert pmesh.parse_mesh_spec(None) is None and pmesh.parse_mesh_spec("") is None
    assert pmesh.make_mesh(8, dp=2).shape == dict(jpar.make_mesh(8, dp=2).shape)
    with pytest.raises(ValueError, match="bad mesh spec"):
        pmesh.parse_mesh_spec("tp=2")


def test_shard_tensor_cuts_each_ranks_piece():
    mesh = pmesh.make_mesh(4, dp=2)
    t = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
    pieces = [pmesh.shard_tensor(t, (None, "dp", "mp"), mesh, r) for r in range(4)]
    assert all(p.shape == (2, 2, 3) and p.is_contiguous() for p in pieces)
    whole = torch.cat([torch.cat(pieces[d * 2:(d + 1) * 2], dim=2) for d in range(2)], dim=1)
    assert torch.equal(whole, t)
    assert pmesh.shard_tensor(t, (), mesh, 3) is t
    with pytest.raises(ValueError):
        pmesh.shard_tensor(torch.zeros(3, 4), ("mp",), mesh, 0)


@pytest.mark.parametrize("quantize", [None, "q8_0"])
def test_unfuse_undoes_fusion_exactly(quantize):
    cfg = DeepseekV2Config(**CFG)
    split = DeepseekDecoder(cfg, torch.float32, "cpu", quantize, split=True)
    split.reset_(torch.Generator().manual_seed(1))
    state = split.state_dict()
    fused = fuse_decoder_params(state)
    assert any(k.endswith("qkv_proj") or ".qkv_proj." in k for k in fused)
    back = unfuse_decoder_params(fused, cfg)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)


@pytest.mark.parametrize("heads, ep, packed", [(8, False, False), (10, False, False), (8, True, False),
                                               (8, False, True)])
def test_decoder_shard_sizes(heads, ep, packed):
    cfg = DeepseekV2Config(**{**CFG, "num_attention_heads": heads, "hidden_size": 8 * heads})
    mesh = pmesh.make_mesh(4, dp=1, ep=ep)
    shards = [decoder_shard(cfg, mesh, r, None, packed) for r in range(4)]
    s = shards[3]
    assert s.attn_split == (heads % 4 == 0 and not packed)
    assert s.n_heads == (heads // 4 if s.attn_split else heads)
    assert s.experts_split == ("E" if ep or packed else "I")
    assert s.experts == (1 if ep or packed else 4) and s.expert_offset == (3 if ep or packed else 0)
    assert s.moe_inter == (32 if ep or packed else 8)
    assert s.vocab_split == (not packed) and s.vocab_offset == (384 if not packed else 0)
    assert s.dense_split == s.shared_split == (not packed)


def test_join_gathered_orders_rows_and_vocab():
    mesh = pmesh.make_mesh(4, dp=2)
    whole = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    pieces = [whole[d * 2:(d + 1) * 2, m * 3:(m + 1) * 3] for d in range(2) for m in range(2)]
    assert torch.equal(join_gathered(pieces, mesh, True, True), whole)
    rows = [whole[:2, m * 3:(m + 1) * 3] for _ in range(2) for m in range(2)]
    assert torch.equal(join_gathered(rows, mesh, False, True), whole[:2])
    assert np.array_equal(join_gathered([whole] * 4, mesh, False, False).numpy(), whole.numpy())
