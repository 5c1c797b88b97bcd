"""DotsOCR in the port against the reference (the same weights through
params_from_jax; the tiny config's decoder has 4 query heads over 2 KV
heads, and a packed variant at hidden 256 so that Q8_0 and the K-quants
pack):

- ``SequenceLayout``, ``build_2d_rope_np``, prompt tokens and the DSQ
  adapter's specs: exact;
- the DotsVision tower against the reference's eager path and its
  default jitted packed path, in f32 (atol = rtol = 1e-5) and with the
  reference's dtypes (f32 weights, bf16 activations) within bf16's
  tolerance;
- the Qwen2 decoder (fused and split, plain attention and the flash
  prefill) in f32 within 1e-5; prefill then steps through the contiguous
  and the slot cache equal to the full forward;
- packed trees bit-equal to the reference's ``quantize_qwen2_params``,
  and the packed engines' prefill logits (1e-2: bf16 activations) and tokens equal to the
  reference's, for Q8_0, Q4_K and Q6_K;
- greedy tokens through ``decode`` and through ``ContinuousScheduler``,
  a request with two images among them, and an EOS appended before the
  row stops;
- ``load_dots_params`` and a Q8_0 snapshot from the port's exporter
  against the reference loader and exporter on the same files, and
  ``load_engine`` on the CPU.
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
from dsocr_tpu.dsq import adapters as jax_adapters
from dsocr_tpu.dsq import cli as jax_cli
from dsocr_tpu.models import registry as jax_registry
from dsocr_tpu.models.dots import DotsOcrEngine as JaxEngine
from dsocr_tpu.models.dots.config import DotsConfig as JaxConfig
from dsocr_tpu.models.dots.config import tiny_dots_config as jax_tiny
from dsocr_tpu.models.dots.loader import load_dots_params as jax_load
from dsocr_tpu.models.dots.quantize import quantize_qwen2_params as jax_quantize
from dsocr_tpu.server.scheduler import ContinuousScheduler as JaxScheduler
from dsocr_tpu_torch.core import DecodeParameters, VisionSettings
from dsocr_tpu_torch.core.engine import ModelKind
from dsocr_tpu_torch.dsq import adapters, cli
from dsocr_tpu_torch.models import registry
from dsocr_tpu_torch.models.dots import DotsConfig, DotsOcrEngine, params_from_jax, tiny_dots_config
from dsocr_tpu_torch.models.dots.decoder import Qwen2Decoder, fuse_qwen2_params, qwen2_cos_sin
from dsocr_tpu_torch.models.dots.loader import load_dots_params
from dsocr_tpu_torch.models.dots.quantize import quantize_qwen2_params
from dsocr_tpu_torch.models.dots.vision import DotsVisionTower, SequenceLayout, build_2d_rope_np
from dsocr_tpu_torch.ops.rope import build_rope_tables
from dsocr_tpu_torch.runtime.kv_cache import bump_length, init_kv_cache
from dsocr_tpu_torch.runtime.slots import alloc_slot_cache
from dsocr_tpu_torch.server.scheduler import ContinuousScheduler

jdec = importlib.import_module("dsocr_tpu.models.dots.decoder")
jvis = importlib.import_module("dsocr_tpu.models.dots.vision")

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


def _wide(cfg):
    """The tiny config at hidden 256 (intermediate 512, 4 heads of 64
    over 2): in dims the K-quants pack."""
    return dc.replace(cfg, text=dc.replace(cfg.text, hidden_size=256, intermediate_size=512),
                      vision=dc.replace(cfg.vision, hidden_size=256))


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=1024)
    state = params_from_jax(jax.device_get(jax_engine.params))
    return jax_engine, DotsOcrEngine(tiny_dots_config(), dtype=torch.float32, device="cpu", max_seq_len=1024,
                                     state=state)


# -- modules --------------------------------------------------------------------------------


@pytest.mark.parametrize("grids", [[(1, 4, 6)], [(1, 2, 2), (1, 2, 4)], [(2, 4, 4), (1, 6, 2)]])
def test_layout_and_rotary_equal_reference(grids):
    got, want = SequenceLayout.from_grid(grids, 2), jvis.SequenceLayout.from_grid(grids, 2)
    assert (got.frames, got.total_tokens, got.merge_groups, got.uniform_frame_len) == \
        (want.frames, want.total_tokens, want.merge_groups, want.uniform_frame_len)
    assert got.positions.dtype == want.positions.dtype and np.array_equal(got.positions, want.positions)
    assert np.array_equal(got.segment_ids, np.repeat(np.arange(len(want.frames)), [n for _, n in want.frames]))
    for head_dim in (8, 128):
        for a, b in zip(build_2d_rope_np(got.positions, head_dim), jvis.build_2d_rope_np(want.positions, head_dim)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        SequenceLayout.from_grid([(1, 3, 4)], 2)


def test_qwen2_rotary_equals_reference_table():
    pos = torch.tensor([[0, 5, 4095, 131071], [7, 7, 1, 2]])
    cos, sin = qwen2_cos_sin(pos, 128, 1e6)
    tc, ts = build_rope_tables(131072, 128, 1e6)
    assert torch.equal(cos, tc[pos]) and torch.equal(sin, ts[pos])
    # XLA's f32 cos/sin and torch's differ by an ulp on some angles
    jc, js = jdec.build_qwen2_rope(JaxConfig().text, 4096)
    np.testing.assert_allclose(cos[1].numpy(), np.asarray(jc)[pos[1].numpy()], atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin[1].numpy(), np.asarray(js)[pos[1].numpy()], atol=1e-6, rtol=0)


def _tower_pair(cfg, jcfg, seed=2):
    params = jax.device_get(jvis.init_dots_vision_params(jcfg.vision, jax.random.PRNGKey(seed)))
    params["merger"]["mlp_in"]["b"] = np.random.default_rng(seed).standard_normal(
        params["merger"]["mlp_in"]["b"].shape).astype(np.float32) * 0.1  # a bias that adds something
    state = params_from_jax({"vision": params, "decoder": {"layers": {}}})
    tower = DotsVisionTower(cfg.vision, torch.float32, "cpu")
    tower.load_state_dict({k[len("vision."):]: v for k, v in state.items()})
    return params, tower


@pytest.mark.parametrize("grids", [[(1, 4, 6)], [(1, 4, 4), (1, 6, 2), (1, 4, 4)]])
def test_tower_matches_reference(grids):
    """Eager and packed (the reference's serving path, padded to a bucket
    with -1 segments) in f32; bf16 patches through f32 weights, the
    reference's serving dtypes, within bf16's tolerance."""
    cfg, jcfg = tiny_dots_config(), jax_tiny()
    params, tower = _tower_pair(cfg, jcfg)
    v = cfg.vision
    layout, jlayout = SequenceLayout.from_grid(grids, 2), jvis.SequenceLayout.from_grid(grids, 2)
    n = layout.total_tokens
    patches = np.random.default_rng(5).standard_normal((n, 3, v.patch_size, v.patch_size)).astype(np.float32)
    got = tower(torch.from_numpy(patches), layout)
    eager = jvis.dots_vision_forward(params, jcfg.vision, jnp.asarray(patches), jlayout)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(eager), **F32)
    pad = 32
    cos, sin = jvis.build_2d_rope_np(jlayout.positions, v.head_dim)
    seg = np.concatenate([np.repeat(np.arange(len(grids)), [n for _, n in jlayout.frames]), np.full(pad, -1)])
    packed = jvis.dots_vision_forward_packed(
        params, jnp.asarray(np.concatenate([patches, np.zeros((pad, *patches.shape[1:]), np.float32)])),
        jnp.asarray(np.concatenate([cos, np.ones((pad, cos.shape[1]), np.float32)])),
        jnp.asarray(np.concatenate([sin, np.zeros((pad, sin.shape[1]), np.float32)])),
        jnp.asarray(seg, jnp.int32), cfg=jcfg.vision)[: layout.merge_groups]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(packed), **F32)
    got16 = tower(torch.from_numpy(patches).to(torch.bfloat16), layout)
    want16 = jvis.dots_vision_forward(params, jcfg.vision, jnp.asarray(patches, jnp.bfloat16), jlayout)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().detach().numpy(), np.asarray(want16.astype(jnp.float32)),
                               atol=0.05, rtol=0.05)


def _decoder_pair(fused, seed=1):
    cfg, jcfg = tiny_dots_config().text, jax_tiny().text
    params = jax.device_get(jdec.init_qwen2_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    for key in ("q_bias", "k_bias", "v_bias"):  # biases that add something
        params["layers"][key] = rng.standard_normal(params["layers"][key].shape).astype(np.float32) * 0.2
    if fused:
        params = jax.device_get(jdec.fuse_qwen2_params(params))
    state = {k[len("decoder."):]: v for k, v in params_from_jax({"decoder": params}).items()}
    decoder = Qwen2Decoder(cfg, torch.float32, "cpu", split=not fused)
    decoder.load_state_dict(state)
    return params, decoder


def _cache(cfg, batch, length):
    return init_kv_cache(cfg.num_hidden_layers, batch, cfg.num_key_value_heads, length, cfg.head_dim,
                         cfg.head_dim, torch.float32, "cpu")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("flash", [False, True])
def test_qwen2_forward_matches_reference(fused, flash):
    params, decoder = _decoder_pair(fused)
    cfg, jcfg = decoder.cfg, jax_tiny().text
    S = 24
    embeds = np.random.default_rng(7).standard_normal((2, S, cfg.hidden_size)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want, _ = jdec.qwen2_forward(params, jcfg, jnp.asarray(embeds), jnp.asarray(pos),
                                 jdec.new_cache(jcfg, 2, S, jnp.float32), jdec.build_qwen2_rope(jcfg, 64),
                                 full_logits=not flash, flash_prefill=flash)
    got, _ = decoder(torch.from_numpy(embeds), torch.from_numpy(pos).long(), _cache(cfg, 2, S),
                     full_logits=not flash, flash_prefill=flash)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefill_then_steps_equal_full_forward(kv_quant):
    """Prefill S − 3 tokens, then 3 steps through the contiguous cache and
    the slot cache (row 1 of 2): each step's logits equal the full
    forward's (the int8 slot cache within its quantization error)."""
    _, decoder = _decoder_pair(True, seed=3)
    cfg = decoder.cfg
    S, n = 20, 17
    embeds = torch.from_numpy(np.random.default_rng(11).standard_normal((1, S, cfg.hidden_size)).astype(np.float32))
    pos = torch.arange(S)[None]
    full, _ = decoder(embeds, pos, _cache(cfg, 1, S), full_logits=True)
    logits, cache = decoder(embeds[:, :n], pos[:, :n], _cache(cfg, 1, S), flash_prefill=True)
    np.testing.assert_allclose(logits.numpy(), full[:, n - 1].numpy(), **F32)
    cache = bump_length(cache, n)
    _, k, v = decoder.prefill(embeds[:, :n], pos[:, :n])
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
        step, cache = decoder(embeds[:, i : i + 1], pos[:, i : i + 1], cache)
        cache = bump_length(cache, 1)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(), **F32)
        slot = decoder.slot_step(torch.cat([embeds[:, i : i + 1]] * 2), torch.full((2, 1), i), slots)
        slots.lengths[1] += 1
        np.testing.assert_allclose(slot[1].numpy(), full[0, i].numpy(), **tol)


# -- engines ----------------------------------------------------------------------------------


def test_embeddings_and_prompt_equal_reference(engines):
    """One tower pass over three images of mixed grids, split per image."""
    jax_engine, port = engines
    images = _images(5, [(60, 70), (90, 40), (30, 500)])
    want, jgrids = jax_engine.encode_images(images, JAX_VISION)
    got, grids = port.encode_images(images, VISION)
    assert grids == jgrids and len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    prompt = "a<image>b<image>\n<image>c"
    assert port.build_prompt_tokens(_Tok(), prompt, grids) == jax_engine.build_prompt_tokens(_Tok(), prompt, jgrids)
    with pytest.raises(ValueError, match="mismatch"):
        port.build_prompt_tokens(_Tok(), "<image>", grids)


@pytest.mark.parametrize("n", [3, 12])
def test_decode_tokens_equal_reference(engines, n):
    jax_engine, port = engines
    two = _images(n, [(60, 70), (90, 40)])
    for prompt, images in (("<image>ocr", two[:1]), ("<image>ocr", two[1:]), ("<image> and <image>ocr", two)):
        want = jax_engine.decode(_Tok(), prompt, images, JAX_VISION,
                                 JaxParams(max_new_tokens=n, no_repeat_ngram_size=None))
        got = port.decode(_Tok(), prompt, images, VISION,
                          DecodeParameters(max_new_tokens=n, no_repeat_ngram_size=None))
        assert (got.generated_tokens, got.prompt_tokens) == (want.generated_tokens, want.prompt_tokens)


def _serve(engine, images, max_new=10, streams=None, prompts=None):
    jax_side = isinstance(engine, JaxEngine)
    cls, params = (JaxScheduler, JaxParams) if jax_side else (ContinuousScheduler, DecodeParameters)

    async def go():
        sched = cls(engine, _Tok(), n_slots=2, max_len=1024, chunk_steps=3)
        return await asyncio.gather(*(
            sched.submit(prompts[i] if prompts else f"<image>o{i}", ims if prompts else [ims],
                         JAX_VISION if jax_side else VISION,
                         params(max_new_tokens=max_new, no_repeat_ngram_size=None),
                         **({"stream_cb": streams[i]} if streams else {}))
            for i, ims in enumerate(images)))

    return [o.generated_tokens for o in asyncio.run(go())]


def test_scheduler_tokens_equal_reference(engines):
    """Four requests over two slots, streamed in the port, and a wave with
    a two-image request beside one-image ones."""
    jax_engine, port = engines
    images = _images(17, [(60, 70), (60, 70), (90, 40), (40, 120)])
    want = _serve(jax_engine, images)
    seen = [[] for _ in images]
    got = _serve(port, images, streams=[lambda n, toks, i=i: seen[i].append(list(toks)) for i in range(4)])
    assert got == want
    for i, calls in enumerate(seen):
        assert calls and calls[-1] == got[i]
    reqs = [images[:2], images[2:3], images[3:]]
    prompts = ["<image>two <image>", "<image>one", "<image>x"]
    assert _serve(port, reqs, prompts=prompts) == _serve(jax_engine, reqs, prompts=prompts)


def test_eos_is_appended_then_stops_like_reference(engines):
    jax_engine, port = engines
    images = _images(17, [(60, 70), (90, 40)])
    eos = next(t for toks in _serve(port, images) for j, t in enumerate(toks) if j and t not in toks[:j])
    jax_eos = JaxEngine(dc.replace(jax_tiny(), eos_token_id=eos), params=jax_engine.params, dtype=jnp.float32,
                        max_seq_len=512)
    port_eos = DotsOcrEngine(dc.replace(tiny_dots_config(), eos_token_id=eos), dtype=torch.float32, device="cpu",
                             max_seq_len=512, state=port.model.state_dict())
    want = _serve(jax_eos, images)
    assert want == _serve(port_eos, images)
    assert any(t and t[-1] == eos for t in want)
    for img in images:
        a = jax_eos.decode(_Tok(), "<image>x", [img], JAX_VISION, JaxParams(max_new_tokens=10))
        b = port_eos.decode(_Tok(), "<image>x", [img], VISION, DecodeParameters(max_new_tokens=10))
        assert a.generated_tokens == b.generated_tokens


@pytest.fixture(scope="module")
def wide():
    jax_engine = JaxEngine(_wide(jax_tiny()), dtype=jnp.float32, max_seq_len=512)
    return jax.device_get(jax_engine.params)


@pytest.mark.parametrize("method", ["q8_0", "q4_k", "q6_k"])
def test_packed_trees_logits_and_tokens_equal_reference(wide, method):
    tree = wide
    state = params_from_jax(tree)
    want = params_from_jax(dict(tree, decoder=jax.device_get(jax_quantize(jdec.fuse_qwen2_params(tree["decoder"]),
                                                                          method))))
    got = quantize_qwen2_params(fuse_qwen2_params(state), method)
    assert set(got) == set(want)
    packed = {k.rsplit(".", 1)[0] for k in got if k.endswith(".codes")}
    assert "decoder.lm_head" in packed and "decoder.layers.1.down_proj" in packed
    for key in want:
        assert torch.equal(got[key], want[key]), key
    jq = JaxEngine(_wide(jax_tiny()), params=tree, dtype=jnp.float32, max_seq_len=512, quantize=method)
    pq = DotsOcrEngine(_wide(tiny_dots_config()), dtype=torch.float32, device="cpu", max_seq_len=512, state=state,
                       quantize=method)
    images = _images(19, [(60, 70), (90, 40)])
    for img in images:
        emb, grids = jq.encode_images([img], JAX_VISION)
        jt, jm = jq.build_prompt_tokens(_Tok(), "<image>ocr", grids)
        want_logits = np.asarray(jq._prefill_packed(jt, jm, emb)["logits"])
        got_logits = pq.prefill_for_slot(_Tok(), "<image>ocr", [img], VISION)["logits"]
        # both round the activations to bf16 before each packed matmul: an
        # f32 difference of 1e-6 upstream can move an element by a bf16 ulp
        np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=1e-2, rtol=1e-2)
    assert _serve(pq, images, max_new=6) == _serve(jq, images, max_new=6)


def test_adapter_specs_equal_reference():
    for config in ({"architectures": ["DotsOCRForCausalLM"]},
                   {**chip_smoke.dots_config_json(tiny_dots_config())},
                   {"architectures": ["DotsOCR"], "num_hidden_layers": 2, "tie_word_embeddings": True}):
        mine, ref = adapters.infer_adapter(config), jax_adapters.infer_adapter(config)
        assert mine.id == ref.id == "dots-ocr"
        got = mine.discover(config, adapters.AdapterScope.TEXT)
        want = ref.discover(config, jax_adapters.AdapterScope.TEXT)
        assert [dc.astuple(s) for s in got] == [dc.astuple(s) for s in want]
    full = adapters.infer_adapter({"architectures": ["DotsOCRForCausalLM"]}).discover({}, None)
    assert len(full) == 28 * 7 + 1 and full[-1].out_dim == 151936
    assert ("model.layers.0.mlp.down_proj", 1536, 8960) in [dc.astuple(s) for s in full]


# -- files --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(engines, tmp_path_factory):
    """The tiny engine written under the published names (its q/k/v
    biases made nonzero), and Q8_0 snapshots of it from both exporters."""
    _, port = engines
    state = dict(port.model.state_dict())
    state["decoder.layers.0.qkv_bias"] = torch.linspace(-1, 1, state["decoder.layers.0.qkv_bias"].numel())
    directory = tmp_path_factory.mktemp("dots")
    index, config, _ = chip_smoke.write_checkpoint(torch, state, port.cfg, str(directory))
    common = ["export", "--weights", index, "--config", config, "--dtype", "q8_0", "--model-id", "tiny"]
    snaps = {"ref": str(directory / "ref.dsq"), "mine": str(directory / "mine.dsq")}
    assert jax_cli.main(common + ["--output", snaps["ref"]]) == 0
    assert cli.main(common + ["--output", snaps["mine"], "--device", "cpu"]) == 0
    return index, config, snaps, state


def test_config_json_round_trips(files):
    _, config, _, _ = files
    data = json.loads(open(config).read())
    assert dc.asdict(DotsConfig.from_dict(data)) == dc.asdict(JaxConfig.from_dict(data))
    full = chip_smoke.dots_config_json(DotsConfig())
    assert DotsConfig.from_dict(full) == DotsConfig()


def test_snapshot_export_equals_reference(files):
    _, _, snaps, _ = files
    assert open(snaps["mine"], "rb").read() == open(snaps["ref"], "rb").read()


@pytest.mark.parametrize("snapshot", [False, True])
def test_loader_matches_reference_loader(files, snapshot):
    index, _, snaps, state = files
    snap = snaps["mine"] if snapshot else None
    got = load_dots_params(index, tiny_dots_config(), dtype=torch.float32, snapshot_path=snap, device="cpu")
    tree = jax_load(index, jax_tiny(), dtype=jnp.float32, snapshot_path=snap)
    raw = tree["decoder"].pop("__raw_quant__", None)
    got_raw = got.pop("__raw_quant__", None)
    want = params_from_jax(jax.device_get(tree))
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    if snapshot:
        assert got_raw.keys() == raw.keys() == {("layers", "down_proj")}  # the only in dim of 32s
        for key in raw:
            assert got_raw[key]["method"] == raw[key]["method"]
            assert [np.asarray(p).tobytes() for p in got_raw[key]["layers"]] == \
                [np.asarray(p).tobytes() for p in raw[key]["layers"]]
    else:
        engine = DotsOcrEngine(tiny_dots_config(), dtype=torch.float32, device="cpu", state=got)
        assert all(torch.equal(v, state[k]) for k, v in engine.model.state_dict().items())


def test_load_engine_tokens_equal_reference(files, monkeypatch):
    """load_engine from the files (and the snapshot) on the CPU against the
    reference's load_engine: the tiny config stands in for from_json,
    since a published config.json has no field for the tiny image ids."""
    index, config, snaps, _ = files
    monkeypatch.setattr(DotsConfig, "from_json", classmethod(lambda cls, path: tiny_dots_config()))
    monkeypatch.setattr(JaxConfig, "from_json", classmethod(lambda cls, path: jax_tiny()))
    images = _images(23, [(60, 70), (90, 40)])
    for snapshot in (None, snaps["mine"]):
        port = registry.load_engine(ModelKind.DOTS_OCR, config_path=config, weights_path=index,
                                    snapshot_path=snapshot, dtype="float32", max_seq_len=512, kv_quant="int8",
                                    device="cpu")
        assert isinstance(port, DotsOcrEngine) and port.quantize == ("q8_0" if snapshot else None)
        ref = jax_registry.load_engine(JaxKind.DOTS_OCR, config_path=config, weights_path=index,
                                       snapshot_path=snapshot, dtype="float32", max_seq_len=512, kv_quant="int8")
        assert _serve(port, images) == _serve(ref, images)
