"""Weights from files, the container side: the port's safetensors reader,
ggml byte codecs, .dsq writer and reader, exporter CLI and raw-payload
packing against the reference's (dsocr_tpu/utils/safetensors_io.py,
dsocr_tpu/dsq/{quant,format,cli,serve_quant}.py) on files the reference's
own writers make in tmp_path.

- The reader returns each tensor in its stored dtype, equal to the
  reference's CheckpointReader for f32, f16, bf16 and i64, from one file
  and from an index shard set; a missing name raises KeyError, an unknown
  dtype raises by name, and a tensor off its element size is copied out.
- The codecs' bytes equal quantize_q8_0 / quantize_q4_k / quantize_q6_k
  (zero blocks, rounding ties, bf16 input), their decodes equal the
  reference's dequantize_* bit for bit (Q4_K in f64, as NumPy promotes),
  the Q4_K scale packing equals the reference's, and a width off the block
  raises.
- The .dsq writer's files equal the reference writer's byte for byte for
  every record dtype, with and without a bias; each package reads the
  other's files; bad magic, a bad version and duplicate names raise.
- `python -m dsocr_tpu_torch.dsq export` writes the reference exporter's
  bytes for the same --model-id; `info` and `stats` print its lines; it
  quantizes on the card unless --device names the CPU.
- Raw payloads decode into the port's layouts: Q8_0 equal to packing the
  float, Q4_K and Q6_K equal to convert's translation of the reference's
  pack_q4_k / pack_q6_k planes, row and in-major; a method mismatch or a
  wrong length falls back to the float; fused_raw concatenates as the
  reference's does.
"""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dsocr_tpu.dsq import cli as jax_cli
from dsocr_tpu.dsq import format as jax_fmt
from dsocr_tpu.dsq import quant as jax_quant
from dsocr_tpu.dsq.serve_quant import fused_raw as jax_fused_raw
from dsocr_tpu.ops.pallas.kquant_matmul import pack_q4_k, pack_q4_k_inmajor, pack_q6_k, pack_q6_k_inmajor
from dsocr_tpu.utils.safetensors_io import CheckpointReader as JaxReader
from dsocr_tpu_torch.dsq import cli, quant
from dsocr_tpu_torch.dsq import format as fmt
from dsocr_tpu_torch.dsq.serve_quant import fused_raw, quantize_expert_stack, quantize_plain
from dsocr_tpu_torch.models.deepseek.convert import _q4k_from_planes, _q6k_from_planes
from dsocr_tpu_torch.utils.safetensors_io import CheckpointReader


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test: the suite runs under several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _numpy_reference(monkeypatch):
    """The reference's NumPy quantizers, not its native build (bytes are
    the same either way; this keeps the test from compiling C++)."""
    monkeypatch.setenv("DSOCR_NO_NATIVE", "1")


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(7,)).astype(np.float16),
        "bf16": rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-2**40, 2**40, size=(2, 3), dtype=np.int64),
    }


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("layout", ["file", "index"])
def test_reader_equals_reference(tmp_path, layout):
    tensors = _tensors()
    if layout == "file":
        path = tmp_path / "model.safetensors"
        save_file(tensors, str(path))
    else:
        names = sorted(tensors)
        weight_map = {}
        for k, part in enumerate((names[:2], names[2:])):
            shard = f"model-{k + 1:05d}-of-00002.safetensors"
            save_file({n: tensors[n] for n in part}, str(tmp_path / shard))
            weight_map.update(dict.fromkeys(part, shard))
        path = tmp_path / "model.safetensors.index.json"
        path.write_text(json.dumps({"weight_map": weight_map}))
    ref, mine = JaxReader(path), CheckpointReader(path)
    assert sorted(mine.keys()) == sorted(ref.keys()) == sorted(tensors)
    dtypes = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16, "i64": torch.int64}
    for name, dtype in dtypes.items():
        t = mine.get(name)
        assert t.dtype == dtype and t.shape == tensors[name].shape
        want = ref.get(name)
        np.testing.assert_array_equal(_as_numpy(t), want.astype(np.float32) if name == "bf16" else want)
        np.testing.assert_array_equal(mine.get(name, torch.float32).numpy(), ref.get(name, np.float32))
    assert "f32" in mine and "nope" not in mine
    assert list(mine.iter_prefix("f")) == [n for n in mine.keys() if n.startswith("f")]
    assert mine.get_optional("nope") is None
    with pytest.raises(KeyError):
        mine.get("nope")
    if layout == "file":  # a file name whose index lies beside it
        assert CheckpointReader(path).keys() == mine.keys()


def _raw_safetensors(path, entries, data: bytes, pad_to: int):
    """A hand-made safetensors file whose data starts `pad_to` bytes past
    an 8-byte boundary."""
    header = json.dumps(entries).encode()
    header += b" " * ((pad_to - 8 - len(header)) % 8)
    path.write_bytes(struct.pack("<Q", len(header)) + header + data)


def test_reader_copies_unaligned_and_names_unknown_dtypes(tmp_path):
    values = np.arange(6, dtype=np.float32)
    path = tmp_path / "odd.safetensors"
    entries = {"pad": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
               "x": {"dtype": "F32", "shape": [2, 3], "data_offsets": [1, 25]},
               "e": {"dtype": "F32", "shape": [0], "data_offsets": [25, 25]},
               "f8": {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [25, 26]},
               "__metadata__": {"format": "pt"}}
    _raw_safetensors(path, entries, b"\x07" + values.tobytes() + b"\x01", pad_to=0)
    reader = CheckpointReader(path)
    x = reader.get("x")
    np.testing.assert_array_equal(x.numpy(), values.reshape(2, 3))
    assert x.data_ptr() % 4 == 0  # copied onto its element size
    assert reader.get("pad").tolist() == [7]
    assert reader.get("e").shape == (0,)
    with pytest.raises(ValueError, match="F8_E4M3"):
        reader.get("f8")


def _weights(rng, rows, cols, case):
    w = (rng.normal(size=(rows, cols)) * 0.05).astype(np.float32)
    if case == "zeros":
        w[0, :] = 0.0  # whole zero blocks and super-blocks
        w[1, :32] = 0.0
    elif case == "ties":  # halves of the Q8_0 step (scale 1.0) and repeated values
        w[0, :32] = [127.0] + [k + 0.5 for k in range(-15, 16)]
        w[1] = np.round(w[1] * 64) / 64
    elif case == "bf16":
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    return w


@pytest.mark.parametrize("case", ["normal", "zeros", "ties", "bf16"])
@pytest.mark.parametrize("dtype", ["Q8_0", "Q4_K", "Q6_K"])
def test_codecs_equal_reference(dtype, case):
    rng = np.random.default_rng(sum(map(ord, dtype + case)))
    rows, cols = 6, 512
    w = _weights(rng, rows, cols, case)
    want = jax_quant.quantize(dtype, w, rows, cols)
    tw = torch.from_numpy(w).to(torch.bfloat16) if case == "bf16" else torch.from_numpy(w)
    got = quant.quantize(dtype, tw, rows, cols)
    assert got == want
    ref_vals = jax_quant.dequantize(dtype, want, rows, cols)
    mine = quant.dequantize(dtype, want, rows, cols)
    assert mine.numpy().dtype == ref_vals.dtype
    np.testing.assert_array_equal(mine.numpy(), ref_vals)
    assert quant.block_size(dtype) == jax_quant.block_size(dtype)


def test_q4k_scale_packing_equals_reference():
    rng = np.random.default_rng(4)
    ls = rng.integers(0, 64, size=(50, 8), dtype=np.uint8)
    lm = rng.integers(0, 64, size=(50, 8), dtype=np.uint8)
    ls[0], lm[0] = 63, 0  # every high bit set, none
    packed = quant._pack_q4k_scales(torch.from_numpy(ls), torch.from_numpy(lm))
    np.testing.assert_array_equal(packed.numpy(), jax_quant._pack_q4k_scales(ls, lm))
    sc, m = quant._unpack_q4k_scales(packed)
    ref_sc, ref_m = jax_quant._unpack_q4k_scales(packed.numpy())
    np.testing.assert_array_equal(sc.numpy(), ref_sc)
    np.testing.assert_array_equal(m.numpy(), ref_m)
    np.testing.assert_array_equal(sc.numpy(), ls)


@pytest.mark.parametrize("dtype,cols", [("Q8_0", 48), ("Q4_K", 384), ("Q6_K", 128)])
def test_codecs_refuse_a_width_off_the_block(dtype, cols):
    with pytest.raises(ValueError, match="not a multiple"):
        quant.quantize(dtype, torch.zeros(2, cols), 2, cols)


def _fill(writer, rng, dtype, bias):
    w = (rng.normal(size=(8, 256)) * 0.1).astype(np.float32)
    b = None
    if bias is not None:
        b = np.abs(rng.normal(size=8) * 10).astype(bias)
    port = isinstance(writer, fmt.DsqWriter)
    wt = torch.from_numpy(w) if port else w
    bt = (torch.from_numpy(b) if b is not None else None) if port else b
    if dtype in ("F32", "F16", "BF16"):
        writer.add_float_tensor("model.layers.0.self_attn.q_proj", wt, dtype, bias=bt)
    else:
        writer.quantize_and_add("model.layers.0.self_attn.q_proj", wt, dtype, bias=bt)
    writer.quantize_and_add("lm_head", wt[:4], "Q8_0")


RECORD_DTYPES = ["Q8_0", "Q4_K", "Q6_K", "F16", "F32", "BF16"]


@pytest.mark.parametrize("dtype,bias", [(d, None) for d in RECORD_DTYPES] + [(d, np.float32) for d in RECORD_DTYPES]
                         + [("Q8_0", b) for b in (np.float16, np.int64, np.uint8, np.uint32, np.float64)])
def test_writer_bytes_equal_reference_and_each_reads_the_other(tmp_path, dtype, bias):
    mine_path, ref_path = tmp_path / "mine.dsq", tmp_path / "ref.dsq"
    for writer, path in ((fmt.DsqWriter("m", "Q6_K"), mine_path), (jax_fmt.DsqWriter("m", "Q6_K"), ref_path)):
        _fill(writer, np.random.default_rng(1), dtype, bias)
        writer.finalize(path)
    assert mine_path.read_bytes() == ref_path.read_bytes()
    mine, ref = fmt.DsqReader(ref_path), jax_fmt.DsqReader(mine_path)
    assert _same(mine.header, ref.header)
    for a, b in zip(mine.records, ref.records):
        assert _same(a, b)
        np.testing.assert_array_equal(mine.dequantize(a.name).numpy(), ref.dequantize(b.name))
        assert mine.tensor_bytes(a) == ref.tensor_bytes(b)
        if b.bias_len:
            np.testing.assert_array_equal(mine.bias_array(a).numpy(), ref.bias_array(b))
        else:
            assert mine.bias_array(a) is None
    assert "lm_head" in mine and mine.tensor("nope") is None


def _same(a, b) -> bool:
    return vars(a) == vars(b)


@pytest.mark.parametrize("fault", ["magic", "version", "duplicate"])
def test_reader_rejects_bad_files(tmp_path, fault):
    path = tmp_path / "s.dsq"
    writer = fmt.DsqWriter("m")
    writer.quantize_and_add("a", torch.ones(2, 32))
    writer.quantize_and_add("a" if fault == "duplicate" else "b", torch.ones(2, 32))
    writer.finalize(path)
    data = bytearray(path.read_bytes())
    if fault == "magic":
        data[:7] = b"NOTSNAP"
    elif fault == "version":
        data[7:11] = struct.pack("<I", 2)
    path.write_bytes(bytes(data))
    match = {"magic": "magic", "version": "version", "duplicate": "duplicate"}[fault]
    for reader in (fmt.DsqReader, jax_fmt.DsqReader):
        with pytest.raises(ValueError, match=match):
            reader(path)


def _export_checkpoint(tmp_path, hidden=256, inter=512, moe_inter=128, experts=2):
    """A small HF-named checkpoint and config.json: 2 layers (one dense,
    one MoE with a shared expert), widths on the K-quants' super-block
    except the expert down projections'."""
    rng = np.random.default_rng(7)
    lang = {"hidden_size": hidden, "num_hidden_layers": 2, "num_attention_heads": 2,
            "intermediate_size": inter, "moe_intermediate_size": moe_inter, "n_routed_experts": experts,
            "n_shared_experts": 1, "num_experts_per_tok": 1, "first_k_dense_replace": 1, "vocab_size": 64}
    t = {"lm_head.weight": rng.normal(size=(64, hidden)), "model.projector.layers.weight":
         rng.normal(size=(hidden, 2048)), "model.projector.layers.bias": rng.normal(size=hidden)}
    for i in range(2):
        for p in ("q_proj", "k_proj", "v_proj", "o_proj"):
            t[f"model.layers.{i}.self_attn.{p}.weight"] = rng.normal(size=(hidden, hidden))
    for p, shape in (("gate_proj", (inter, hidden)), ("up_proj", (inter, hidden)), ("down_proj", (hidden, inter))):
        t[f"model.layers.0.mlp.{p}.weight"] = rng.normal(size=shape)
    for e in range(experts):
        for p, shape in (("gate_proj", (moe_inter, hidden)), ("up_proj", (moe_inter, hidden)),
                         ("down_proj", (hidden, moe_inter))):
            t[f"model.layers.1.mlp.experts.{e}.{p}.weight"] = rng.normal(size=shape)
    for p, shape in (("gate_proj", (moe_inter, hidden)), ("up_proj", (moe_inter, hidden)),
                     ("down_proj", (hidden, moe_inter))):
        t[f"model.layers.1.mlp.shared_experts.{p}.weight"] = rng.normal(size=shape)
    del t["model.layers.1.self_attn.o_proj.weight"]  # a missing linear is skipped
    t = {k: (v * 0.05).astype(np.float32) for k, v in t.items()}
    t["model.layers.0.self_attn.q_proj.weight"] = t["model.layers.0.self_attn.q_proj.weight"].astype(
        ml_dtypes.bfloat16)  # a bf16 tensor reads as its f32 value
    weights = tmp_path / "model.safetensors"
    save_file(t, str(weights))
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"architectures": ["DeepseekOCRForCausalLM"], "language_config": lang,
                                  "vision_config": {"width": {"sam_vit_b": {}}}}))
    return weights, config


@pytest.mark.parametrize("args", [["--dtype", "q8_0"], [], ["--dtype", "q4k", "--targets", "text+projector"]])
def test_export_equals_reference_and_cli_lines(tmp_path, capsys, args):
    weights, config = _export_checkpoint(tmp_path)
    common = ["export", "--weights", str(weights), "--config", str(config), "--model-id", "snap"] + args
    assert jax_cli.main(common + ["--output", str(tmp_path / "ref.dsq")]) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(common + ["--output", str(tmp_path / "mine.dsq"), "--device", "cpu"]) == 0
    mine_out = capsys.readouterr().out
    assert mine_out.replace("mine.dsq", "ref.dsq") == ref_out
    assert "float fallback" in mine_out and "1 missing" in mine_out
    assert (tmp_path / "mine.dsq").read_bytes() == (tmp_path / "ref.dsq").read_bytes()
    for command in (["info"], ["stats", "--verbose"]):
        assert jax_cli.main(command + [str(tmp_path / "ref.dsq")]) == 0
        ref_lines = capsys.readouterr().out.replace("ref.dsq", "X")
        assert cli.main(command + [str(tmp_path / "mine.dsq")]) == 0
        assert capsys.readouterr().out.replace("mine.dsq", "X") == ref_lines


def test_export_default_model_id_and_unknown_config(tmp_path, capsys):
    weights, config = _export_checkpoint(tmp_path)
    base = ["export", "--weights", str(weights), "--config", str(config), "--dtype", "q8_0"]
    jax_cli.main(base + ["--output", str(tmp_path / "ref.dsq")])
    cli.main(base + ["--output", str(tmp_path / "mine.dsq"), "--device", "cpu"])
    assert fmt.DsqReader(tmp_path / "mine.dsq").header.model_id == (
        jax_fmt.DsqReader(tmp_path / "ref.dsq").header.model_id)
    if not torch.cuda.is_available():  # the card unless --device names the CPU
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cli.main(base + ["--output", str(tmp_path / "x.dsq")])
    # an architecture no adapter supports (PaddleOCR-VL has one since PaddleOcrAdapter)
    config.write_text(json.dumps({"architectures": ["UnknownOcrForCausalLM"]}))
    capsys.readouterr()
    assert cli.main(base + ["--output", str(tmp_path / "x.dsq"), "--device", "cpu"]) == 1
    assert "no adapter" in capsys.readouterr().err


def _payload(dtype, w):
    return jax_quant.quantize(dtype, w, *w.shape)


@pytest.mark.parametrize("layout", ["row", "in_major"])
def test_q8_payload_decodes_to_direct_packing(layout):
    rng = np.random.default_rng(5)
    if layout == "row":
        w = _weights(rng, 64, 96, "ties")  # [out, in]
        raw = {"method": "q8_0", "layers": [_payload("Q8_0", w)]}
        got = quantize_plain(torch.from_numpy(w.T.copy()), "q8_0", raw=raw)
        want = quantize_plain(torch.from_numpy(w.T.copy()), "q8_0")
    else:
        ws = [_weights(rng, 48, 64, "zeros") for _ in range(3)]  # 3 experts [out, in]
        raw = {"method": "q8_0", "layers": [[_payload("Q8_0", w) for w in ws]]}
        stack = torch.from_numpy(np.stack([w.T for w in ws]))
        got = quantize_expert_stack(stack, "q8_0", raw=raw)
        want = quantize_expert_stack(stack, "q8_0")
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("layout", ["row", "in_major"])
@pytest.mark.parametrize("method", ["q4_k", "q6_k"])
def test_kquant_payload_decodes_to_reference_planes(method, layout):
    """The reference packs a published payload into its planes
    (pack_q4_k / pack_q6_k, *_inmajor for expert stacks); convert's
    translation of those planes is the port's layout, and decoding the
    payload must give it."""
    rng = np.random.default_rng(6)
    dtype = method.upper()
    from_planes = _q4k_from_planes if method == "q4_k" else _q6k_from_planes
    if layout == "row":
        w = _weights(rng, 32, 512, "zeros")
        payload = _payload(dtype, w)
        planes = (pack_q4_k if method == "q4_k" else pack_q6_k)(payload, 32, 512)
        got = quantize_plain(torch.zeros(512, 32), method, raw={"method": method, "layers": [payload]})
        want = from_planes(planes, in_major=False)
    else:
        E, o, i = 3, 16, 256
        ws = [_weights(rng, o, i, "normal") for _ in range(E)]
        payloads = [_payload(dtype, w) for w in ws]
        planes = (pack_q4_k_inmajor if method == "q4_k" else pack_q6_k_inmajor)(b"".join(payloads), E, o, i)
        got = quantize_expert_stack(torch.zeros(E, i, o), method, raw={"method": method, "layers": [payloads]})
        want = from_planes(planes, in_major=True)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)


@pytest.mark.parametrize("fault", ["method", "length"])
def test_raw_falls_back_to_the_float(fault):
    rng = np.random.default_rng(8)
    w = _weights(rng, 16, 256, "normal")
    other = _weights(rng, 16, 256, "normal")  # a payload that is not w's
    payload = _payload("Q6_K", other)
    raw = {"method": "q4_k", "layers": [payload]} if fault == "method" else (
        {"method": "q6_k", "layers": [payload[:-210]]})
    got = quantize_plain(torch.from_numpy(w.T.copy()), "q6_k", raw=raw)
    want = quantize_plain(torch.from_numpy(w.T.copy()), "q6_k")
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_fused_raw_concatenates_as_reference():
    raw = {
        ("dense_layers", "q_proj"): {"method": "q8_0", "layers": [b"Q0", b"Q1"]},
        ("dense_layers", "k_proj"): {"method": "q8_0", "layers": [b"K0", b"K1"]},
        ("dense_layers", "v_proj"): {"method": "q8_0", "layers": [b"V0", b"V1"]},
        ("moe_layers", "experts_gate"): {"method": "q4_k", "layers": [[b"g0", b"g1"]]},
        ("moe_layers", "experts_up"): {"method": "q4_k", "layers": [[b"u0", b"u1"]]},
        ("", "lm_head"): {"method": "q6_k", "layers": [b"H"]},
    }
    fused_from = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "experts_gateup": ("experts_gate", "experts_up")}

    def b(p):
        return bytes(p.numpy()) if isinstance(p, torch.Tensor) else p

    def as_bytes(ent):
        if ent is None:
            return None
        return {"method": ent["method"],
                "layers": [[b(p) for p in l] if isinstance(l, list) else b(l) for l in ent["layers"]]}

    for group, key in (("dense_layers", "qkv_proj"), ("moe_layers", "experts_gateup"), ("", "lm_head"),
                       ("dense_layers", "o_proj")):
        assert as_bytes(fused_raw(raw, group, key, fused_from)) == jax_fused_raw(raw, group, key, fused_from)
    assert as_bytes(fused_raw(raw, "dense_layers", "qkv_proj", fused_from, layers=[1])) == {
        "method": "q8_0", "layers": [b"Q1K1V1"]}
    raw[("dense_layers", "k_proj")]["method"] = "q6_k"
    assert fused_raw(raw, "dense_layers", "qkv_proj", fused_from) is None
    assert jax_fused_raw(raw, "dense_layers", "qkv_proj", fused_from) is None
