"""The mesh's rank processes (dsocr_tpu_torch/parallel/launch.py) and its
front ends, on the CPU over gloo.

- A follower that raises fails rank 0's next collective, and the error
  names the rank and carries its traceback; every rank is torn down.
- A follower that never joins a collective is killed at the ranks'
  deadline, and the error names it: no mesh test can hang past it.
- The backend follows the topology (NCCL only with a card per rank).
- One request through the CLI and one through the server with
  ``--mesh dp=1,mp=2``, on the tiny checkpoint the CLI tests use, are
  answered as the single-process port answers them; the server's model
  swap stops the followers.
- A call that raises on rank 0 (an out-of-memory prefill, say) fails its
  request and tears the ranks down; the server's next request loads the
  model anew on new ranks and is answered as before.
- The same for a dense family: the CLI and the server serve the tiny
  PaddleOCR-VL checkpoint under ``--mesh`` (slot rows over dp in the
  CLI, KV heads over mp in the server) as the single process does.
- Ranks started under DSOCR_VISION_F32 inherit it: a bf16 DeepSeek
  engine's followers build f32 towers as rank 0 does.
"""

import asyncio
import json
import os
import time

import pytest
import torch
import torch.distributed as dist

from dsocr_tpu_torch.config import AppConfig
from dsocr_tpu_torch.parallel import comm, launch
from dsocr_tpu_torch.server.state import AppState
from tests.test_torch_cli import ARGS, env, home, paddle_files  # noqa: F401  (the tiny checkpoints' cache directory)
from tests.test_torch_server import TINY_SETTINGS, PortServer, chat, same_answer


def _fail_through(ranks):
    try:
        dist.barrier()
    except Exception as err:
        ranks.fail(err)


def test_a_follower_that_raises_is_named():
    ranks = launch.start(2, "cpu", deadline=30)
    ranks.build(os._exit, {})  # os._exit takes no device= nor ranks=: the follower raises
    t0 = time.monotonic()
    with pytest.raises(launch.MeshError, match=r"rank 1 raised:(.|\n)*TypeError"):
        _fail_through(ranks)
    assert time.monotonic() - t0 < 20
    assert ranks.closed and not dist.is_initialized()
    assert not any(p.is_alive() for p in ranks.procs)


def test_a_hung_follower_is_killed_at_the_deadline():
    ranks = launch.start(2, "cpu")
    ranks.set_deadline(3)  # the follower waits on its pipe and never reaches the barrier
    t0 = time.monotonic()
    with pytest.raises(launch.MeshError, match=r"rank\(s\) \[1\] hung"):
        _fail_through(ranks)
    assert time.monotonic() - t0 < 20
    assert not any(p.is_alive() for p in ranks.procs)


def test_close_joins_every_rank():
    ranks = launch.start(2, "cpu", deadline=30)
    assert ranks.backend == "gloo" and ranks.world == 2
    ranks.close()
    assert ranks.closed and not any(p.is_alive() for p in ranks.procs)
    assert not dist.is_initialized()


def test_backend_follows_the_topology():
    assert comm.choose_backend("cuda", 4, 4) == "nccl"
    assert comm.choose_backend("cuda", 2, 1) == "gloo"  # ranks sharing a card
    assert comm.choose_backend("cpu", 2, 0) == "gloo"
    assert "NCCL refuses two ranks on one device" in comm.backend_reason("cuda", 2, 1)


def test_cli_mesh_answers_as_the_single_process_port(env, tmp_path):  # noqa: F811
    from dsocr_tpu_torch.cli.app import main

    argv = ARGS + ["--prompt", "<image>\nFree OCR.", "--image", str(env / "page.png"), "--max-new-tokens", "8"]
    assert main(argv + ["--output-json", str(tmp_path / "one.json")]) == 0
    assert main(argv + ["--mesh", "dp=1,mp=2", "--output-json", str(tmp_path / "mesh.json")]) == 0
    one, mesh = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("one", "mesh"))
    assert mesh == one and mesh["response_tokens"] > 0
    assert not dist.is_initialized()  # the CLI stopped its followers


def test_server_mesh_answers_as_the_single_process_port(env):  # noqa: F811
    body = chat("deepseek-ocr", max_tokens=8)
    answers = []
    for mesh in (None, "dp=1,mp=2"):
        state = AppState(AppConfig.from_mapping(TINY_SETTINGS), mesh=mesh, device="cpu")
        server = PortServer(state)
        try:
            answers.append(server.request("POST", "/v1/chat/completions", body))
            engine = state.loaded.engine
            if mesh:
                ranks = engine.mesh_runtime.ranks
                assert engine.model.decoder.shard.attn_split and not ranks.closed
                server.run(state._unload())  # a model swap stops the followers
                assert ranks.closed and not any(p.is_alive() for p in ranks.procs)
        finally:
            server.close()
    same_answer(answers[0], answers[1])
    assert json.loads(answers[1][2])["usage"]["completion_tokens"] > 0
    asyncio.set_event_loop(None)


def test_server_mesh_serves_again_after_a_failed_call(env):  # noqa: F811
    body = chat("deepseek-ocr", max_tokens=8)
    state = AppState(AppConfig.from_mapping(TINY_SETTINGS), mesh="dp=1,mp=2", device="cpu")
    server = PortServer(state)
    try:
        first = server.request("POST", "/v1/chat/completions", body)
        assert first[0] == 200
        engine = state.loaded.engine
        ranks = engine.mesh_runtime.ranks

        def out_of_memory(**kwargs):
            raise torch.cuda.OutOfMemoryError("one large request")

        engine.mesh_runtime.op_prefill = out_of_memory  # rank 0 only: the follower waits in a collective
        failed = server.request("POST", "/v1/chat/completions", body)
        assert failed[0] >= 500 and "one large request" in failed[2]
        assert ranks.closed and not engine.alive
        assert not any(p.is_alive() for p in ranks.procs)
        again = server.request("POST", "/v1/chat/completions", body)
        assert state.loaded.engine is not engine and state.loaded.engine.alive
        same_answer(first, again)
        server.run(state.unload())
    finally:
        server.close()
    asyncio.set_event_loop(None)


PADDLE_SETTINGS = {"models": {"active": "paddleocr-vl", "entries": {"paddleocr-vl": {"defaults": {
    "base_size": 64, "image_size": 64, "crop_mode": False, "no_repeat_ngram_size": 0}}}}}


def test_cli_mesh_serves_a_dense_family(env, tmp_path):  # noqa: F811
    from dsocr_tpu_torch.cli.app import main

    paddle_files(env)
    argv = ARGS[:1] + ["paddleocr-vl"] + ARGS[2:] + ["--prompt", "<image>\nOCR:", "--image", str(env / "page.png"),
                                                     "--max-new-tokens", "6"]
    assert main(argv + ["--output-json", str(tmp_path / "one.json")]) == 0
    assert main(argv + ["--mesh", "dp=2,mp=1", "--output-json", str(tmp_path / "mesh.json")]) == 0
    one, mesh = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("one", "mesh"))
    assert mesh == one and mesh["response_tokens"] > 0
    assert not dist.is_initialized()  # the CLI stopped its followers


def test_server_mesh_serves_a_dense_family(env):  # noqa: F811
    paddle_files(env)
    body = chat("paddleocr-vl", max_tokens=8)
    answers = []
    for mesh in (None, "dp=1,mp=2"):
        state = AppState(AppConfig.from_mapping(PADDLE_SETTINGS), mesh=mesh, device="cpu")
        server = PortServer(state)
        try:
            answers.append(server.request("POST", "/v1/chat/completions", body))
            engine = state.loaded.engine
            if mesh:
                ranks = engine.mesh_runtime.ranks
                assert engine.mesh_runtime.share.nkv == 1 and engine.alive and not ranks.closed
                server.run(state._unload())  # a model swap stops the followers
                assert ranks.closed and not engine.alive and not any(p.is_alive() for p in ranks.procs)
        finally:
            server.close()
    same_answer(answers[0], answers[1])
    assert json.loads(answers[1][2])["usage"]["completion_tokens"] > 0
    asyncio.set_event_loop(None)


def test_f32_towers_on_every_rank(monkeypatch):
    """Under DSOCR_VISION_F32 a bf16 engine's followers build f32 towers as
    rank 0 does: ranks started under the knob inherit it, and the view
    rank 1 runs lands on the single-process f32 towers' output, not on the
    bf16 towers'."""
    import numpy as np

    from dsocr_tpu_torch.core import VisionSettings
    from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, tiny_deepseek_config

    cfg = tiny_deepseek_config()
    state = DeepseekOcrEngine(cfg, dtype=torch.float32, device="cpu", max_seq_len=512, seed=5).model.state_dict()

    def engine(**kw):
        return DeepseekOcrEngine(cfg, dtype=torch.bfloat16, device="cpu", max_seq_len=512, state=state, **kw)

    monkeypatch.setenv("DSOCR_VISION_F32", "1")
    ranks = launch.start(2, "cpu", deadline=60)
    try:
        port = engine(mesh="dp=1,mp=2", ranks=ranks)
        single = engine()
        monkeypatch.delenv("DSOCR_VISION_F32")
        bf16 = engine()
        assert port.vision_dtype == single.vision_dtype == torch.float32 and bf16.vision_dtype == torch.bfloat16
        rng = np.random.default_rng(9)
        pages = [rng.integers(0, 256, size=(60, 60, 3), dtype=np.uint8) for _ in range(2)]
        views = np.concatenate([port.prepare_vision_input(p, VisionSettings(64, 64, False)).global_pixels
                                for p in pages])
        got = port.mesh_runtime.towers("_tower", views).float().numpy()
    finally:
        ranks.close()
    want = single._tower(views).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(bf16._tower(views[1:]).float().numpy(), want[1:], rtol=1e-4, atol=1e-4)
