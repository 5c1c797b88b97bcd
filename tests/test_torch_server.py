"""The port's OpenAI-compatible server (dsocr_tpu_torch/server) against the
reference's aiohttp app on the same requests: statuses, JSON bodies (but
for id/created) and SSE event sequences, (a) with the reference test's
engine doubles and (b) with tiny real engines (the JAX engine; the port's
on the same weights through params_from_jax), one tokenizer.json read by
the reference's adapter and by the port's reader. Then the HTTP layer's
own cases (keep-alive, chunked bodies, 413, 404, 405, CORS, 503 with
Retry-After, malformed JSON, a client leaving mid-stream) and the model
swap. The port's server runs in a thread on 127.0.0.1:0; every socket
wait has a 30 s timeout."""

import asyncio
import base64
import gc
import http.client
import io
import json
import socket
import struct
import threading
import weakref
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402
from PIL import Image  # noqa: E402
from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from dsocr_tpu.config import AppConfig as RefConfig  # noqa: E402
from dsocr_tpu.core.engine import ModelKind as RefKind  # noqa: E402
from dsocr_tpu.models.deepseek import DeepseekOcrEngine as JaxEngine  # noqa: E402
from dsocr_tpu.models.deepseek.config import tiny_deepseek_config as jax_tiny  # noqa: E402
from dsocr_tpu.server import routes as ref_routes  # noqa: E402
from dsocr_tpu.server.state import AppState as RefState  # noqa: E402
from dsocr_tpu.server.state import LoadedModel as RefLoaded  # noqa: E402
from dsocr_tpu.utils.tokenizer import load_tokenizer as ref_load_tokenizer  # noqa: E402
from dsocr_tpu_torch.config import AppConfig  # noqa: E402
from dsocr_tpu_torch.core.engine import ModelKind  # noqa: E402
from dsocr_tpu_torch.core.params import normalize_text  # noqa: E402
from dsocr_tpu_torch.models.deepseek import DeepseekOcrEngine, params_from_jax, tiny_deepseek_config  # noqa: E402
from dsocr_tpu_torch.server.routes import build_server  # noqa: E402
from dsocr_tpu_torch.server.state import AppState, LoadedModel  # noqa: E402
from dsocr_tpu_torch.utils.tokenizer import load_tokenizer  # noqa: E402
from tests.test_server import FakeEngine, FakeTokenizer  # noqa: E402

TIMEOUT = 30
TINY_SETTINGS = {"models": {"entries": {"deepseek-ocr": {"defaults": {
    "base_size": 64, "image_size": 64, "crop_mode": False, "no_repeat_ngram_size": 0}}}}}


def data_url(seed=0, size=(60, 60), fmt="PNG") -> str:
    img = np.random.default_rng(seed).integers(0, 256, (*size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return f"data:image/{fmt.lower()};base64," + base64.standard_b64encode(buf.getvalue()).decode()


def chat(model="paddleocr-vl", stream=False, text="Free OCR.", image=True, **extra):
    content = [{"type": "text", "text": text}]
    if image:
        content.append({"type": "image_url", "image_url": {"url": data_url()}})
    return {"model": model, "stream": stream, "messages": [{"role": "user", "content": content}], **extra}


def responses_body(model="paddleocr-vl", stream=False, **extra):
    return {"model": model, "stream": stream, "input": [{"role": "user", "content": [
        {"type": "input_text", "text": "OCR"}, {"type": "input_image", "image_url": data_url(1)}]}], **extra}


# -- the two servers --------------------------------------------------------------------


class PortServer:
    """The port's server on its own event loop in a thread."""

    def __init__(self, state):
        self.state = state
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = build_server(state)
        self.host, self.port = self.run(self.server.start("127.0.0.1", 0))

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(TIMEOUT)

    def close(self):
        self.run(self.server.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)

    def connection(self):
        return http.client.HTTPConnection(self.host, self.port, timeout=TIMEOUT)

    def request(self, method, path, body=None, headers=None, conn=None):
        own = conn is None
        conn = conn or self.connection()
        try:
            payload = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
            hdrs = {"Content-Type": "application/json", **(headers or {})}
            conn.request(method, path, body=payload, headers=hdrs)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read().decode()
        finally:
            if own:
                conn.close()


def ref_requests(state, requests):
    """[(method, path, json body or raw bytes)] through the reference's app,
    one after another on one event loop → [(status, headers, text)]."""
    async def go():
        client = TestClient(TestServer(ref_routes.build_app(state)))
        await client.start_server()
        out = []
        try:
            for method, path, body in requests:
                kw = {"data": body} if isinstance(body, bytes) else ({"json": body} if body is not None else {})
                resp = await asyncio.wait_for(client.request(method, path, **kw), TIMEOUT)
                out.append((resp.status, dict(resp.headers), await resp.text()))
            return out
        finally:
            await client.close()

    return asyncio.run(go())


def ref_request(state, method, path, body=None, raw=None):
    return ref_requests(state, [(method, path, raw if raw is not None else body)])[0]


def _strip(obj):
    """A body without its per-request ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created", "output_id")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def events(text):
    return [e if e == "[DONE]" else _strip(json.loads(e))
            for e in (line[6:] for line in text.splitlines() if line.startswith("data: "))]


def same_answer(ref, port, sse=False):
    assert port[0] == ref[0], (port, ref)
    if sse:
        assert port[1]["Content-Type"] == "text/event-stream"
        assert events(port[2]) == events(ref[2])
    elif ref[1].get("Content-Type", "").startswith("application/json"):
        assert _strip(json.loads(port[2])) == _strip(json.loads(ref[2]))
    else:
        assert port[2] == ref[2]


# -- (a) the reference test's engine doubles -------------------------------------------


def fake_states():
    def port_factory(model_id):
        return LoadedModel(model_id, FakeEngine(), FakeTokenizer(), ModelKind.PADDLE_OCR_VL)

    def ref_factory(model_id):
        return RefLoaded(model_id=model_id, engine=FakeEngine(), tokenizer=FakeTokenizer(),
                         kind=RefKind.PADDLE_OCR_VL)

    return (RefState(RefConfig(), allow_download=False, engine_factory=ref_factory),
            AppState(AppConfig(), engine_factory=port_factory))


@pytest.fixture()
def fake():
    ref_state, port_state = fake_states()
    server = PortServer(port_state)
    yield ref_state, server
    server.close()


FAKE_CASES = {
    "health": ("GET", "/v1/health", None, False),
    "models": ("GET", "/v1/models", None, False),
    "chat": ("POST", "/v1/chat/completions", chat(), False),
    "chat_stream": ("POST", "/v1/chat/completions", chat(stream=True), True),
    "chat_missing_image": ("POST", "/v1/chat/completions", chat(image=False, text="hi"), False),
    "chat_missing_image_stream": ("POST", "/v1/chat/completions", chat(image=False, text="hi", stream=True), True),
    "chat_unknown_model": ("POST", "/v1/chat/completions", chat(model="bogus"), False),
    "chat_no_user": ("POST", "/v1/chat/completions", {"messages": [{"role": "system", "content": "x"}]}, False),
    "chat_file_url": ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "file:///etc/passwd"}}]}]}, False),
    "chat_bad_base64_meta": ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png,abc"}}]}]}, False),
    "responses": ("POST", "/v1/responses", responses_body(max_output_tokens=5), False),
    "responses_stream": ("POST", "/v1/responses", responses_body(stream=True), True),
    "responses_missing_image": ("POST", "/v1/responses", {"input": [{"role": "user", "content": "x"}]}, False),
    "responses_missing_image_stream": ("POST", "/v1/responses",
                                       {"stream": True, "input": [{"role": "user", "content": "x"}]}, True),
    "chat_history": ("POST", "/v1/chat/completions", {"model": "paddleocr-vl", "messages": [
        {"role": "system", "content": "sys"}, {"role": "user", "content": "old"},
        {"role": "assistant", "content": "a"}, {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": data_url(2)}}, {"type": "text", "text": "two"}]}]}, False),
}


@pytest.mark.parametrize("case", sorted(FAKE_CASES))
def test_fake_engine_answers_equal(fake, case):
    ref_state, server = fake
    method, path, body, sse = FAKE_CASES[case]
    same_answer(ref_request(ref_state, method, path, body), server.request(method, path, body), sse)


def test_fake_engine_metrics_counters_equal(fake):
    ref_state, server = fake
    posts = [("POST", "/v1/chat/completions", chat())] * 2
    ref_text = ref_requests(ref_state, posts + [("GET", "/metrics", None)])[-1][2]
    for _, path, body in posts:
        server.request("POST", path, body)
    status, headers, text = server.request("GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    names = ("requests_total", "requests_failed", "prompt_tokens_total", "completion_tokens_total",
             "model_swaps_total")
    for name in names:
        line = next(x for x in ref_text.splitlines() if x.startswith(f"dsocr_{name} "))
        assert line in text.splitlines(), line


def test_jpeg_data_url_is_a_400_naming_jpeg(fake):
    """A JPEG variant the decoder refuses (arithmetic coding: the SOF0
    marker patched to SOF9) is a 400 that names it."""
    _, server = fake
    raw = bytearray(base64.standard_b64decode(data_url(fmt="JPEG").split(",", 1)[1]))
    raw[raw.index(b"\xff\xc0") + 1] = 0xC9
    body = chat()
    body["messages"][0]["content"][1]["image_url"]["url"] = ("data:image/jpeg;base64,"
                                                             + base64.standard_b64encode(bytes(raw)).decode())
    status, _, text = server.request("POST", "/v1/chat/completions", body)
    assert status == 400
    assert "arithmetic-coded JPEG (SOF9)" in json.loads(text)["error"]["message"]


def test_png_past_the_bomb_limit_is_a_400(fake):
    """A 21,904-byte 1-bit 13,400 × 13,400 PNG: Pillow raises
    DecompressionBombError at open, so the reference answers 400; the
    port refuses it from its header, before inflating."""
    ref_state, server = fake
    row = b"\x00" + bytes(13400 // 8 + 1)
    ihdr = struct.pack(">IIBBBBB", 13400, 13400, 1, 0, 0, 0, 0)
    chunks = b"".join(struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
                      for k, b in ((b"IHDR", ihdr), (b"IDAT", zlib.compress(row * 13400, 9)), (b"IEND", b"")))
    body = chat()
    body["messages"][0]["content"][1]["image_url"]["url"] = ("data:image/png;base64," + base64.standard_b64encode(
        b"\x89PNG\r\n\x1a\n" + chunks).decode())
    ref, port = ref_request(ref_state, "POST", "/v1/chat/completions", body), \
        server.request("POST", "/v1/chat/completions", body)
    assert port[0] == ref[0] == 400
    assert "decompression-bomb" in json.loads(port[2])["error"]["message"]


@pytest.mark.parametrize("magic", ["P6", "P3", "P5", "P4"])
def test_real_engine_pnm_data_url_answers_equal(real, magic):
    """A PNM page (decoded by Pillow in the reference's app, natively in
    the port's) answers 200 with the same body, raw and plain, colour,
    grey and bilevel."""
    ref_state, server = real
    img = np.random.default_rng(7).integers(0, 256, (60, 70, 3), dtype=np.uint8)
    head = b"%s\n70 60\n" % magic.encode()
    if magic == "P6":
        raw = head + b"255\n" + img.tobytes()
    elif magic == "P3":
        raw = head + b"255\n" + " ".join(map(str, img.ravel().tolist())).encode()
    elif magic == "P5":
        raw = head + b"1000\n" + (img[..., 0].astype(">u2") * 3).tobytes()
    else:
        raw = head + np.packbits(img[..., 0] > 127, axis=1).tobytes()
    body = chat("deepseek-ocr", max_tokens=12)
    body["messages"][0]["content"][1]["image_url"]["url"] = ("data:image/x-portable-anymap;base64,"
                                                             + base64.standard_b64encode(raw).decode())
    ref, port = ref_request(ref_state, "POST", "/v1/chat/completions", body), \
        server.request("POST", "/v1/chat/completions", body)
    assert port[0] == 200
    same_answer(ref, port)


# -- the HTTP layer -----------------------------------------------------------------------


def test_http_keep_alive(fake):
    _, server = fake
    conn = server.connection()
    try:
        socks = []
        for path in ("/v1/health", "/v1/models", "/v1/health"):
            status, headers, _ = server.request("GET", path, conn=conn)
            assert status == 200 and headers.get("Connection") != "close"
            socks.append(conn.sock)
        assert socks[0] is socks[1] is socks[2] is not None
        status, headers, _ = server.request("GET", "/v1/health", headers={"Connection": "close"}, conn=conn)
        assert status == 200 and headers["Connection"] == "close"
    finally:
        conn.close()


def test_http_chunked_request_body(fake):
    ref_state, server = fake
    raw = json.dumps(chat()).encode()
    conn = server.connection()
    try:
        conn.request("POST", "/v1/chat/completions", body=iter([raw[:100], raw[100:5000], raw[5000:]]),
                     headers={"Content-Type": "application/json", "Transfer-Encoding": "chunked"},
                     encode_chunked=True)
        resp = conn.getresponse()
        port = resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()
    same_answer(ref_request(ref_state, "POST", "/v1/chat/completions", chat()), port)


def test_http_413_over_50mb(fake):
    ref_state, server = fake
    raw = b"x" * (50 * 1024 * 1024 + 10)
    ref = ref_request(ref_state, "POST", "/v1/chat/completions", raw=raw)
    port = server.request("POST", "/v1/chat/completions", raw)
    assert port[0] == ref[0] == 413
    assert port[2] == ref[2]
    assert server.request("GET", "/v1/health")[0] == 200  # the server goes on


@pytest.mark.parametrize("method, path", [("GET", "/nope"), ("POST", "/v1/health"), ("GET", "/v1/chat/completions"),
                                          ("POST", "/metrics")])
def test_http_404_and_405(fake, method, path):
    ref_state, server = fake
    ref, port = ref_request(ref_state, method, path), server.request(method, path)
    assert (port[0], port[2]) == (ref[0], ref[2])
    assert port[1].get("Allow") == ref[1].get("Allow")


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/nope"])
def test_http_options_cors(fake, path):
    ref_state, server = fake
    ref, port = ref_request(ref_state, "OPTIONS", path), server.request("OPTIONS", path)
    assert port[0] == ref[0] == 200
    for name in ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods", "Access-Control-Allow-Headers"):
        assert port[1][name] == ref[1][name]
    assert server.request("GET", "/v1/health")[1]["Access-Control-Allow-Origin"] == "*"


def test_http_malformed_json(fake):
    ref_state, server = fake
    raw = b'{"model": "paddleocr-vl", bad'
    same_answer(ref_request(ref_state, "POST", "/v1/chat/completions", raw=raw),
                server.request("POST", "/v1/chat/completions", raw))


def test_http_head(fake):
    _, server = fake
    status, headers, text = server.request("HEAD", "/v1/health")
    assert status == 200 and text == "" and headers["Content-Length"] == "16"


# -- (b) tiny real engines ----------------------------------------------------------------


def tiny_tokenizer_json(path):
    """A byte-level BPE of the tiny config's 128 ids in DeepSeek's shape:
    BOS 0, EOS 2, <image> 127 as special tokens, printable ASCII and the
    space/newline byte characters, merges filling the rest."""
    base = [chr(c) for c in range(33, 127)] + ["Ġ", "Ċ"]
    vocab = {"<｜begin▁of▁sentence｜>": 0, "<pad>": 1, "<｜end▁of▁sentence｜>": 2}
    for ch in base:
        vocab[ch] = len(vocab)
    merges = []
    for a, b in [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("a", "n"), ("O", "C"), ("OC", "R"),
                 ("Ġ", "a"), ("o", "n"), ("r", "e"), ("Ġ", "s"), ("a", "t"), ("e", "n"), ("Ċ", "Ċ"), ("F", "r"),
                 ("Fr", "e"), ("Fre", "e"), ("Ġ", "O"), ("e", "d"), ("Ġ", "c"), ("o", "r"), ("i", "s"), ("a", "r"),
                 ("Ġ", "w"), ("i", "t"), ("Ġ", "b"), ("o", "u")]:
        if len(vocab) >= 127:
            break
        merges.append((a, b))
        vocab[a + b] = len(vocab)
    assert len(vocab) <= 127
    tok = Tokenizer(models.BPE(vocab, merges))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(r"\p{N}{1,3}"), behavior="isolated"),
        pre_tokenizers.Split(Regex(r"[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+"),
                             behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(["<image>"])
    spec = json.loads(tok.to_str())
    spec["added_tokens"][0]["id"] = 127  # <image> at the config's last id
    spec["model"]["vocab"] = vocab
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tiny_tokenizer_json(tmp_path_factory.mktemp("tiny") / "tokenizer.json")
    jax_engine = JaxEngine(jax_tiny(), dtype=jnp.float32, max_seq_len=512)
    state = params_from_jax(jax.device_get(jax_engine.params))
    return jax_engine, state, path


def port_engine(state):
    return DeepseekOcrEngine(tiny_deepseek_config(), dtype=torch.float32, device="cpu", max_seq_len=512,
                             state=state)


def tiny_states(tiny, engine_factory=None):
    jax_engine, state, path = tiny
    ref_tok, port_tok = ref_load_tokenizer(path), load_tokenizer(path)

    def ref_factory(model_id):
        return RefLoaded(model_id=model_id, engine=jax_engine, tokenizer=ref_tok, kind=RefKind.DEEPSEEK)

    def port_factory(model_id):
        return LoadedModel(model_id, port_engine(state), port_tok, ModelKind.DEEPSEEK)

    return (RefState(RefConfig.from_mapping(TINY_SETTINGS), allow_download=False, engine_factory=ref_factory),
            AppState(AppConfig.from_mapping(TINY_SETTINGS), engine_factory=engine_factory or port_factory))


@pytest.fixture()
def real(tiny, monkeypatch):
    for name in ("DSOCR_MAX_INFLIGHT", "DSOCR_PREFIX_CACHE", "DSOCR_PAGED_KV", "DSOCR_SLOTS"):
        monkeypatch.delenv(name, raising=False)
    ref_state, port_state = tiny_states(tiny)
    server = PortServer(port_state)
    yield ref_state, server
    server.close()


def test_tiny_engine_tokenizer_reads_alike(tiny):
    _, _, path = tiny
    ref, mine = Tokenizer.from_file(str(path)), load_tokenizer(path)
    for text in ("Free OCR.", "<image>\nFree OCR. 123 the OCR", "Read the text\n\nnow!"):
        assert mine.encode(text) == ref.encode(text, add_special_tokens=False).ids
    ids = list(range(130))
    assert mine.decode(ids) == ref.decode(ids) and mine.decode(ids, False) == ref.decode(ids, False)
    assert mine.token_to_id("<image>") == 127


@pytest.mark.parametrize("case", ["chat", "chat_stream", "responses", "responses_stream"])
def test_real_engine_answers_equal(real, case):
    ref_state, server = real
    body = {"chat": chat("deepseek-ocr", max_tokens=12), "chat_stream": chat("deepseek-ocr", True, max_tokens=12),
            "responses": responses_body("deepseek-ocr", max_output_tokens=12),
            "responses_stream": responses_body("deepseek-ocr", True, max_output_tokens=12)}[case]
    path = "/v1/responses" if case.startswith("responses") else "/v1/chat/completions"
    ref, port = ref_request(ref_state, "POST", path, body), server.request("POST", path, body)
    same_answer(ref, port, sse=case.endswith("stream"))
    if not case.endswith("stream"):
        usage = json.loads(port[2])["usage"]
        assert usage["prompt_tokens"] > 0 and 0 < usage["completion_tokens"] <= 12
    else:
        # the concatenated deltas are the final text before normalize_text
        # (which strips the trailing whitespace the deltas carried)
        evs = events(port[2])
        if case == "chat_stream":
            text = "".join(e["choices"][0]["delta"].get("content", "") for e in evs[1:-2])
            assert evs[-2]["choices"][0]["finish_reason"] == "stop"
        else:
            assert [e["type"] for e in (evs[0], evs[-2])] == ["response.created", "response.completed"]
            text = "".join(e["delta"] for e in evs[1:-2])
            assert normalize_text(text) == evs[-2]["response"]["output"][0]["content"][0]["text"]


@pytest.mark.parametrize("progressive", [False, True])
def test_real_engine_jpeg_data_url_answers_equal(real, progressive):
    """A JPEG page (decoded by Pillow in the reference's app, natively in
    the port's) answers 200 with the same body."""
    ref_state, server = real
    img = np.random.default_rng(3).integers(0, 256, (60, 70, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, progressive=progressive)
    body = chat("deepseek-ocr", max_tokens=12)
    body["messages"][0]["content"][1]["image_url"]["url"] = ("data:image/jpeg;base64,"
                                                             + base64.standard_b64encode(buf.getvalue()).decode())
    ref, port = ref_request(ref_state, "POST", "/v1/chat/completions", body), \
        server.request("POST", "/v1/chat/completions", body)
    assert port[0] == 200
    same_answer(ref, port)


@pytest.mark.parametrize("fmt, save", [("TIFF", {"compression": "group4"}), ("TIFF", {"compression": "tiff_lzw"}),
                                       ("BMP", {}), ("GIF", {})], ids=["g4", "lzw", "bmp", "gif"])
def test_real_engine_tiff_bmp_gif_data_urls_answer_equal(real, fmt, save):
    """A TIFF (G4 bilevel, LZW colour), BMP or GIF page (decoded by Pillow
    in the reference's app, natively in the port's) answers 200 with the
    same body."""
    ref_state, server = real
    img = Image.fromarray(np.random.default_rng(4).integers(0, 256, (60, 70, 3), dtype=np.uint8))
    if save.get("compression") == "group4":
        img = img.convert("1")
    buf = io.BytesIO()
    img.save(buf, format=fmt, **save)
    body = chat("deepseek-ocr", max_tokens=12)
    body["messages"][0]["content"][1]["image_url"]["url"] = (f"data:image/{fmt.lower()};base64,"
                                                             + base64.standard_b64encode(buf.getvalue()).decode())
    ref, port = ref_request(ref_state, "POST", "/v1/chat/completions", body), \
        server.request("POST", "/v1/chat/completions", body)
    assert port[0] == 200
    same_answer(ref, port)


@pytest.mark.parametrize("save", [{"quality": 80}, {"lossless": True}], ids=["lossy", "lossless"])
def test_real_engine_webp_data_url_answers_equal(real, save):
    """A WebP page (decoded by Pillow in the reference's app, natively in
    the port's) answers 200 with the same body; the lossless one answers
    as the same pixels sent as PNG."""
    ref_state, server = real
    img = Image.fromarray(np.random.default_rng(6).integers(0, 256, (60, 70, 3), dtype=np.uint8))
    answers = []
    for fmt, params in (("WEBP", save), ("PNG", {})):
        buf = io.BytesIO()
        img.save(buf, format=fmt, **params)
        body = chat("deepseek-ocr", max_tokens=12)
        body["messages"][0]["content"][1]["image_url"]["url"] = (f"data:image/{fmt.lower()};base64,"
                                                                 + base64.standard_b64encode(buf.getvalue()).decode())
        port = server.request("POST", "/v1/chat/completions", body)
        assert port[0] == 200
        answers.append(json.loads(port[2])["choices"][0]["message"]["content"])
        if fmt == "WEBP":
            same_answer(ref_request(ref_state, "POST", "/v1/chat/completions", body), port)
    if save.get("lossless"):
        assert answers[0] == answers[1]


@pytest.mark.parametrize("compression, name", [(50001, "WebP-compressed TIFF"), (32809, "ThunderScan-compressed TIFF")])
def test_jpeg_in_tiff_data_url_is_a_400_naming_it(fake, compression, name):
    _, server = fake
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="TIFF")
    raw = bytearray(buf.getvalue())
    at = raw.index(struct.pack("<HHLHH", 259, 3, 1, 1, 0))
    raw[at + 8:at + 10] = struct.pack("<H", compression)
    body = chat()
    body["messages"][0]["content"][1]["image_url"]["url"] = ("data:image/tiff;base64,"
                                                             + base64.standard_b64encode(bytes(raw)).decode())
    status, _, text = server.request("POST", "/v1/chat/completions", body)
    assert status == 400
    assert name in json.loads(text)["error"]["message"]


def test_real_engine_503_with_retry_after(real, monkeypatch):
    ref_state, server = real
    assert server.request("POST", "/v1/chat/completions", chat("deepseek-ocr", max_tokens=2))[0] == 200
    sched = server.state.scheduler
    sched.max_inflight, sched._inflight = 1, 1  # one request in flight under DSOCR_MAX_INFLIGHT=1
    try:
        status, headers, text = server.request("POST", "/v1/chat/completions", chat("deepseek-ocr", max_tokens=2))
    finally:
        sched._inflight = 0
    assert status == 503 and int(headers["Retry-After"]) >= 2
    assert json.loads(text)["error"]["type"] == "overloaded_error"
    assert "dsocr_shed_requests_total 1" in server.request("GET", "/metrics")[2]


def test_max_inflight_env_reaches_the_scheduler(tiny, monkeypatch):
    monkeypatch.setenv("DSOCR_MAX_INFLIGHT", "3")
    _, port_state = tiny_states(tiny)
    server = PortServer(port_state)
    try:
        assert server.request("POST", "/v1/chat/completions", chat("deepseek-ocr", max_tokens=1))[0] == 200
        assert port_state.scheduler.max_inflight == 3
    finally:
        server.close()


def test_client_leaving_mid_stream(real):
    """A streaming client that closes after its first delta: the server
    goes on, the request runs out and frees its slot, the next request
    answers 200."""
    _, server = real
    body = json.dumps(chat("deepseek-ocr", True, max_tokens=40)).encode()
    sock = socket.create_connection((server.host, server.port), timeout=TIMEOUT)
    sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(body) + body)
    got = b""
    while got.count(b"data: ") < 2:  # the role chunk and the first delta
        got += sock.recv(65536)
    sock.close()
    assert server.request("POST", "/v1/chat/completions", chat("deepseek-ocr", max_tokens=4))[0] == 200
    sched = server.state.scheduler

    async def drained():
        while sched._inflight or any(job is not None for job in sched._rows):
            await asyncio.sleep(0.01)

    server.run(asyncio.wait_for(drained(), TIMEOUT))
    assert server.request("GET", "/v1/health")[0] == 200


def test_swap_frees_the_old_engine_before_the_factory(tiny):
    """The factory of the second model finds the first one's engine
    unreferenced (a spy holds only a weak reference)."""
    _, state, path = tiny
    port_tok = load_tokenizer(path)
    built = []

    def factory(model_id):
        gc.collect()
        if built:
            assert built[-1]() is None, "the old engine is still referenced"
        engine = port_engine(state)
        built.append(weakref.ref(engine))
        return LoadedModel(model_id, engine, port_tok, ModelKind.DEEPSEEK)

    mapping = json.loads(json.dumps(TINY_SETTINGS))
    mapping["models"]["entries"]["deepseek-ocr-q8k"] = {"defaults": mapping["models"]["entries"]["deepseek-ocr"]
                                                        ["defaults"]}
    port_state = AppState(AppConfig.from_mapping(mapping), engine_factory=factory)
    server = PortServer(port_state)
    try:
        for model in ("deepseek-ocr", "deepseek-ocr-q8k", "deepseek-ocr"):
            status, _, text = server.request("POST", "/v1/chat/completions", chat(model, max_tokens=3))
            assert status == 200, text
        assert len(built) == 3
        assert "dsocr_model_swaps_total 3" in server.request("GET", "/metrics")[2]
    finally:
        server.close()


# -- (c) the new families: tiny OCR2 and PaddleOCR-VL engines ---------------------------------

FAMILY_SETTINGS = {"models": {"entries": {
    "deepseek-ocr-2": {"defaults": {"base_size": 128, "image_size": 128, "crop_mode": False,
                                    "no_repeat_ngram_size": 0}},
    "paddleocr-vl": {"defaults": {"no_repeat_ngram_size": 0}}}}}


def paddle_tokenizer_json(path):
    """A SentencePiece-shaped BPE (Metaspace, byte fallback) inside the tiny
    Paddle config's 256 ids: <unk>, <s>, </s>, a few byte tokens,
    printable ASCII and ▁, merges, and <|IMAGE_END|> at 252 (the config's
    image and vision-start ids, 250 and 251, are not text)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(0x20):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in ["▁"] + [chr(c) for c in range(33, 127)]:
        vocab[ch] = len(vocab)
    merges = []
    for a, b in [("▁", "F"), ("r", "e"), ("re", "e"), ("▁F", "ree"), ("▁", "O"), ("C", "R"), ("▁O", "CR"),
                 ("▁", "t"), ("h", "e"), ("▁t", "he"), ("▁", "a"), ("i", "n"), ("o", "n")]:
        merges.append((a, b))
        vocab[a + b] = len(vocab)
    assert len(vocab) < 250
    tok = Tokenizer(models.BPE(vocab, merges, unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    tok.decoder = decoders.Sequence([decoders.Metaspace(prepend_scheme="first"), decoders.ByteFallback(),
                                     decoders.Fuse()])
    tok.add_special_tokens(["<|IMAGE_END|>"])
    spec = json.loads(tok.to_str())
    spec["added_tokens"][0]["id"] = 252
    spec["model"]["vocab"]["<|IMAGE_END|>"] = 252
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture(scope="module")
def families(tmp_path_factory, tiny):
    import dataclasses as dc

    from dsocr_tpu.models.deepseek.ocr2 import tiny_qwen2_encoder_params as jax_tiny_q
    from dsocr_tpu.models.paddleocr import PaddleOcrEngine as JaxPaddle
    from dsocr_tpu.models.paddleocr.config import tiny_paddle_config as jax_tiny_paddle
    from dsocr_tpu_torch.models.deepseek.ocr2 import tiny_qwen2_encoder_params
    from dsocr_tpu_torch.models.paddleocr import PaddleOcrEngine, tiny_paddle_config
    from dsocr_tpu_torch.models.paddleocr import params_from_jax as paddle_from_jax

    jax_ocr2 = JaxEngine(dc.replace(jax_tiny(), variant="ocr2", clip=None), dtype=jnp.float32, max_seq_len=512,
                         ocr2_params=jax_tiny_q())
    ocr2_state = params_from_jax(jax.device_get(jax_ocr2.params))
    jax_paddle = JaxPaddle(jax_tiny_paddle(), dtype=jnp.float32, max_seq_len=512)
    paddle_state = paddle_from_jax(jax.device_get(jax_paddle.params))
    paddle_path = paddle_tokenizer_json(tmp_path_factory.mktemp("paddle") / "tokenizer.json")
    ocr2_path = tiny[2]

    def port(model_id):
        if model_id == "deepseek-ocr-2":
            engine = DeepseekOcrEngine(dc.replace(tiny_deepseek_config(), variant="ocr2", clip=None),
                                       dtype=torch.float32, device="cpu", max_seq_len=512, state=ocr2_state,
                                       ocr2_params=tiny_qwen2_encoder_params())
            return LoadedModel(model_id, engine, load_tokenizer(ocr2_path), ModelKind.DEEPSEEK)
        engine = PaddleOcrEngine(tiny_paddle_config(), dtype=torch.float32, device="cpu", max_seq_len=512,
                                 state=paddle_state)
        return LoadedModel(model_id, engine, load_tokenizer(paddle_path), ModelKind.PADDLE_OCR_VL)

    def ref(model_id):
        if model_id == "deepseek-ocr-2":
            return RefLoaded(model_id=model_id, engine=jax_ocr2, tokenizer=ref_load_tokenizer(ocr2_path),
                             kind=RefKind.DEEPSEEK)
        return RefLoaded(model_id=model_id, engine=jax_paddle, tokenizer=ref_load_tokenizer(paddle_path),
                         kind=RefKind.PADDLE_OCR_VL)

    return port, ref, paddle_path


def test_paddle_tokenizer_reads_alike(families):
    path = families[2]
    ref, mine = Tokenizer.from_file(str(path)), load_tokenizer(path)
    for text in ("Free OCR.", "the\tOCR ünïcode 東", "x<|IMAGE_END|>y"):
        assert mine.encode(text) == ref.encode(text, add_special_tokens=False).ids
    ids = list(range(256))
    assert mine.decode(ids) == ref.decode(ids) and mine.decode(ids, False) == ref.decode(ids, False)
    assert mine.token_to_id("<|IMAGE_END|>") == ref.token_to_id("<|IMAGE_END|>") == 252


@pytest.mark.parametrize("model", ["deepseek-ocr-2", "paddleocr-vl"])
def test_new_families_answer_equal(families, model, monkeypatch):
    for name in ("DSOCR_MAX_INFLIGHT", "DSOCR_PREFIX_CACHE", "DSOCR_PAGED_KV", "DSOCR_SLOTS"):
        monkeypatch.delenv(name, raising=False)
    port_factory, ref_factory, _ = families
    ref_state = RefState(RefConfig.from_mapping(FAMILY_SETTINGS), allow_download=False, engine_factory=ref_factory)
    server = PortServer(AppState(AppConfig.from_mapping(FAMILY_SETTINGS), engine_factory=port_factory))
    try:
        cases = [("/v1/chat/completions", chat(model, max_tokens=10), False),
                 ("/v1/chat/completions", chat(model, True, max_tokens=10), True),
                 ("/v1/responses", responses_body(model, max_output_tokens=10), False),
                 ("/v1/responses", responses_body(model, True, max_output_tokens=10), True)]
        refs = ref_requests(ref_state, [("POST", path, body) for path, body, _ in cases])
        for (path, body, sse), ref in zip(cases, refs):
            port = server.request("POST", path, body)
            same_answer(ref, port, sse=sse)
            if not sse:
                usage = json.loads(port[2])["usage"]
                assert usage["prompt_tokens"] > 0 and usage["completion_tokens"] > 0
    finally:
        server.close()


def test_swap_between_the_new_families_frees_the_old_engine(families):
    """deepseek-ocr-2 → paddleocr-vl → deepseek-ocr-2: each factory finds
    the previous engine unreferenced, and /metrics counts the swaps."""
    port_factory = families[0]
    built = []

    def factory(model_id):
        gc.collect()
        if built:
            assert built[-1]() is None, "the old engine is still referenced"
        loaded = port_factory(model_id)
        built.append(weakref.ref(loaded.engine))
        return loaded

    server = PortServer(AppState(AppConfig.from_mapping(FAMILY_SETTINGS), engine_factory=factory))
    try:
        for model in ("deepseek-ocr-2", "paddleocr-vl", "deepseek-ocr-2"):
            status, _, text = server.request("POST", "/v1/chat/completions", chat(model, max_tokens=3))
            assert status == 200, text
            assert json.loads(text)["model"] == model
        assert len(built) == 3
        assert "dsocr_model_swaps_total 3" in server.request("GET", "/metrics")[2]
    finally:
        server.close()


def test_engine_refusal_is_a_400(tiny):
    """An engine whose validate_slot_params refuses sampling (GLM-OCR's
    hook): a sampled chat request is a 400 naming the refusal, and a
    greedy one beside it a 200."""
    _, state, path = tiny

    class GreedyOnly(DeepseekOcrEngine):
        def validate_slot_params(self, params):
            if params.do_sample or params.temperature != 0.0:
                raise ValueError("GLM backend requires greedy decoding (do_sample=false)")

    def factory(model_id):
        engine = GreedyOnly(tiny_deepseek_config(), dtype=torch.float32, device="cpu", max_seq_len=512,
                            state=state)
        return LoadedModel(model_id, engine, load_tokenizer(path), ModelKind.DEEPSEEK)

    server = PortServer(AppState(AppConfig.from_mapping(TINY_SETTINGS), engine_factory=factory))
    try:
        status, _, text = server.request("POST", "/v1/chat/completions",
                                         chat("deepseek-ocr", max_tokens=4, temperature=0.8, do_sample=True))
        assert status == 400 and "greedy decoding" in json.loads(text)["error"]["message"]
        assert server.request("POST", "/v1/chat/completions", chat("deepseek-ocr", max_tokens=4))[0] == 200
    finally:
        server.close()


# -- (d) DotsOCR and GLM-OCR: tiny engines behind both servers ------------------------------

DOTS_GLM_SETTINGS = {"models": {"entries": {
    "dots-ocr": {"defaults": {"image_size": 64, "no_repeat_ngram_size": 0}},
    "glm-ocr": {"defaults": {"no_repeat_ngram_size": 0}}}}}


@pytest.fixture(scope="module")
def dots_glm(tiny):
    """Tiny DotsOCR and GLM-OCR engines of both packages on the same
    weights, behind the tiny byte-level tokenizer."""
    from dsocr_tpu.models.dots import DotsOcrEngine as JaxDots
    from dsocr_tpu.models.dots.config import tiny_dots_config as jax_tiny_dots
    from dsocr_tpu.models.glm import GlmOcrEngine as JaxGlm
    from dsocr_tpu.models.glm.config import tiny_glm_config as jax_tiny_glm
    from dsocr_tpu_torch.models import dots, glm

    path = tiny[2]
    jax_engines = {"dots-ocr": JaxDots(jax_tiny_dots(), dtype=jnp.float32, max_seq_len=1024),
                   "glm-ocr": JaxGlm(jax_tiny_glm(), dtype=jnp.float32, max_seq_len=1024)}
    states = {"dots-ocr": dots.params_from_jax(jax.device_get(jax_engines["dots-ocr"].params)),
              "glm-ocr": glm.params_from_jax(jax.device_get(jax_engines["glm-ocr"].params))}
    kinds = {"dots-ocr": (ModelKind.DOTS_OCR, RefKind.DOTS_OCR), "glm-ocr": (ModelKind.GLM_OCR, RefKind.GLM_OCR)}

    def port(model_id):
        if model_id == "dots-ocr":
            engine = dots.DotsOcrEngine(dots.tiny_dots_config(), dtype=torch.float32, device="cpu",
                                        max_seq_len=1024, state=states[model_id])
        else:
            engine = glm.GlmOcrEngine(glm.tiny_glm_config(), dtype=torch.float32, device="cpu", max_seq_len=1024,
                                      state=states[model_id])
        return LoadedModel(model_id, engine, load_tokenizer(path), kinds[model_id][0])

    def ref(model_id):
        return RefLoaded(model_id=model_id, engine=jax_engines[model_id], tokenizer=ref_load_tokenizer(path),
                         kind=kinds[model_id][1])

    return port, ref


@pytest.mark.parametrize("model", ["dots-ocr", "glm-ocr"])
def test_dots_and_glm_answer_equal(dots_glm, model, monkeypatch):
    """Chat and responses, plain and streamed, equal to the reference
    server's; for GLM a sampled request is the same 400 in both."""
    for name in ("DSOCR_MAX_INFLIGHT", "DSOCR_PREFIX_CACHE", "DSOCR_PAGED_KV", "DSOCR_SLOTS"):
        monkeypatch.delenv(name, raising=False)
    port_factory, ref_factory = dots_glm
    ref_state = RefState(RefConfig.from_mapping(DOTS_GLM_SETTINGS), allow_download=False, engine_factory=ref_factory)
    server = PortServer(AppState(AppConfig.from_mapping(DOTS_GLM_SETTINGS), engine_factory=port_factory))
    try:
        cases = [("/v1/chat/completions", chat(model, max_tokens=8), False),
                 ("/v1/chat/completions", chat(model, True, max_tokens=8), True),
                 ("/v1/responses", responses_body(model, max_output_tokens=8), False)]
        if model == "glm-ocr":
            cases.append(("/v1/chat/completions", chat(model, max_tokens=8, temperature=0.7, do_sample=True), False))
        refs = ref_requests(ref_state, [("POST", path, body) for path, body, _ in cases])
        for (path, body, sse), want in zip(cases, refs):
            got = server.request("POST", path, body)
            same_answer(want, got, sse=sse)
        if model == "glm-ocr":
            assert got[0] == 400 and "greedy" in json.loads(got[2])["error"]["message"]
    finally:
        server.close()
