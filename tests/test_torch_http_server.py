"""The port's HTTP front end against the JAX package's, on the CPU, in f32.

Two servers side by side, each on port 0 over equal tiny pipelines (the
same weights carried across by ``interop``): ``dalm_tpu.server_http`` over
the JAX ``RagPipeline`` and ``dalm_tpu_torch.server_http`` over the port's.
Every request of ``tests/test_http_server.py`` goes to both over a raw
socket. Status lines and headers (but ``Date``, and ``Content-Length``,
which must match each body) are equal; a JSON body is
equal but for ``id``, ``created`` and the retrieval scores, which agree
within 1e-5; a chunked body is checked for its framing, and is equal byte
for byte (``/stream``) or event for event, as JSON is (SSE). Then, on the port alone: concurrent clients; a
client that closes a stream after its first chunk, whose decode slot comes
back; a scheduler that crashes, which ``shutdown`` raises.
"""

import json
import re
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dalm_tpu.core.mesh import unbox
from dalm_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dalm_tpu.models import decoder as jdec
from dalm_tpu.models import encoder as jenc
from dalm_tpu.models.embedder import SentenceEmbedder as JaxEmbedder
from dalm_tpu.serve import RagPipeline as JaxRagPipeline
from dalm_tpu.server_http import RagHTTPServer as JaxRagHTTPServer
from dalm_tpu_torch.data.tokenizer import ByteTokenizer
from dalm_tpu_torch.interop import load_params
from dalm_tpu_torch.models.decoder import Decoder, DecoderConfig
from dalm_tpu_torch.models.embedder import SentenceEmbedder
from dalm_tpu_torch.models.encoder import EncoderConfig
from dalm_tpu_torch.serve import RagPipeline
from dalm_tpu_torch.server_http import RagHTTPServer, _incremental_deltas, serve_pipeline

PASSAGES = [f"passage {i} about metro-{i} and its {i} towers" for i in range(8)]
OPTS = dict(max_passage_len=32, max_prompt_len=64, max_new_tokens=5, embed_batch=8)
WAIT = 120


@pytest.fixture(scope="module")
def weights():
    retriever = JaxEmbedder(jenc.EncoderConfig.tiny())
    r_params = jax.tree.map(np.asarray, unbox(retriever.init_params(jax.random.PRNGKey(0))))
    generator = jdec.Decoder(jdec.DecoderConfig.tiny())
    ids = jnp.zeros((1, 8), jnp.int32)
    g_params = jax.tree.map(np.asarray, unbox(generator.init(jax.random.PRNGKey(1), ids, jnp.ones_like(ids))["params"]))
    return retriever, r_params, generator, g_params


def _port_pipeline(weights, **kw):
    _, r_params, _, g_params = weights
    return RagPipeline(load_params(SentenceEmbedder(EncoderConfig.tiny()), r_params), ByteTokenizer(),
                       load_params(Decoder(DecoderConfig.tiny()), g_params), ByteTokenizer(), PASSAGES, device="cpu",
                       **dict(OPTS, **kw))


@pytest.fixture(scope="module")
def servers(weights):
    retriever, r_params, generator, g_params = weights
    ref = JaxRagPipeline(retriever, r_params, JaxByteTokenizer(), generator, g_params, JaxByteTokenizer(), PASSAGES,
                         **OPTS)
    j_srv = JaxRagHTTPServer(ref, host="127.0.0.1", port=0, num_slots=2, decode_chunk=2).start_background()
    pipe = _port_pipeline(weights)
    srv = RagHTTPServer(pipe, host="127.0.0.1", port=0, num_slots=2, decode_chunk=2).start_background()
    yield j_srv, srv, pipe
    j_srv.shutdown()
    srv.shutdown()


def _raw(srv, method, path, body=None):
    """One request over a fresh socket: (status line, headers without Date, body bytes as sent)."""
    data = b"" if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    head = (f"{method} {path} HTTP/1.1\r\nHost: {srv.host}:{srv.port}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n").encode()
    with socket.create_connection((srv.host, srv.port), timeout=WAIT) as s:
        s.sendall(head + data)
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    top, _, payload = raw.partition(b"\r\n\r\n")
    status, *lines = top.decode("latin-1").split("\r\n")
    headers = [ln for ln in lines if not ln.startswith("Date:")]
    return status, headers, payload


def _dechunk(payload: bytes) -> list:
    """The chunks of a chunked body, with its framing checked (hex size, CRLF, the closing zero chunk)."""
    chunks, rest = [], payload
    while True:
        size, sep, rest = rest.partition(b"\r\n")
        assert sep and re.fullmatch(rb"[0-9A-F]+", size), payload
        n = int(size, 16)
        if n == 0:
            assert rest == b"\r\n", payload
            return chunks
        assert rest[n:n + 2] == b"\r\n", payload
        chunks.append(rest[:n])
        rest = rest[n + 2:]


def _strip_ids(obj: dict) -> dict:
    """Without ``id`` and ``created``; the retrieval scores (top level or in the ``dalm`` field) become a
    ``Close`` that compares within 1e-5: both sides compute them in f32 in another order."""
    obj = {k: v for k, v in obj.items() if k not in ("id", "created")}
    for holder in (obj, obj.get("dalm") or {}):
        if "scores" in holder:
            holder["scores"] = Close(holder["scores"])
    return obj


class Close:
    def __init__(self, values):
        self.values = values

    def __eq__(self, other):
        return len(self.values) == len(other.values) and np.allclose(self.values, other.values, rtol=0, atol=1e-5)

    def __repr__(self):
        return f"Close({self.values})"


def _json_body(payload: bytes):
    obj = json.loads(payload)
    if isinstance(obj, dict) and obj.get("object") == "list":  # /v1/models: created is the clock
        obj["data"] = [_strip_ids(m) for m in obj["data"]]
    return _strip_ids(obj) if isinstance(obj, dict) else obj


def _sse_events(payload: bytes) -> list:
    events = []
    for chunk in _dechunk(payload):
        assert chunk.startswith(b"data: ") and chunk.endswith(b"\n\n"), chunk
        event = chunk[len(b"data: "):-2]
        events.append(event.decode() if event == b"[DONE]" else _strip_ids(json.loads(event)))
    return events


CHAT = "/v1/chat/completions"
CASES = {
    "healthz": ("GET", "/healthz", None),
    "unknown-get": ("GET", "/nope", None),
    "unknown-post": ("POST", "/nope", {"query": "q"}),
    "answer": ("POST", "/answer", {"query": "what about metro-3", "top_k": 2}),
    "answer-defaults": ("POST", "/answer", {"query": "what about metro-6"}),
    "answer-budget-big-k": ("POST", "/answer", {"query": "what about metro-1", "top_k": 99, "budget": 3}),
    "stream": ("POST", "/stream", {"query": "what about metro-5", "top_k": 2}),
    "bad-request": ("POST", "/answer", {"nope": 1}),
    "bad-json": ("POST", "/stream", b"{not json"),
    "models": ("GET", "/v1/models", None),
    "chat": ("POST", CHAT, {"model": "dalm-rag", "top_k": 2, "messages": [
        {"role": "system", "content": "you answer from passages"}, {"role": "user", "content": "what about metro-5"}]}),
    "completion": ("POST", "/v1/completions", {"prompt": "what about metro-2", "top_k": 2}),
    "completion-list": ("POST", "/v1/completions", {"prompt": ["what about metro-2"], "max_tokens": 3}),
    "completion-two-prompts": ("POST", "/v1/completions", {"prompt": ["a", "b"]}),
    "chat-stream": ("POST", CHAT, {"messages": [{"role": "user", "content": "what about metro-7"}], "stream": True,
                                   "top_k": 2}),
    "completion-stream": ("POST", "/v1/completions", {"prompt": "what about metro-4", "stream": True, "top_k": 2}),
    "openai-bad-request": ("POST", CHAT, {"messages": []}),
    "openai-bad-json": ("POST", CHAT, b"[1, 2"),
    "finish-length": ("POST", CHAT, {"messages": [{"role": "user", "content": "what about metro-1"}],
                                     "max_tokens": 2, "top_k": 2}),
    "bad-max-tokens": ("POST", CHAT, {"messages": [{"role": "user", "content": "q"}], "max_tokens": "abc"}),
    "bad-top-k": ("POST", CHAT, {"messages": [{"role": "user", "content": "q"}], "top_k": [2]}),
    "bad-top-k-zero": ("POST", CHAT, {"messages": [{"role": "user", "content": "q"}], "top_k": 0}),
    "bad-messages": ("POST", CHAT, {"messages": 5}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_endpoint_matches_reference(servers, case):
    j_srv, srv, _ = servers
    method, path, body = CASES[case]
    j_status, j_headers, j_payload = _raw(j_srv, method, path, body)
    status, headers, payload = _raw(srv, method, path, body)
    assert status == j_status
    sized = [(h, p) for h, p in ((headers, payload), (j_headers, j_payload)) if "Transfer-Encoding: chunked" not in h]
    for h, p in sized:  # a float's digits set the length of a JSON body
        assert f"Content-Length: {len(p)}" in h
    assert [h for h in headers if not h.startswith("Content-Length")] == \
        [h for h in j_headers if not h.startswith("Content-Length")]
    if "Transfer-Encoding: chunked" not in headers:
        assert _json_body(payload) == _json_body(j_payload)
    elif "Content-Type: text/event-stream" in headers:
        events = _sse_events(payload)
        assert events == _sse_events(j_payload) and events[-1] == "[DONE]"
        assert events[-2]["usage"]["completion_tokens"] == 5
    else:
        assert payload == j_payload and len(_dechunk(payload)) >= 1


def test_answers_equal_the_pipeline_and_concurrent_clients(servers):
    """Five clients at once on two slots: each answer equals both pipelines' ``answer()``."""
    j_srv, srv, pipe = servers
    queries = [f"what about metro-{i}" for i in range(5)]
    results, errors = {}, []

    def go(q):
        try:
            req = urllib.request.Request(f"http://{srv.host}:{srv.port}/answer", method="POST",
                                         data=json.dumps({"query": q, "top_k": 2}).encode())
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                results[q] = json.loads(r.read())["answer"]
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not errors and not any(t.is_alive() for t in threads)
    want = [a.answer for a in pipe.answer(queries, top_k=2)]
    assert [results[q] for q in queries] == want
    assert want == [a.answer for a in j_srv.pipe.answer(queries, top_k=2)]
    assert srv.session._server.free_slots == 2


def test_incremental_deltas_hold_back_a_marker_tail():
    """A marker split over tokens never reaches the wire; the last item counts the tokens."""
    tok = ByteTokenizer()

    class Handle:
        def tokens(self):
            return iter(tok.encode("hello world #answer# tail"))

    deltas = list(_incremental_deltas(Handle(), tok))
    assert deltas[-1] == (None, len("hello world #answer# tail"))
    assert "".join(deltas[:-1]) == "hello world " and all("#" not in d for d in deltas[:-1])


@pytest.fixture
def slow_server(weights):
    """A port server whose requests decode 48 tokens, a decode chunk of 2 tokens taking at least 50 ms, so a
    stream lasts over a second; yields it and the handles it gave out."""
    srv = RagHTTPServer(_port_pipeline(weights, max_new_tokens=48), port=0, num_slots=2, decode_chunk=2)
    eng, handles = srv.session._server.engine, []
    chunk, submit = eng._decode_chunk, srv.session.submit

    def slow_chunk(*a):
        time.sleep(0.05)
        return chunk(*a)

    def recording_submit(*a, **kw):
        handles.append(submit(*a, **kw))
        return handles[-1]

    eng._decode_chunk, srv.session.submit = slow_chunk, recording_submit
    yield srv.start_background(), handles
    if srv._thread.is_alive():
        srv.shutdown()


def test_client_that_goes_away_frees_its_slot(slow_server):
    srv, handles = slow_server
    body = json.dumps({"query": "what about metro-2"}).encode()
    with socket.create_connection((srv.host, srv.port), timeout=WAIT) as s:
        s.sendall(f"POST /stream HTTP/1.1\r\nHost: x\r\nConnection: close\r\nContent-Length: {len(body)}\r\n\r\n"
                  .encode() + body)
        got = b""
        while b"\r\n\r\n" not in got or not re.search(rb"\r\n\r\n[0-9A-F]+\r\n.", got, re.S):
            got += s.recv(1)  # the headers and the first byte of the first chunk, then hang up
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))  # reset the connection on close
    assert len(handles) == 1
    handles[0]._handle.result(timeout=WAIT)
    server = srv.session._server
    deadline = time.monotonic() + WAIT
    while server.free_slots != 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.free_slots == 2
    assert 0 < len(handles[0]._handle.result()) < 48  # cancelled before its budget
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/healthz", timeout=WAIT) as r:
        assert json.loads(r.read())["status"] == "ok"  # still serving
    srv.shutdown()


def test_scheduler_crash_reaches_shutdown(slow_server):
    srv, handles = slow_server

    def boom(*a):
        raise RuntimeError("decode failed")

    srv.session._server.engine._decode_chunk = boom
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/answer", method="POST",
                                 data=json.dumps({"query": "what about metro-2"}).encode())
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        urllib.request.urlopen(req, timeout=WAIT)
    with pytest.raises(RuntimeError, match="crashed") as e:
        srv.shutdown()
    assert "decode failed" in str(e.value.__cause__)


def test_serve_pipeline_in_background(weights):
    srv = serve_pipeline(_port_pipeline(weights), port=0, num_slots=1, background=True)
    try:
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/healthz", timeout=WAIT) as r:
            assert json.loads(r.read()) == {"status": "ok", "passages": 8}
    finally:
        srv.shutdown()
    assert not srv._thread.is_alive()
