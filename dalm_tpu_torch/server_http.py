"""HTTP serving front end for :class:`dalm_tpu_torch.serve.RagPipeline`
(counterpart of ``dalm_tpu/server_http.py``).

Standard library only (``http.server``). It serves the pipeline's
retrieval, continuous-batching decode and token streaming over plain
HTTP:

- ``GET  /healthz``          → ``{"status": "ok", "passages": N}``
- ``POST /answer``           body ``{"query": ..., "top_k"?: k,
  "budget"?: n}`` → ``{"answer", "passages", "scores"}``
- ``POST /stream``           same body → ``text/plain`` CHUNKED response
  whose chunks are answer text decoded incrementally (tokens flush as
  the scheduler produces them; requests share the slot pool and join
  mid-flight — ``models/streaming.py``).

OpenAI-compatible surface (for openai-SDK clients pointed at
``base_url=http://host:port/v1``; the retrieval context rides along in
the response's ``dalm`` extension field):

- ``GET  /v1/models``             → one model, id ``dalm-rag``
- ``POST /v1/chat/completions``   messages → the last user message is
  the retrieval query; ``stream: true`` sends SSE delta chunks ending
  with ``data: [DONE]``; ``max_tokens`` caps the decode budget; the
  non-standard ``top_k`` passes through to retrieval.
- ``POST /v1/completions``        ``prompt`` (string) as the query.

Routes, status codes, JSON keys, error messages and byte framing are the
reference's.

Concurrency: ``ThreadingHTTPServer`` gives each request a thread; all of
them submit into ONE streaming session whose scheduler thread owns the
decode engine, so concurrent requests batch onto the device rather than
queueing behind each other. Each request thread retrieves its own query
(``RagStreamSession.submit``: the embedder, then K3 at one query) under
``torch.no_grad()`` with the pipeline's device current, while the
scheduler thread decodes. A client that goes away frees its decode slot.
``shutdown`` closes the listener, drains the session and raises if the
scheduler crashed while serving.

Start it from Python (the ``dalm serve`` command waits for the port's CLI)::

    srv = serve_pipeline(pipe, port=8080, background=True)
    ...
    srv.shutdown()
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)

_MARKER = "#answer#"
_request_ids = itertools.count()


def _incremental_deltas(handle, tok, marker: str = _MARKER):
    """Yield answer-text deltas as tokens decode; final item is
    ``(None, n_tokens)``.

    The full prefix re-decodes each flush (subword/byte tokenizers
    cannot decode tokens independently) and a marker-sized tail is held
    back so a partially decoded stop marker never reaches the wire
    (sent bytes cannot be retracted)."""
    ids, sent = [], 0
    for t in handle.tokens():
        ids.append(t)
        text = tok.decode(ids, skip_special_tokens=True).split(marker)[0]
        safe = max(sent, len(text) - (len(marker) - 1))
        if safe > sent:
            yield text[sent:safe]
            sent = safe
    text = tok.decode(ids, skip_special_tokens=True).split(marker)[0]
    if len(text) > sent:
        yield text[sent:]
    yield (None, len(ids))


class RagHTTPServer:
    """Wraps a RagPipeline + streaming session behind an HTTP server."""

    def __init__(self, pipe, host: str = "127.0.0.1", port: int = 8080, num_slots: int = 32,
                 decode_chunk: int = 8):
        self.pipe = pipe
        self.session = pipe.stream(num_slots=num_slots, decode_chunk=decode_chunk)
        self.session.__enter__()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer framing requires HTTP/1.1 (the 1.0 default
            # would make strict clients read raw chunk markers)
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging, not stderr
                logger.debug("http: " + fmt, *args)

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_request(self) -> Optional[dict]:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._json(400, {"error": "invalid JSON body"})
                    return None
                if not isinstance(req, dict) or not isinstance(req.get("query"), str):
                    self._json(400, {"error": "body must be {\"query\": str, ...}"})
                    return None
                return req

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def _end_chunks(self) -> None:
                self.wfile.write(b"0\r\n\r\n")

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", "passages": len(outer.pipe.passages)})
                elif self.path == "/v1/models":
                    self._json(200, {
                        "object": "list",
                        "data": [{"id": "dalm-rag", "object": "model",
                                  "created": int(time.time()), "owned_by": "dalm-tpu"}],
                    })
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path == "/answer":
                    req = self._read_request()
                    if req is None:
                        return
                    # clamp to [1, corpus size]: oversized k surfaces padded
                    # index rows with out-of-range global ids
                    top_k = max(1, min(int(req.get("top_k", 4)), len(outer.pipe.passages)))
                    h = outer.session.submit(
                        req["query"], top_k=top_k,
                        budget=req.get("budget"),
                    )
                    self._json(200, {
                        "answer": h.answer(),
                        "passages": h.passages,
                        "scores": h.scores,
                    })
                elif self.path == "/stream":
                    req = self._read_request()
                    if req is None:
                        return
                    # clamp to [1, corpus size]: oversized k surfaces padded
                    # index rows with out-of-range global ids
                    top_k = max(1, min(int(req.get("top_k", 4)), len(outer.pipe.passages)))
                    h = outer.session.submit(
                        req["query"], top_k=top_k,
                        budget=req.get("budget"),
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; charset=utf-8")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for delta in _incremental_deltas(h, outer.pipe.g_tok):
                            if isinstance(delta, tuple):
                                break
                            self._chunk(delta.encode("utf-8"))
                        self._end_chunks()
                    except (BrokenPipeError, ConnectionResetError):
                        # client went away: free the decode slot immediately
                        # instead of burning its remaining budget
                        h.cancel()
                elif self.path in ("/v1/chat/completions", "/v1/completions"):
                    self._openai(chat=self.path.endswith("chat/completions"))
                else:
                    self._json(404, {"error": "unknown path"})

            # ---- OpenAI-compatible surface -----------------------------
            def _openai(self, chat: bool) -> None:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    assert isinstance(req, dict)
                except (ValueError, json.JSONDecodeError, AssertionError):
                    self._json(400, {"error": {"message": "invalid JSON body",
                                               "type": "invalid_request_error"}})
                    return
                try:
                    if chat:
                        msgs = req.get("messages")
                        if not isinstance(msgs, list):
                            raise ValueError("messages must be a list")
                        query = next(
                            (m.get("content") for m in reversed(msgs)
                             if isinstance(m, dict) and m.get("role") == "user"
                             and isinstance(m.get("content"), str)),
                            None,
                        )
                    else:
                        query = req.get("prompt")
                        if isinstance(query, list):
                            # OpenAI batch-prompt semantics are not supported:
                            # reject multi-prompt lists instead of silently
                            # answering only the first element.
                            if len(query) != 1 or not isinstance(query[0], str):
                                raise ValueError(
                                    "prompt lists with more than one element are "
                                    "not supported; send one prompt per request"
                                )
                            query = query[0]
                    if not isinstance(query, str) or not query:
                        field = "messages (one user message)" if chat else "prompt"
                        raise ValueError(f"missing {field}")
                    budget = req.get("max_tokens")
                    budget = int(budget) if budget is not None else None
                    top_k = int(req.get("top_k", 4))
                    if top_k < 1:
                        raise ValueError("top_k must be >= 1")
                    # > corpus size would surface padded index rows whose
                    # global ids exceed len(passages); clamp to the corpus.
                    top_k = min(top_k, len(outer.pipe.passages))
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": {"message": str(e),
                                               "type": "invalid_request_error"}})
                    return

                h = outer.session.submit(query, top_k=top_k, budget=budget)
                rid = f"{'chatcmpl' if chat else 'cmpl'}-{next(_request_ids)}"
                created = int(time.time())
                model = req.get("model") or "dalm-rag"
                # usage: re-tokenize with the SAME truncation submit applied
                # (serve.py builds the prompt from the top passage, padded/
                # truncated to max_prompt_len)
                prompt_toks = int(sum(
                    outer.pipe.g_tok(
                        [f"#query# {query} #passage# {h.passages[0]} #answer# "],
                        truncation=True, max_length=outer.pipe.max_prompt_len,
                    )["attention_mask"][0]
                ))
                dalm_ext = {"passages": h.passages, "scores": h.scores}
                # effective decode cap (StreamingEngine clamps to the
                # engine's max_new): finish_reason must reflect truncation
                max_new = outer.session._server.engine.max_new
                cap = min(budget, max_new) if budget is not None else max_new

                def finish_reason(n_tokens: int) -> str:
                    return "length" if n_tokens >= cap else "stop"

                if req.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def sse(payload: dict) -> None:
                        self._chunk(b"data: " + json.dumps(payload).encode() + b"\n\n")

                    def chunk_obj(delta: dict, finish=None) -> dict:
                        if chat:
                            return {"id": rid, "object": "chat.completion.chunk",
                                    "created": created, "model": model,
                                    "choices": [{"index": 0, "delta": delta,
                                                 "finish_reason": finish}]}
                        return {"id": rid, "object": "text_completion",
                                "created": created, "model": model,
                                "choices": [{"index": 0, "text": delta.get("content", ""),
                                             "finish_reason": finish}]}

                    try:
                        if chat:
                            first = chunk_obj({"role": "assistant"})
                            first["dalm"] = dalm_ext  # retrieval context
                            sse(first)
                        n_tokens = 0
                        for delta in _incremental_deltas(h, outer.pipe.g_tok):
                            if isinstance(delta, tuple):
                                n_tokens = delta[1]
                                break
                            sse(chunk_obj({"content": delta}))
                        final = chunk_obj({}, finish=finish_reason(n_tokens))
                        final["usage"] = {
                            "prompt_tokens": prompt_toks,
                            "completion_tokens": n_tokens,
                            "total_tokens": prompt_toks + n_tokens,
                        }
                        if not chat:
                            final["dalm"] = dalm_ext
                        sse(final)
                        self._chunk(b"data: [DONE]\n\n")
                        self._end_chunks()
                    except (BrokenPipeError, ConnectionResetError):
                        h.cancel()
                    return

                answer = h.answer()
                n_tokens = len(h._handle.result())
                usage = {"prompt_tokens": prompt_toks,
                         "completion_tokens": n_tokens,
                         "total_tokens": prompt_toks + n_tokens}
                if chat:
                    self._json(200, {
                        "id": rid, "object": "chat.completion", "created": created,
                        "model": model,
                        "choices": [{"index": 0,
                                     "message": {"role": "assistant", "content": answer},
                                     "finish_reason": finish_reason(n_tokens)}],
                        "usage": usage, "dalm": dalm_ext,
                    })
                else:
                    self._json(200, {
                        "id": rid, "object": "text_completion", "created": created,
                        "model": model,
                        "choices": [{"index": 0, "text": answer,
                                     "finish_reason": finish_reason(n_tokens),
                                     "logprobs": None}],
                        "usage": usage, "dalm": dalm_ext,
                    })

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start_background(self) -> "RagHTTPServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True, name="rag-http")
        self._thread.start()
        logger.info("serving on http://%s:%d", self.host, self.port)
        return self

    def serve_forever(self) -> None:
        logger.info("serving on http://%s:%d", self.host, self.port)
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Close the listener, then drain the session; raises if its scheduler crashed while serving."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.session.__exit__(None, None, None)
        crashed = self.session._server._crashed
        if crashed is not None:
            raise RuntimeError("the decode scheduler crashed while serving") from crashed


def serve_pipeline(pipe, host: str = "127.0.0.1", port: int = 8080,
                   num_slots: int = 32, background: bool = False) -> RagHTTPServer:
    """Start an HTTP server over ``pipe``; blocks unless ``background``."""
    srv = RagHTTPServer(pipe, host=host, port=port, num_slots=num_slots)
    if background:
        return srv.start_background()
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()
    return srv
