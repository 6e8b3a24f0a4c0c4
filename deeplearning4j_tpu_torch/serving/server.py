"""ModelServer — the HTTP front end of the serving tier (counterpart of
deeplearning4j_tpu/serving/server.py). A stdlib ``ThreadingHTTPServer``
over a :class:`~deeplearning4j_tpu_torch.serving.router.ModelRouter`:

    POST /v1/models/<id>/infer     {"inputs": [[...], ...]}  -> {"outputs": ...}
    POST /v1/models/<id>/generate  {"prompt_tokens": [[...], ...],
                                    "max_new_tokens": 16}    -> {"tokens": ...}
    GET  /v1/models                registry and per-model scheduler counts
    GET  /healthz                  {"ok": true, "models": [...]}

Connections persist (HTTP/1.1 with ``Content-Length`` on every response),
and every POST reads its whole body before answering. Status codes follow
the reference: an unknown model answers 404, a malformed body 400, a shed
request 429 (503 once stopped) with ``Retry-After`` (a generate batch the
paged KV pool cannot hold among them), a failed batch 500. A generate body
takes ``prompt_tokens`` (one prompt or a list; ``prompts`` also reads),
``max_new_tokens``, ``temperature``, ``eos_id``, ``lane`` (default
``"batch"``) and ``deadline_ms``; each prompt is one scheduler request.

Not ported yet (ROADMAP Queue 1 item 11b): request ids
(``X-Request-Id``), drain signals and ``/admin``, ``/metrics``, ``/slo``,
the flight-recorder route and ``reload``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.router import (ModelRouter,
                                                     UnknownModelError)
from deeplearning4j_tpu_torch.serving.scheduler import ShedError


class _ServingHTTPServer(ThreadingHTTPServer):
    # a connection burst wider than the stdlib accept backlog must queue in
    # the kernel, not be reset: admission control is the scheduler's job
    request_queue_size = 128
    daemon_threads = True


class ModelServer:
    """HTTP model server over a router (see module doc)."""

    def __init__(self, router: ModelRouter, port: int = 0,
                 host: str = "127.0.0.1", request_timeout_s: float = 60.0):
        self.router = router
        self.host = host
        self.port = port
        self.request_timeout_s = float(request_timeout_s)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, warmup: bool = True) -> "ModelServer":
        if warmup:
            self.router.warmup()
        self._httpd = _ServingHTTPServer((self.host, self.port),
                                         _make_handler(self))
        self.port = self._httpd.server_address[1]  # resolves port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="model-server")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self.router.shutdown()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _handle_infer(self, model_id: str, body: dict) -> dict:
        x = np.asarray(body["inputs"], np.float32)
        if x.ndim < 2:
            x = x[None]
        fut = self.router.submit(
            model_id, x, lane=body.get("lane", "interactive"),
            deadline_ms=body.get("deadline_ms"))
        out = fut.result(timeout=self.request_timeout_s)
        return {"model": model_id, "outputs": np.asarray(out).tolist()}

    def _handle_generate(self, model_id: str, body: dict) -> dict:
        """The generate route (reference ``:186``): each prompt one
        scheduler request with the body's options; on a shed or timeout
        the prompts still queued are cancelled."""
        prompts = body.get("prompt_tokens", body.get("prompts"))
        if prompts is None:
            raise ValueError("generate needs prompt_tokens")
        if prompts and isinstance(prompts[0], (int, float)):
            prompts = [prompts]  # one prompt
        opts = {"max_new_tokens": int(body.get("max_new_tokens", 16))}
        if body.get("temperature"):
            opts["temperature"] = float(body["temperature"])
        if body.get("eos_id") is not None:
            opts["eos_id"] = int(body["eos_id"])
        futs = []
        try:
            for p in prompts:
                futs.append(self.router.submit(
                    model_id, np.asarray(p, np.int64),
                    lane=body.get("lane", "batch"),
                    deadline_ms=body.get("deadline_ms"), **opts))
            toks = [f.result(timeout=self.request_timeout_s) for f in futs]
        except Exception:
            for f in futs:
                f.cancel()
            raise
        return {"model": model_id, "tokens": toks}


def _make_handler(server: ModelServer):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send_json(self, status: int, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                self._send_json(200, {"ok": True,
                                      "models": server.router.model_ids()})
            elif path in ("/v1/models", "/v1/models/"):
                self._send_json(200, server.router.status())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            # read the body first on every path: an unread body would
            # desynchronize the persistent connection
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            parts = self.path.strip("/").split("/")
            if len(parts) != 4 or parts[:2] != ["v1", "models"] \
                    or parts[3] not in ("infer", "generate"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            model_id, verb = parts[2], parts[3]
            try:
                server.router.get(model_id)
                body = json.loads(raw or b"{}")
                handle = (server._handle_generate if verb == "generate"
                          else server._handle_infer)
                self._send_json(200, handle(model_id, body))
            except UnknownModelError as e:
                self._send_json(404, {"error": f"unknown model {e}"})
            except ShedError as e:
                self._send_json(
                    e.http_status,
                    {"error": type(e).__name__, "detail": str(e)},
                    headers=[("Retry-After",
                              str(int(max(1, e.retry_after_s))))])
            except (KeyError, ValueError, TypeError) as e:
                self._send_json(400, {"error": f"bad request: {e!r}"})
            except Exception as e:  # noqa: BLE001 — a broken batch must
                self._send_json(500, {"error": repr(e)})  # not kill the srv

    return Handler
