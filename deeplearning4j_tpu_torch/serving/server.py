"""ModelServer — the HTTP front end of the serving tier (counterpart of
deeplearning4j_tpu/serving/server.py, whole). A stdlib
``ThreadingHTTPServer`` over a
:class:`~deeplearning4j_tpu_torch.serving.router.ModelRouter`:

    POST /v1/models/<id>/infer     {"inputs": [[...], ...]}  -> {"outputs": ...}
    POST /v1/models/<id>/generate  {"prompt_tokens": [[...], ...],
                                    "max_new_tokens": 16}    -> {"tokens": ...}
    POST /v1/models/<id>/reload    {"path": "..."}           -> {"version": n}
    GET  /v1/models                registry and per-model scheduler state,
                                   and this process's kernel launches
    GET  /v1/models/<id>/debug/requests[?last=N]   flight-recorder dump
    GET  /metrics                  Prometheus text (the telemetry registry)
    GET  /healthz                  health JSON with the serving and slo
                                   sections; 503 when unhealthy
    GET  /slo                      the SLO engine's evaluation
    GET  /admin/status             pid, worker_id, draining, drained, models
    POST /admin/drain              begin graceful drain (idempotent, 200)

Connections persist (HTTP/1.1 with ``Content-Length`` on every response),
and every POST reads its whole body before answering. Every POST honours
an inbound ``X-Request-Id`` (or mints one) and echoes it on the response,
success and error alike; a multi-prompt generate gives its requests the
id with a ``/<row>`` suffix. Status codes follow the reference: an unknown
model answers 404, a malformed body 400, a shed request 429 (503 while
draining, when the breaker is open or the worker is dead) with
``Retry-After`` (the paged KV pool's refusal among them), a rejected
reload 409 (the live version keeps serving), a failed batch 500. A
generate body takes ``prompt_tokens`` (one prompt or a list; ``prompts``
also reads), ``max_new_tokens``, ``temperature``, ``eos_id``, ``lane``
(default ``"batch"``) and ``deadline_ms``; each prompt is one scheduler
request.

Graceful drain: ``drain_signals`` (default SIGTERM) are trapped when the
server starts on the main thread; the signal, ``POST /admin/drain`` or
:meth:`ModelServer.request_drain` stop admission (new requests 503),
finish what is queued, and set ``drained``. ``worker_id`` names the
process to a fleet supervisor (``/admin/status``).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.ops import kernels as kern
from deeplearning4j_tpu_torch.serving.resilience import (ModelLoadError,
                                                         ReloadRejectedError)
from deeplearning4j_tpu_torch.serving.router import (ModelRouter,
                                                     UnknownModelError)
from deeplearning4j_tpu_torch.serving.scheduler import (ShedError,
                                                        new_request_id)
from deeplearning4j_tpu_torch.util import telemetry as tm


class _ServingHTTPServer(ThreadingHTTPServer):
    # a connection burst wider than the stdlib accept backlog must queue in
    # the kernel, not be reset: admission control is the scheduler's job
    request_queue_size = 128
    daemon_threads = True


class ModelServer:
    """HTTP model server over a router (see module doc)."""

    def __init__(self, router: ModelRouter, port: int = 0,
                 host: str = "127.0.0.1",
                 drain_signals=(signal.SIGTERM,),
                 request_timeout_s: float = 60.0,
                 worker_id: Optional[str] = None):
        self.router = router
        self.host = host
        self.port = port
        self.drain_signals = tuple(drain_signals)
        self.request_timeout_s = float(request_timeout_s)
        #: the fleet's name for this process (``/admin/status``)
        self.worker_id = worker_id
        self.drained = False
        self._draining = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._old_handlers: dict = {}

    # ----------------------------------------------------------- lifecycle
    def start(self, warmup: bool = True) -> "ModelServer":
        if warmup:
            self.router.warmup()
        self._httpd = _ServingHTTPServer((self.host, self.port),
                                         _make_handler(self))
        self.port = self._httpd.server_address[1]  # resolves port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="model-server")
        self._thread.start()
        self._install_signal_handlers()
        tm.set_health("serving.accepting", True,
                      f"listening on {self.host}:{self.port}")
        return self

    def _install_signal_handlers(self):
        try:
            for sig in self.drain_signals:
                self._old_handlers[sig] = signal.signal(
                    sig, self._on_drain_signal)
        except ValueError:
            # not the main thread: drain stays available through
            # request_drain() and POST /admin/drain
            self._old_handlers = {}

    def _restore_signal_handlers(self):
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._old_handlers = {}

    def _on_drain_signal(self, signum, frame):
        tm.counter("serving.drain_signals_total")
        self.request_drain()

    def request_drain(self, timeout: float = 30.0) -> "ModelServer":
        """Begin graceful drain (idempotent): stop admitting, finish queued
        work in the background, then set ``drained``. Returns at once;
        poll ``drained`` or call :meth:`wait_drained`."""
        if self._draining:
            return self
        self._draining = True
        tm.set_health("serving.accepting", False, "draining")

        def _drain():
            clean = self.router.drain(timeout=timeout)
            self.drained = True
            tm.set_health("serving.drained", True,
                          f"drained clean={clean}")

        threading.Thread(target=_drain, daemon=True,
                         name="serving-drain").start()
        return self

    def wait_drained(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while not self.drained and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.drained

    @property
    def draining(self) -> bool:
        return self._draining

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self._restore_signal_handlers()
        self.router.shutdown()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------ handlers
    def _handle_infer(self, model_id: str, body: dict,
                      request_id: Optional[str] = None) -> dict:
        x = np.asarray(body["inputs"], np.float32)
        if x.ndim < 2:
            x = x[None]
        fut = self.router.submit(
            model_id, x, lane=body.get("lane", "interactive"),
            deadline_ms=body.get("deadline_ms"), request_id=request_id)
        out = fut.result(timeout=self.request_timeout_s)
        return {"model": model_id, "outputs": np.asarray(out).tolist()}

    def _handle_generate(self, model_id: str, body: dict,
                         request_id: Optional[str] = None) -> dict:
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
            for i, p in enumerate(prompts):
                rid = None if request_id is None else (
                    request_id if len(prompts) == 1
                    else f"{request_id}/{i}")
                futs.append(self.router.submit(
                    model_id, np.asarray(p, np.int64),
                    lane=body.get("lane", "batch"),
                    deadline_ms=body.get("deadline_ms"),
                    request_id=rid, **opts))
            toks = [f.result(timeout=self.request_timeout_s) for f in futs]
        except Exception:
            for f in futs:
                f.cancel()
            raise
        return {"model": model_id, "tokens": toks}


def _make_handler(server: ModelServer):
    from deeplearning4j_tpu_torch.util.ui_server import UIServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, status: int, body: bytes,
                  ctype: str = "application/json", headers=()):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, obj, headers=()):
            self._send(status, json.dumps(obj).encode(), headers=headers)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            parts = u.path.strip("/").split("/")
            if u.path == "/metrics":
                self._send(200, UIServer._metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif u.path == "/healthz":
                body, ok = UIServer._healthz(server.router.serving_device())
                self._send(200 if ok else 503, body.encode())
            elif u.path == "/slo":
                self._send(200, UIServer._slo_json().encode())
            elif u.path == "/admin/status":
                # the process's identity for a fleet supervisor: never
                # touches a scheduler, so a wedged model cannot hide it
                self._send_json(200, {
                    "pid": os.getpid(),
                    "worker_id": server.worker_id,
                    "draining": server.draining,
                    "drained": server.drained,
                    "models": server.router.model_ids(),
                })
            elif u.path in ("/v1/models", "/v1/models/"):
                # the port's own: the kernel wrappers' counts in this
                # process, so a fleet's caller can see what its workers
                # launched (each worker is a process of its own)
                self._send_json(200, {
                    **server.router.status(),
                    "kernels": {"launches": dict(kern.LAUNCHES),
                                "plain_on_cuda": dict(kern.PLAIN_ON_CUDA)}})
            elif len(parts) == 5 and parts[:2] == ["v1", "models"] \
                    and parts[3:] == ["debug", "requests"]:
                try:
                    last = int(parse_qs(u.query).get("last", [0])[0]) or None
                except ValueError:
                    last = None
                try:
                    records = server.router.debug_requests(parts[2],
                                                           last=last)
                except UnknownModelError as e:
                    self._send_json(404, {"error": f"unknown model {e}"})
                    return
                self._send_json(200, {"model": parts[2],
                                      "requests": records})
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            # read the body first on every path: an unread body would
            # desynchronize the persistent connection
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            parts = self.path.strip("/").split("/")
            if parts == ["admin", "drain"]:
                # the drain verb for a front tier that cannot signal the
                # process (adopted workers): as SIGTERM, idempotent
                server.request_drain()
                self._send_json(200, {"draining": True})
                return
            if len(parts) != 4 or parts[:2] != ["v1", "models"] \
                    or parts[3] not in ("infer", "generate", "reload"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            model_id, verb = parts[2], parts[3]
            rid = self.headers.get("X-Request-Id") or new_request_id()
            rid_hdr = [("X-Request-Id", rid)]
            if server.draining:
                self._send_json(
                    503, {"error": "draining", "model": model_id},
                    headers=[("Retry-After", "10")] + rid_hdr)
                return
            try:
                body = json.loads(raw or b"{}")
                if verb == "infer":
                    resp = server._handle_infer(model_id, body,
                                                request_id=rid)
                elif verb == "reload":
                    resp = {"model": model_id,
                            "version": server.router.reload(
                                model_id, body["path"])}
                else:
                    resp = server._handle_generate(model_id, body,
                                                   request_id=rid)
                resp["request_id"] = rid
                self._send_json(200, resp, headers=rid_hdr)
            except UnknownModelError as e:
                self._send_json(404, {"error": f"unknown model {e}"},
                                headers=rid_hdr)
            except (ModelLoadError, ReloadRejectedError) as e:
                # a conflict with the live version, which keeps serving
                self._send_json(409, {"error": type(e).__name__,
                                      "detail": str(e)},
                                headers=rid_hdr)
            except ShedError as e:
                self._send_json(
                    e.http_status,
                    {"error": type(e).__name__, "detail": str(e),
                     "request_id": rid},
                    headers=[("Retry-After",
                              str(int(max(1, e.retry_after_s))))] + rid_hdr)
            except (KeyError, ValueError, TypeError) as e:
                self._send_json(400, {"error": f"bad request: {e!r}"},
                                headers=rid_hdr)
            except Exception as e:  # noqa: BLE001 - a broken batch must
                self._send_json(500, {"error": repr(e)},  # not kill the
                                headers=rid_hdr)          # server

    return Handler
