"""Serving fleet (counterpart of deeplearning4j_tpu/serving/fleet.py,
whole): a front-tier HTTP router over N worker ``ModelServer`` processes.

One process holds one GIL, one accept loop, one scheduler per model. A
:class:`FleetRouter` spawns (or adopts) N worker processes
(``serving/fleet_worker.py``), each running the whole single-process
stack behind its own ``ModelServer`` with its own CUDA context, schedulers
and KV block pool, and proxies ``/v1/models/...`` traffic to them over
persistent HTTP/1.1 connections.

Routing:

- **Prefix affinity**: a generate request hashes the model id and its
  first prompt's head (``affinity_head`` tokens, ``DL4J_TPU_AFFINITY_HEAD``
  or 16) with rendezvous (highest random weight) hashing over the live
  ring, keyed by blake2b so every router process and every respawn agrees;
  streams sharing a head land on the worker whose prefix cache holds it,
  and a worker leaving the ring moves only its own keys.
- **Least-loaded**: a request without a prompt (classify), or an affinity
  pick already ``overflow_depth`` deep while a peer is shallower, goes to
  the ring member with the fewest requests in flight (rotating tiebreak).
- **Failover**: a connection-level failure (refused, reset, truncated)
  retries on another live worker; HTTP errors are relayed verbatim, never
  retried. Every worker failing answers 502, an empty ring 503 with
  ``Retry-After``, a timed-out worker 504 (not retried: it may still be
  running the request).

Each decision counts
``serving.fleet.routing_decisions_total{reason=affinity|least_loaded|failover}``.
A poller reads each worker's ``/healthz`` and ``/v1/models``; an
unhealthy or draining worker leaves the ring without taking the fleet
down. A dead worker process (SIGKILL, OOM) is respawned by the supervisor
under :data:`~deeplearning4j_tpu_torch.serving.resilience.FLEET_RESPAWN_POLICY`
backoff and re-enters the ring when its ``/healthz`` is green.

Rolling reload: ``POST /v1/models/<id>/reload`` on the router goes worker
by worker, each swap canary-checked by the worker before the next starts;
the others serve meanwhile, versions only advance, and the spawn spec is
rewritten so a respawn loads the new weights.

    from deeplearning4j_tpu_torch.serving.fleet import FleetRouter, fleet_spec

    spec = fleet_spec(models=[{"id": "lenet", "path": "lenet.zip",
                               "kind": "classify"}])
    fleet = FleetRouter(spec, n_workers=2).start()  # workers on the card
    ...                                    # http://host:port/v1/models/...
    fleet.stop()

A spec's ``device`` (``fleet_spec(..., device="cpu")``) is where every
worker restores its models; without one they go to the card, and a worker
that finds none exits non-zero, which ``start`` reports with the worker's
log.
"""

from __future__ import annotations

import http.client
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from hashlib import blake2b
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.serving.resilience import (FLEET_RESPAWN_POLICY,
                                                   FleetUnavailableError,
                                                   ModelLoadError,
                                                   ReloadRejectedError,
                                                   WorkerProxyError)
from deeplearning4j_tpu_torch.serving.scheduler import new_request_id
from deeplearning4j_tpu_torch.serving.server import _ServingHTTPServer
from deeplearning4j_tpu_torch.util import telemetry as tm

#: default prompt-head length hashed for prefix affinity. 16 tokens cover
#: a shared system-prompt head at one prefix-cache block (block_size=16)
#: while still splitting prompts that diverge early (the reference tunes
#: it as a dimension of its tuning space; the port reads
#: DL4J_TPU_AFFINITY_HEAD).
DEFAULT_AFFINITY_HEAD = 16


def default_affinity_head() -> int:
    try:
        return int(os.environ.get("DL4J_TPU_AFFINITY_HEAD",
                                  DEFAULT_AFFINITY_HEAD))
    except ValueError:
        return DEFAULT_AFFINITY_HEAD


# ---------------------------------------------------------------- hashing
def rendezvous_score(key: bytes, member: str) -> int:
    """HRW score of ``member`` for ``key``: a keyed blake2b digest — NOT
    Python ``hash()``, which is salted per process and would make every
    router instance (and every respawn) disagree about placement."""
    h = blake2b(key + b"\x00" + member.encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def rendezvous_pick(key: bytes, members: Sequence[str]) -> str:
    """The ring member owning ``key``: highest rendezvous score wins.
    Order-independent in ``members``; removing one member moves ONLY the
    keys it owned (the classic HRW minimal-disruption property — asserted
    in tests/test_fleet.py)."""
    if not members:
        raise ValueError("rendezvous_pick: empty member set")
    return max(members, key=lambda m: (rendezvous_score(key, m), m))


def affinity_key(model_id: str, prompt_tokens, head: int) -> Optional[bytes]:
    """Routing key for a generate request: the model id + the first
    ``head`` prompt tokens (the shared-system-prompt region the radix
    cache deduplicates). None when affinity is off (head<=0) or there is
    no prompt — the request falls back to least-loaded."""
    if head <= 0 or not prompt_tokens:
        return None
    toks = [int(t) for t in list(prompt_tokens)[:head]]
    return json.dumps([model_id, toks]).encode()


# ------------------------------------------------------------ proxy errors
class _ProxyConnError(RuntimeError):
    """One proxy attempt failed at the connection level (failover-able)."""


class _ProxyTimeoutError(RuntimeError):
    """The worker accepted the request but the response timed out. NOT
    failed over — the worker may still be executing it; duplicating the
    work would double load exactly when the fleet is slowest. Maps to
    504."""


class FleetWorker:
    """One worker slot: the process handle (when spawned), its URL, health
    as seen by the poller, the in-flight depth the router tracks, and a
    small pool of persistent connections."""

    def __init__(self, worker_id: str, *, url: Optional[str] = None,
                 adopted: bool = False, max_pool: int = 32):
        self.worker_id = worker_id
        self.adopted = adopted
        self.proc: Optional[subprocess.Popen] = None
        self.pid: Optional[int] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        # up | booting | backoff | dead | stopping
        self.state = "booting"
        self.healthy = False
        self.draining = False
        self.inflight = 0
        self.restarts = 0
        self.consecutive_poll_failures = 0
        self.next_spawn_t = 0.0
        self.healthy_since: Optional[float] = None
        self.ready_file: Optional[str] = None
        self.log_path: Optional[str] = None
        self.spawned_at = 0.0
        self.models: Dict[str, dict] = {}  # /v1/models snapshot
        self._max_pool = int(max_pool)
        self._conns: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        if url is not None:
            self.set_url(url)
            self.state = "up"

    # ------------------------------------------------------------ address
    def set_url(self, url: str):
        m = re.match(r"^https?://([^:/]+):(\d+)/?$", url)
        if not m:
            raise ValueError(f"worker url must be http://host:port, "
                             f"got {url!r}")
        self.host, self.port = m.group(1), int(m.group(2))

    @property
    def url(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"http://{self.host}:{self.port}"

    @property
    def in_ring(self) -> bool:
        return self.state == "up" and self.healthy and not self.draining

    @property
    def alive(self) -> bool:
        if self.adopted:
            return self.state == "up"
        return self.proc is not None and self.proc.poll() is None

    # ------------------------------------------------------- in-flight
    def inc_inflight(self):
        with self._lock:
            self.inflight += 1

    def dec_inflight(self):
        with self._lock:
            self.inflight = max(0, self.inflight - 1)

    # ------------------------------------------------- connection pool
    def acquire_conn(self, timeout_s: float
                     ) -> Tuple[http.client.HTTPConnection, bool]:
        """(connection, was_reused). Reused connections may be stale
        (worker restarted behind the keep-alive socket); the proxy retries
        once on a fresh one before declaring a connection failure."""
        with self._lock:
            if self._conns:
                conn = self._conns.pop()
                conn.timeout = timeout_s
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
                return conn, True
        if self.port is None:
            raise _ProxyConnError(f"{self.worker_id}: no address yet")
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s), False

    def release_conn(self, conn: http.client.HTTPConnection):
        with self._lock:
            if len(self._conns) < self._max_pool:
                self._conns.append(conn)
                return
        conn.close()

    def close_conns(self):
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    # ------------------------------------------------------------ status
    def describe(self) -> dict:
        models = {}
        for mid, doc in self.models.items():
            entry = {"version": doc.get("version"),
                     "queue_depth": doc.get("queue_depth"),
                     "breaker": (doc.get("breaker") or {}).get("state")
                     if isinstance(doc.get("breaker"), dict)
                     else doc.get("breaker")}
            hit = doc.get("prefix_hit_rate")
            if hit is None:
                cache = (doc.get("kv_pool") or {}).get("prefix_cache") or {}
                hit = cache.get("hit_rate")
            if hit is not None:
                entry["prefix_cache_hit_rate"] = hit
            models[mid] = entry
        return {
            "url": self.url,
            "pid": self.pid,
            "state": self.state,
            "adopted": self.adopted,
            "alive": self.alive,
            "healthy": self.healthy,
            "draining": self.draining,
            "in_ring": self.in_ring,
            "inflight": self.inflight,
            "restarts": self.restarts,
            "models": models,
        }


class FleetRouter:
    """Front-tier router over N worker processes (see module docstring).

    ``spec`` is the worker boot recipe (:func:`fleet_spec`): models as
    ModelSerializer archives + register/ServingModel kwargs, the device,
    and the environment — what ``serving.fleet_worker`` replays in each
    worker process. Alternatively
    ``adopt`` takes a list of already-running worker URLs (supervision and
    respawn are then off: the fleet does not own those processes).

    Knobs: ``affinity_head`` (prompt-head tokens hashed for affinity, 0
    disables; default ``DL4J_TPU_AFFINITY_HEAD`` or 16),
    ``overflow_depth`` (in-flight depth at which an
    affinity pick spills to least-loaded), ``health_interval_s`` (poller
    cadence), ``respawn``/``max_restarts`` (supervisor budget; the budget
    resets after ``restart_reset_s`` healthy seconds, the scheduler
    watchdog convention), ``boot_timeout_s`` (spawn → ready deadline).
    """

    def __init__(self, spec: Optional[dict] = None, n_workers: int = 2, *,
                 adopt: Optional[Sequence[str]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = "fleet",
                 affinity_head: Optional[int] = None,
                 overflow_depth: int = 8,
                 health_interval_s: float = 0.25,
                 respawn: bool = True, max_restarts: int = 8,
                 restart_reset_s: float = 30.0,
                 boot_timeout_s: float = 180.0,
                 request_timeout_s: float = 60.0,
                 fleet_dir: Optional[str] = None,
                 worker_env: Optional[dict] = None):
        if spec is None and not adopt:
            raise ValueError("FleetRouter needs a worker spec or adopt=[urls]")
        self.spec = spec
        self.name = name
        self.host = host
        self.port = port
        self.affinity_head = (default_affinity_head()
                              if affinity_head is None else int(affinity_head))
        self.overflow_depth = int(overflow_depth)
        self.health_interval_s = float(health_interval_s)
        self.respawn = bool(respawn) and spec is not None
        self.max_restarts = int(max_restarts)
        self.restart_reset_s = float(restart_reset_s)
        self.boot_timeout_s = float(boot_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.fleet_dir = fleet_dir
        self.worker_env = dict(worker_env or {})
        self.workers: List[FleetWorker] = []
        if adopt:
            for i, url in enumerate(adopt):
                self.workers.append(
                    FleetWorker(f"w{i}", url=url, adopted=True))
        else:
            for i in range(int(n_workers)):
                self.workers.append(FleetWorker(f"w{i}"))
        self._by_id = {w.worker_id: w for w in self.workers}
        self._spec_path: Optional[str] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._poller: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._stopping = False
        self._reload_lock = threading.Lock()
        self._rr = itertools.count()
        self._decisions = {"affinity": 0, "least_loaded": 0, "failover": 0}
        self._decisions_lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "FleetRouter":
        if self.spec is not None:
            if self.fleet_dir is None:
                self.fleet_dir = tempfile.mkdtemp(prefix="dl4j_fleet_")
            os.makedirs(self.fleet_dir, exist_ok=True)
            self._spec_path = os.path.join(self.fleet_dir, "spec.json")
            self._write_spec()
            for w in self.workers:
                self._spawn(w)
            deadline = time.monotonic() + self.boot_timeout_s
            for w in self.workers:
                if not self._wait_ready(w, deadline):
                    rc = w.proc.poll() if w.proc is not None else None
                    self.stop()
                    raise RuntimeError(
                        f"fleet worker {w.worker_id} failed to become "
                        f"ready within {self.boot_timeout_s:.0f}s "
                        f"(exit code {rc}; log: {w.log_path}):\n"
                        f"{_log_tail(w.log_path)}")
        else:
            # adopted workers: one synchronous poll so the ring is correct
            # before the first request
            for w in self.workers:
                self._poll_worker(w)
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name=f"{self.name}-health")
        self._poller.start()
        self._supervisor = threading.Thread(target=self._supervise_loop,
                                            daemon=True,
                                            name=f"{self.name}-supervise")
        self._supervisor.start()
        handler = _make_fleet_handler(self)
        self._httpd = _ServingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name=f"{self.name}-http")
        self._thread.start()
        _FLEETS.add(self)
        tm.set_health(f"serving.fleet.{self.name}", True,
                      f"{len(self._ring())}/{len(self.workers)} in ring "
                      f"on {self.url}")
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def worker(self, worker_id: str) -> FleetWorker:
        return self._by_id[worker_id]

    def stop(self, kill_timeout_s: float = 10.0):
        """Stop the front tier and the worker processes it owns (SIGTERM →
        graceful worker drain → SIGKILL stragglers). Adopted workers are
        left running — the fleet never owned them."""
        self._stopping = True
        self._stop_evt.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for w in self.workers:
            w.state = "stopping"
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + kill_timeout_s
        for w in self.workers:
            if w.proc is None:
                continue
            remaining = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                try:
                    w.proc.kill()
                    w.proc.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            w.close_conns()
        for w in self.workers:
            w.close_conns()
        _FLEETS.discard(self)
        tm.set_health(f"serving.fleet.{self.name}", True, "stopped")

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ spawning
    def _write_spec(self):
        tmp = f"{self._spec_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.spec, f, indent=1)
        os.replace(tmp, self._spec_path)  # atomic: a respawn mid-write
        # never reads a torn spec (the ModelSerializer publish idiom)

    def _spawn(self, w: FleetWorker):
        w.ready_file = os.path.join(self.fleet_dir,
                                    f"{w.worker_id}.ready.json")
        w.log_path = os.path.join(self.fleet_dir, f"{w.worker_id}.log")
        try:
            os.unlink(w.ready_file)
        except OSError:
            pass
        env = dict(os.environ)
        env.update({str(k): str(v)
                    for k, v in (self.spec.get("env") or {}).items()})
        env.update({str(k): str(v) for k, v in self.worker_env.items()})
        # the worker imports this checkout's package wherever it runs
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m",
               "deeplearning4j_tpu_torch.serving.fleet_worker",
               "--spec", self._spec_path,
               "--worker-id", w.worker_id,
               "--ready-file", w.ready_file]
        with open(w.log_path, "ab") as logf:
            w.proc = subprocess.Popen(cmd, stdout=logf,
                                      stderr=subprocess.STDOUT, env=env)
        w.pid = w.proc.pid
        w.state = "booting"
        w.healthy = False
        w.healthy_since = None
        w.consecutive_poll_failures = 0
        w.port = None
        w.spawned_at = time.monotonic()
        w.close_conns()
        tm.counter("serving.fleet.worker_spawns_total", fleet=self.name,
                   worker=w.worker_id)

    def _try_adopt_ready(self, w: FleetWorker) -> bool:
        """Read the worker's ready file if it appeared since the spawn."""
        if w.port is not None or not w.ready_file:
            return w.port is not None
        try:
            # the file was unlinked before the spawn, so its existence
            # means THIS incarnation finished warmup and bound its port
            with open(w.ready_file) as f:
                doc = json.load(f)
            w.host = doc.get("host") or "127.0.0.1"
            w.port = int(doc["port"])
            w.pid = int(doc.get("pid", w.pid or 0)) or w.pid
            return True
        except (OSError, ValueError, KeyError):
            return False

    def _wait_ready(self, w: FleetWorker, deadline: float) -> bool:
        while time.monotonic() < deadline:
            if w.proc is not None and w.proc.poll() is not None:
                return False  # died during boot
            if self._try_adopt_ready(w):
                self._poll_worker(w)
                if w.healthy:
                    w.state = "up"
                    w.healthy_since = time.monotonic()
                    return True
            time.sleep(0.1)
        return False

    # ------------------------------------------------------------- polling
    def _worker_get(self, w: FleetWorker, path: str,
                    timeout_s: float = 5.0) -> Tuple[int, bytes]:
        conn = http.client.HTTPConnection(w.host, w.port, timeout=timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _poll_worker(self, w: FleetWorker):
        if w.port is None or w.state in ("backoff", "dead", "stopping"):
            return
        try:
            status, body = self._worker_get(w, "/healthz", timeout_s=3.0)
            doc = json.loads(body)
            w.draining = bool(
                (doc.get("serving") or {}).get("draining", False))
            w.healthy = status == 200
            w.consecutive_poll_failures = 0
            if w.healthy and w.state == "booting":
                w.state = "up"
            if w.healthy and w.healthy_since is None:
                w.healthy_since = time.monotonic()
            if not w.healthy:
                w.healthy_since = None
            mstatus, mbody = self._worker_get(w, "/v1/models", timeout_s=3.0)
            if mstatus == 200:
                mdoc = json.loads(mbody)
                w.models = mdoc.get("models", {})
                if mdoc.get("draining"):
                    w.draining = True
        except (OSError, http.client.HTTPException, ValueError):
            w.consecutive_poll_failures += 1
            # 3 consecutive failed probes drop the worker from the ring
            # (one flaky probe must not churn placement and cold-start
            # every prefix cache downstream of a rendezvous reshuffle)
            if w.consecutive_poll_failures >= 3:
                w.healthy = False
                w.healthy_since = None

    def _poll_loop(self):
        while not self._stop_evt.wait(self.health_interval_s):
            for w in list(self.workers):
                self._poll_worker(w)

    # --------------------------------------------------------- supervision
    def _supervise_loop(self):
        while not self._stop_evt.wait(0.2):
            now = time.monotonic()
            for w in list(self.workers):
                if w.adopted or w.state == "stopping":
                    continue
                rc = w.proc.poll() if w.proc is not None else None
                if rc is not None and w.state in ("up", "booting"):
                    # the process is gone (SIGKILL, OOM, crash): out of
                    # the ring NOW — in-flight proxies to it fail over —
                    # then respawn under backoff
                    w.state = "dead"
                    w.healthy = False
                    w.healthy_since = None
                    w.close_conns()
                    tm.counter("serving.fleet.worker_deaths_total",
                               fleet=self.name, worker=w.worker_id)
                    if self.respawn and w.restarts < self.max_restarts:
                        w.restarts += 1
                        delays = FLEET_RESPAWN_POLICY.delays() or [1.0]
                        d = delays[min(w.restarts - 1, len(delays) - 1)]
                        w.next_spawn_t = now + d
                        w.state = "backoff"
                elif w.state == "backoff" and now >= w.next_spawn_t:
                    self._spawn(w)
                elif w.state == "booting":
                    if self._try_adopt_ready(w):
                        pass  # poller promotes to "up" on green healthz
                    elif now - w.spawned_at > self.boot_timeout_s:
                        try:
                            w.proc.kill()
                        except OSError:
                            pass
                        # fall through next tick: poll() != None → dead
                elif (w.state == "up" and w.restarts and
                      w.healthy_since is not None and
                      now - w.healthy_since > self.restart_reset_s):
                    # healthy long enough: forgive past crashes so a
                    # worker that recovered does not run out of budget
                    # over the fleet's lifetime (watchdog convention)
                    w.restarts = 0

    # ------------------------------------------------------------- routing
    def _ring(self) -> List[FleetWorker]:
        return [w for w in self.workers if w.in_ring]

    def _least_loaded(self, ring: Sequence[FleetWorker]) -> FleetWorker:
        # rotating tiebreak: at equal depth (the common idle case) the
        # pick rotates instead of always hitting w0
        rot = next(self._rr) % len(ring)
        order = list(ring[rot:]) + list(ring[:rot])
        return min(order, key=lambda w: w.inflight)

    def _count(self, reason: str):
        tm.counter("serving.fleet.routing_decisions_total", reason=reason,
                   fleet=self.name)
        with self._decisions_lock:
            self._decisions[reason] = self._decisions.get(reason, 0) + 1

    def pick_worker(self, model_id: str, verb: str,
                    body: Optional[dict]) -> Tuple[FleetWorker, str]:
        """(worker, reason) for one request. Raises
        :class:`FleetUnavailableError` when the ring is empty."""
        ring = self._ring()
        if not ring:
            raise FleetUnavailableError(
                f"fleet {self.name!r}: no live workers in the ring")
        key = None
        if verb == "generate" and body is not None:
            prompts = body.get("prompt_tokens", body.get("prompts"))
            if prompts and isinstance(prompts[0], (int, float)):
                first = prompts
            elif prompts:
                first = prompts[0]
            else:
                first = None
            key = affinity_key(model_id, first, self.affinity_head)
        if key is None:
            return self._least_loaded(ring), "least_loaded"
        wid = rendezvous_pick(key, sorted(w.worker_id for w in ring))
        w = self._by_id[wid]
        least = self._least_loaded(ring)
        if w.inflight >= self.overflow_depth and least.inflight < w.inflight:
            # the affinity target is saturated and a peer is strictly
            # shallower: spill — a hot prefix must not starve a worker
            return least, "least_loaded"
        return w, "affinity"

    # -------------------------------------------------------------- proxy
    def _proxy_once(self, w: FleetWorker, method: str, path: str,
                    body: bytes, rid: Optional[str],
                    timeout_s: Optional[float] = None
                    ) -> Tuple[int, bytes, dict]:
        timeout_s = self.request_timeout_s if timeout_s is None else timeout_s
        hdrs = {"Content-Type": "application/json"}
        if rid:
            hdrs["X-Request-Id"] = rid
        fresh_retry = False
        while True:
            conn, reused = w.acquire_conn(timeout_s)
            try:
                conn.request(method, path, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                out_headers = dict(resp.getheaders())
                if resp.headers.get("Connection", "").lower() == "close":
                    conn.close()
                else:
                    w.release_conn(conn)
                return resp.status, data, out_headers
            except TimeoutError:
                conn.close()
                raise _ProxyTimeoutError(
                    f"{w.worker_id}: no response within {timeout_s:.0f}s")
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                conn.close()
                if reused and not fresh_retry:
                    # a pooled keep-alive socket can be stale (worker
                    # restarted behind it): one fresh-connection retry
                    # before declaring the worker unreachable
                    fresh_retry = True
                    continue
                raise _ProxyConnError(
                    f"{w.worker_id}: {type(e).__name__}: {e}") from e

    def proxy(self, model_id: str, verb: str, method: str, path: str,
              raw: bytes, body: Optional[dict], rid: Optional[str]
              ) -> Tuple[int, bytes, dict]:
        """Route one request and proxy it, failing over across the ring on
        connection-level errors. Returns (status, body, headers) from the
        worker that answered."""
        w, reason = self.pick_worker(model_id, verb, body)
        tried: set = set()
        while True:
            self._count(reason)
            cur = w
            cur.inc_inflight()
            try:
                return self._proxy_once(cur, method, path, raw, rid)
            except _ProxyConnError as e:
                tried.add(cur.worker_id)
                cur.consecutive_poll_failures += 1
                cur.close_conns()
                candidates = [x for x in self._ring()
                              if x.worker_id not in tried]
                if not candidates:
                    raise WorkerProxyError(
                        f"fleet {self.name!r}: every live worker failed "
                        f"at the connection level for {path} "
                        f"(last: {e})") from e
                w = self._least_loaded(candidates)
                reason = "failover"
            finally:
                cur.dec_inflight()

    # ------------------------------------------------------ rolling reload
    def rolling_reload(self, model_id: str, path: str) -> Dict[str, int]:
        """Fan ``POST /v1/models/<id>/reload`` worker-by-worker, waiting
        for each canary-validated swap (the worker's 200) before the next.
        The rest of the ring serves throughout — zero fleet-level shed.
        Returns {worker_id: new_version}. A worker's 409 (structure
        mismatch / failed canary) aborts the roll: already-swapped workers
        keep the new version, the rest keep the old — both validated, and
        the next roll converges them."""
        with self._reload_lock:
            ring = sorted(self._ring(), key=lambda w: w.worker_id)
            if not ring:
                raise FleetUnavailableError(
                    f"fleet {self.name!r}: no live workers to reload")
            payload = json.dumps({"path": path}).encode()
            versions: Dict[str, int] = {}
            for w in ring:
                # a reload restores + warms the archive before swapping:
                # give it more room than a data-plane request
                status, data, _hdrs = self._proxy_once(
                    w, "POST", f"/v1/models/{model_id}/reload", payload,
                    None, timeout_s=max(120.0, self.request_timeout_s))
                try:
                    doc = json.loads(data)
                except ValueError:
                    doc = {}
                if status == 409:
                    raise ReloadRejectedError(
                        f"worker {w.worker_id} rejected the reload: "
                        f"{doc.get('error')}: {doc.get('detail')}")
                if status == 404:
                    raise ModelLoadError(
                        f"worker {w.worker_id}: {doc.get('error')}")
                if status != 200:
                    raise WorkerProxyError(
                        f"worker {w.worker_id} answered {status} to the "
                        f"reload: {doc}")
                versions[w.worker_id] = int(doc.get("version", 0))
                tm.counter("serving.fleet.reloads_total", fleet=self.name,
                           worker=w.worker_id, model=model_id)
            # respawns must load the NEW weights: rewrite the spawn spec
            if self.spec is not None:
                for m in self.spec.get("models", []):
                    if m.get("id") == model_id:
                        m["path"] = path
                if self._spec_path:
                    self._write_spec()
            return versions

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        ring = self._ring()
        with self._decisions_lock:
            decisions = dict(self._decisions)
        return {
            "name": self.name,
            "url": self.url if self._httpd is not None else None,
            "n_workers": len(self.workers),
            "ring": sorted(w.worker_id for w in ring),
            "affinity_head": self.affinity_head,
            "overflow_depth": self.overflow_depth,
            "respawn": self.respawn,
            "routing_decisions": decisions,
            "workers": {w.worker_id: w.describe() for w in self.workers},
        }

    def metrics_text(self) -> str:
        """Fleet-scope Prometheus text: the router's own registry (routing
        counters, ring gauges via the fleet collector) plus every ring
        worker's ``/metrics`` re-exported with a ``worker`` label. Worker
        comment lines are stripped — repeating ``# TYPE`` per worker would
        make the merged exposition unparsable; the label keeps every
        series unique."""
        parts = [tm.install_default_collectors().prometheus_text()]
        for w in self.workers:
            if w.port is None or not w.alive:
                continue
            try:
                status, body = self._worker_get(w, "/metrics", timeout_s=5.0)
            except (OSError, http.client.HTTPException):
                continue
            if status != 200:
                continue
            parts.append(_relabel_metrics(body.decode("utf-8", "replace"),
                                          w.worker_id))
        return "\n".join(p.rstrip("\n") for p in parts if p) + "\n"

    def debug_requests(self, model_id: str, last: Optional[int] = None
                       ) -> List[dict]:
        """Fleet-wide flight-recorder dump: each ring worker's records for
        ``model_id``, tagged with the worker id (the ids the callers sent
        as ``X-Request-Id`` correlate them end to end)."""
        out: List[dict] = []
        q = f"?last={int(last)}" if last else ""
        for w in self.workers:
            if w.port is None or not w.in_ring:
                continue
            try:
                status, body = self._worker_get(
                    w, f"/v1/models/{model_id}/debug/requests{q}")
            except (OSError, http.client.HTTPException):
                continue
            if status != 200:
                continue
            for rec in json.loads(body).get("requests", []):
                rec["worker"] = w.worker_id
                out.append(rec)
        return out


def _log_tail(path: Optional[str], n: int = 2000) -> str:
    """The last ``n`` characters of a worker's log (a boot failure's
    report)."""
    try:
        with open(path, "rb") as f:
            return f.read().decode("utf-8", "replace")[-n:]
    except (OSError, TypeError):
        return ""


#: the directory holding the ``deeplearning4j_tpu_torch`` package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_SERIES_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)\s*$")


def _relabel_metrics(text: str, worker_id: str) -> str:
    """Inject ``worker="wN"`` as the first label of every series line;
    drop comments (see :meth:`FleetRouter.metrics_text`)."""
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labels, value = m.groups()
        if labels:
            labels = '{worker="%s",%s' % (worker_id, labels[1:])
        else:
            labels = '{worker="%s"}' % worker_id
        out.append(f"{name}{labels} {value}")
    return "\n".join(out)


# --------------------------------------------------------------- telemetry
_FLEETS: "weakref.WeakSet[FleetRouter]" = weakref.WeakSet()


def collect_metrics() -> list:
    """Scrape-time fleet gauges for the telemetry default collectors
    (util/telemetry.py ``_collect_fleet``): ring size and per-worker
    health/membership/in-flight/restarts — fresh at every scrape even
    when no request has routed since the last one."""
    rows = []
    for f in list(_FLEETS):
        lab = {"fleet": f.name}
        rows.append(("serving.fleet.ring_size", dict(lab), len(f._ring())))
        rows.append(("serving.fleet.workers", dict(lab), len(f.workers)))
        for w in f.workers:
            wl = {"fleet": f.name, "worker": w.worker_id}
            rows.append(("serving.fleet.worker_healthy", dict(wl),
                         1 if w.healthy else 0))
            rows.append(("serving.fleet.worker_in_ring", dict(wl),
                         1 if w.in_ring else 0))
            rows.append(("serving.fleet.worker_inflight", dict(wl),
                         w.inflight))
            rows.append(("serving.fleet.worker_restarts", dict(wl),
                         w.restarts))
    return rows


def current_status() -> dict:
    """Fleet section for /healthz (util/ui_server.py): per-fleet ring
    membership and routing counters. Empty when no fleet exists."""
    fleets = list(_FLEETS)
    if not fleets:
        return {}
    if len(fleets) == 1:
        return fleets[0].status()
    return {f.name: f.status() for f in fleets}


# ------------------------------------------------------------- spec helper
def fleet_spec(models: Sequence[dict], env: Optional[dict] = None,
               device: Optional[str] = None) -> dict:
    """Worker boot recipe for :class:`FleetRouter`. Each model entry:

    - ``id``: model id; ``path``: ModelSerializer archive
    - ``kind``: "classify" | "generate"; ``quantize``: e.g. "int8"
    - ``register``: ModelRouter.register kwargs (max_wait_ms, max_batch,
      queue_limit, …)
    - ``model_kw``: ServingModel kwargs (bucketing as
      {"batch_buckets": [...], "seq_buckets": [...]}, prefix_cache,
      prefill_chunk, pool_blocks, …; ``export_dir`` raises in the worker,
      the AOT store being ROADMAP Queue 1 item 12)

    ``env`` is put into every worker's environment at spawn, before it
    imports torch (``CUDA_VISIBLE_DEVICES``, ``DL4J_TORCH_KERNEL_IMPL``,
    ``DL4J_TPU_*`` knobs, …). ``device`` is where the workers restore the
    models ("cpu"); without it, the card.
    """
    spec = {"models": [dict(m) for m in models], "env": dict(env or {})}
    if device is not None:
        spec["device"] = str(device)
    return spec


def _make_fleet_handler(fleet: FleetRouter):
    class FleetHandler(BaseHTTPRequestHandler):
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

        def _relay(self, status: int, data: bytes, headers: dict):
            """Relay a worker response verbatim: status, body bytes, and
            the headers that carry contract semantics — X-Request-Id (the
            flight-recorder correlation id the worker echoed) and
            Retry-After (the worker's backoff hint on 429/503) MUST cross
            the hop unmodified."""
            passthrough = []
            for k in ("X-Request-Id", "Retry-After"):
                v = headers.get(k)
                if v is not None:
                    passthrough.append((k, v))
            ctype = headers.get("Content-Type", "application/json")
            self._send(status, data, ctype=ctype, headers=passthrough)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            parts = u.path.strip("/").split("/")
            if u.path == "/metrics":
                self._send(200, fleet.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif u.path == "/healthz":
                ring = fleet._ring()
                body = {"status": "ok" if ring else "unhealthy",
                        "ring": sorted(w.worker_id for w in ring),
                        "workers": len(fleet.workers)}
                self._send_json(200 if ring else 503, body)
            elif u.path == "/v1/fleet":
                self._send_json(200, fleet.status())
            elif u.path in ("/v1/models", "/v1/models/"):
                # the fleet mirrors a worker's registry (workers are
                # homogeneous by construction: one spec)
                try:
                    status, data, headers = fleet.proxy(
                        "", "models", "GET", "/v1/models", b"", None, None)
                    self._relay(status, data, headers)
                except FleetUnavailableError as e:
                    self._send_json(
                        503, {"error": str(e)},
                        headers=[("Retry-After",
                                  str(int(max(1, e.retry_after_s))))])
                except (WorkerProxyError, _ProxyTimeoutError) as e:
                    self._send_json(502, {"error": str(e)})
            elif len(parts) == 5 and parts[:2] == ["v1", "models"] \
                    and parts[3:] == ["debug", "requests"]:
                try:
                    last = int(parse_qs(u.query).get("last", [0])[0]) or None
                except ValueError:
                    last = None
                self._send_json(200, {
                    "model": parts[2],
                    "requests": fleet.debug_requests(parts[2], last=last)})
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            # read the body on EVERY path (keep-alive framing — same rule
            # as the worker server)
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            parts = self.path.strip("/").split("/")
            if len(parts) != 4 or parts[:2] != ["v1", "models"] \
                    or parts[3] not in ("infer", "generate", "reload"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            model_id, verb = parts[2], parts[3]
            rid = self.headers.get("X-Request-Id") or new_request_id()
            rid_hdr = [("X-Request-Id", rid)]
            try:
                if verb == "reload":
                    body = json.loads(raw or b"{}")
                    versions = fleet.rolling_reload(model_id, body["path"])
                    self._send_json(200, {"model": model_id,
                                          "versions": versions,
                                          "request_id": rid},
                                    headers=rid_hdr)
                    return
                body = None  # the worker's 400 owns a malformed body
                if verb == "generate":
                    # only a generate body routes by content (its prompt
                    # head); an infer body (a batch of images is megabytes
                    # of JSON) is relayed unparsed
                    try:
                        body = json.loads(raw or b"{}")
                    except ValueError:
                        pass
                status, data, headers = fleet.proxy(
                    model_id, verb, "POST", self.path, raw, body, rid)
                self._relay(status, data, headers)
            except FleetUnavailableError as e:
                self._send_json(
                    503, {"error": type(e).__name__, "detail": str(e),
                          "request_id": rid},
                    headers=[("Retry-After",
                              str(int(max(1, e.retry_after_s))))] + rid_hdr)
            except (ModelLoadError, ReloadRejectedError) as e:
                self._send_json(409, {"error": type(e).__name__,
                                      "detail": str(e),
                                      "request_id": rid},
                                headers=rid_hdr)
            except WorkerProxyError as e:
                self._send_json(502, {"error": type(e).__name__,
                                      "detail": str(e),
                                      "request_id": rid},
                                headers=rid_hdr)
            except _ProxyTimeoutError as e:
                self._send_json(504, {"error": "worker timeout",
                                      "detail": str(e),
                                      "request_id": rid},
                                headers=rid_hdr)
            except (KeyError, ValueError, TypeError) as e:
                self._send_json(400, {"error": f"bad request: {e!r}"},
                                headers=rid_hdr)
            except Exception as e:  # noqa: BLE001 — the front tier must
                self._send_json(500, {"error": repr(e)},  # never die
                                headers=rid_hdr)

    return FleetHandler
