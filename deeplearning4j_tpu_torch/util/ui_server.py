"""UIServer: the browser dashboard over StatsStorage and the telemetry
endpoints (counterpart of deeplearning4j_tpu/util/ui_server.py;
deeplearning4j-ui's VertxUIServer and training charts).

A stdlib ``http.server`` thread serves the reference's content model:
score, update:parameter ratio, per-layer parameter stddev and iteration
time charts from the attached StatsStorage (inline SVG, no JS), the
histogram and system pages, the raw records (``/train/data``,
``/train/sessions``), and the telemetry routes: ``/metrics``
(Prometheus), ``/healthz`` (every health check, the device's liveness, the
serving, fleet, tuning and SLO sections), ``/costs`` (every published cost
report, ``util/cost_model.py``) and ``/slo``. The model server answers
``/metrics``, ``/slo`` and ``/healthz`` with the same static bodies.

    from deeplearning4j_tpu_torch.util import InMemoryStatsStorage, StatsListener
    from deeplearning4j_tpu_torch.util.ui_server import UIServer

    storage = InMemoryStatsStorage()
    net.listeners.append(StatsListener(storage))
    ui = UIServer.get_instance()
    ui.attach(storage)              # http://localhost:9000/train

Device liveness in ``/healthz`` is the serving device's: the CUDA devices
torch sees, or the CPU when the caller asked for it.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


class UIServer:
    """UIServer.getInstance()/attach(storage) parity."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000):
        self.port = port
        self.storages: List = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._sys_history: List = []  # (timestamp, process RSS MB) samples

    @classmethod
    def get_instance(cls, port: "Optional[int]" = None) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(9000 if port is None else port)
        elif port is not None and port != cls._instance.port:
            raise ValueError(
                f"UIServer already running on port {cls._instance.port}; "
                f"stop() it before requesting port {port}")
        return cls._instance

    def attach(self, storage) -> "UIServer":
        self.storages.append(storage)
        if self._httpd is None:
            self._start()
        return self

    def detach(self, storage):
        self.storages.remove(storage)

    def _records(self, session: "Optional[str]" = None):
        out = []
        for s in self.storages:
            out.extend(r for r in s.records
                       if session is None or r.get("session") == session)
        return sorted(out, key=lambda r: r.get("iteration", 0))

    def _sessions(self) -> List[str]:
        """All session ids across attached storages (StatsStorage
        listSessionIDs parity — the reference UI's session browser)."""
        ids = set()
        for s in self.storages:
            for r in s.records:
                if "session" in r:
                    ids.add(r["session"])
        return sorted(ids)

    def _newest_session(self) -> "Optional[str]":
        """Session of the most recently inserted record (storage lists are
        append-ordered) — 'newest' by actual arrival, not id spelling."""
        for s in reversed(self.storages):
            for r in reversed(s.records):
                if "session" in r:
                    return r["session"]
        return None

    def _start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str, status: int = 200):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, unquote, urlparse

                u = urlparse(self.path)
                q = parse_qs(u.query)
                session = q.get("session", [None])[0]
                if u.path == "/metrics":
                    # Prometheus exposition: the process telemetry registry
                    # and its scrape-time collectors
                    self._send(server._metrics_text().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif u.path == "/healthz":
                    body, ok = server._healthz()
                    self._send(body.encode(), "application/json",
                               status=200 if ok else 503)
                elif u.path == "/costs":
                    # every published CostReport: per-layer FLOPs, bytes
                    # and time, totals, achieved FLOP/s, MFU
                    self._send(server._costs_json().encode(),
                               "application/json")
                elif u.path == "/slo":
                    # every declared objective's compliance, burn rates
                    # and budget remaining
                    self._send(server._slo_json().encode(),
                               "application/json")
                elif u.path == "/train/sessions":
                    self._send(json.dumps(server._sessions()).encode(),
                               "application/json")
                elif u.path.startswith("/train/data"):
                    self._send(
                        json.dumps(server._records(session)).encode(),
                        "application/json")
                elif u.path.startswith("/train/session/"):
                    sid = unquote(u.path[len("/train/session/"):].rstrip("/"))
                    self._send(server._render(sid).encode(), "text/html")
                elif u.path.startswith("/train/histograms"):
                    self._send(server._render_histograms(session).encode(),
                               "text/html")
                elif u.path.startswith("/train/system"):
                    self._send(server._render_system().encode(),
                               "text/html")
                elif u.path in ("/", "/train", "/train/"):
                    self._send(server._render(session).encode(), "text/html")
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolves port 0
        # a short poll: stop() waits one poll for the loop to see it
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if UIServer._instance is self:
            UIServer._instance = None

    # ------------------------------------------------- telemetry endpoints
    @staticmethod
    def _metrics_text() -> str:
        """Prometheus text for ``/metrics``, the default collectors
        installed on the first scrape."""
        from deeplearning4j_tpu_torch.util import telemetry as tm

        return tm.install_default_collectors().prometheus_text()

    @staticmethod
    def _costs_json() -> str:
        """The ``/costs`` body: the reports ``net.cost_report()`` published
        (util/cost_model.py), by model name; an empty object until one is
        computed, so a dashboard can poll it unconditionally."""
        from deeplearning4j_tpu_torch.util import cost_model

        return json.dumps({"reports": cost_model.published_reports()})

    @staticmethod
    def _slo_json() -> str:
        """The ``/slo`` body: the SLO engine's evaluation, an empty list of
        objectives until one is declared."""
        from deeplearning4j_tpu_torch.util import slo

        doc = slo.current_status()
        return json.dumps(doc if doc else {"objectives": []})

    @staticmethod
    def _device_check(device=None) -> dict:
        """Liveness of the serving device: ``device`` "cpu" (or a CPU
        torch.device) is the host; anything else counts the CUDA devices
        torch sees."""
        if device is not None and str(device).split(":")[0] == "cpu":
            return {"ok": True, "detail": "cpu"}
        try:
            import torch

            n = torch.cuda.device_count()
        except Exception as e:  # noqa: BLE001 - the probe reports it
            return {"ok": False, "detail": repr(e)}
        return {"ok": n > 0, "detail": f"{n} visible"}

    @staticmethod
    def _healthz(device=None) -> "tuple[str, bool]":
        """(JSON body, healthy?) for ``/healthz``: every health check of the
        telemetry registry, the serving device's liveness, and the
        elastic, serving, fleet, tuning and SLO sections where those
        modules are
        loaded (``sys.modules`` guards: a probe imports nothing). The SLO
        engine evaluates first, so a budget spent since the last probe
        turns this answer into a 503."""
        from deeplearning4j_tpu_torch.util import telemetry as tm

        slo_status = {}
        try:
            _slo = sys.modules.get("deeplearning4j_tpu_torch.util.slo")
            slo_status = _slo.current_status() if _slo else {}
        except Exception:
            pass  # a broken status provider must never break the probe
        ok, checks = tm.get_telemetry().health_report()
        checks["devices"] = UIServer._device_check(device)
        ok = ok and checks["devices"]["ok"]
        body = {"status": "ok" if ok else "unhealthy", "checks": checks}
        for section, mod_name in (
                ("elastic", "deeplearning4j_tpu_torch.parallel.elastic"),
                ("serving", "deeplearning4j_tpu_torch.serving.router"),
                ("fleet", "deeplearning4j_tpu_torch.serving.fleet"),
                ("tuning", "deeplearning4j_tpu_torch.tuning.database")):
            try:
                mod = sys.modules.get(mod_name)
                status = mod.current_status() if mod else {}
                if status:
                    body[section] = status
            except Exception:
                pass
        if slo_status:
            body["slo"] = slo_status
        return json.dumps(body), ok

    # ------------------------------------------------------------- rendering
    def _render(self, session: "Optional[str]" = None) -> str:
        """DL4J overview-page parity: score chart, update:param-ratio chart
        (the reference's signature training-health plot), per-layer param
        stddevs, iteration timing — all inline SVG, zero JS dependencies.
        Multi-session browsing (VertxUIServer session selector): every
        session attached to any storage gets its own page."""
        import math

        sessions = self._sessions()
        if session is None and len(sessions) > 1:
            session = self._newest_session()
        recs = self._records(session)
        scores = [(r["iteration"], r["score"]) for r in recs if "score" in r]
        charts = [_line_chart(scores, "model score vs iteration")]

        # log10 mean(|update| l2 / |param| l2) — DL4J's "update:parameter
        # ratio" chart; healthy training sits near 1e-3
        ratios = []
        for r in recs:
            ps, us = r.get("params"), r.get("updates")
            if not ps or not us:
                continue
            vals = [us[k]["l2"] / ps[k]["l2"]
                    for k in us if ps.get(k, {}).get("l2", 0) > 0]
            if vals:
                ratios.append((r["iteration"],
                               math.log10(sum(vals) / len(vals) + 1e-12)))
        if ratios:
            charts.append(_line_chart(
                ratios, "log10 update:parameter ratio (mean over params)"))

        # per-layer parameter stddev over time (multi-series)
        series: dict = {}
        for r in recs:
            for k, s in (r.get("params") or {}).items():
                if k.endswith(".W") or k.endswith(".gamma"):
                    series.setdefault(k, []).append((r["iteration"], s["std"]))
        if series:
            charts.append(_multi_line_chart(series,
                                            "parameter stddev by layer"))

        times = [(r["iteration"], r["iter_ms"]) for r in recs
                 if isinstance(r.get("iter_ms"), (int, float))]
        if times:
            charts.append(_line_chart(times, "iteration time (ms)"))

        def ms(r):
            v = r.get("iter_ms")
            return f"{v:.1f}" if isinstance(v, (int, float)) else ""

        rows = "".join(
            f"<tr><td>{r.get('iteration', '')}</td><td>{r.get('epoch', '')}</td>"
            f"<td>{r['score']:.6f}</td><td>{ms(r)}</td></tr>"
            for r in recs[-25:] if isinstance(r.get("score"), (int, float))
        )
        import html as _html
        from urllib.parse import quote

        charts_html = "".join(f"<div>{c}</div>" for c in charts)
        nav = ""
        if sessions:
            links = " | ".join(
                (f"<b>{_html.escape(s)}</b>" if s == session else
                 f'<a href="/train/session/{quote(s, safe="")}">'
                 f"{_html.escape(s)}</a>")
                for s in sessions)
            nav = f"<p>sessions: {links}</p>"
        title = (f"Training overview — {_html.escape(session)}"
                 if session else "Training overview")
        qs = f"?session={quote(session, safe='')}" if session else ""
        return f"""<!doctype html><html><head><title>Training UI</title>
<meta http-equiv="refresh" content="5"></head>
<body style="font-family:sans-serif">
<h2>{title}</h2>{nav}{charts_html}
<h3>Recent iterations</h3>
<table border=1 cellpadding=4>
<tr><th>iter</th><th>epoch</th><th>score</th><th>ms</th></tr>{rows}</table>
<p>{len(recs)} records; raw data at <a href="/train/data">/train/data</a>;
per-layer <a href="/train/histograms{qs}">parameter/update histograms</a>;
<a href="/train/system">system</a></p>
</body></html>"""

    def _render_histograms(self, session: "Optional[str]" = None) -> str:
        """DL4J model-page parity: per-layer parameter and update
        histograms of the latest stats record."""
        import html as _html

        if session is None:
            session = self._newest_session()
        recs = self._records(session)
        latest = None
        for r in reversed(recs):
            if any("hist" in s
                   for key in ("params", "updates", "activations")
                   for s in (r.get(key) or {}).values()):
                latest = r
                break
        if latest is None:
            body = "<p>(no histogram data yet — StatsListener with " \
                   "collect_histograms=True populates this page)</p>"
        else:
            blocks = []
            for title, key in (("Parameters", "params"),
                               ("Updates", "updates"),
                               ("Activations", "activations")):
                charts = []
                for name, s in sorted((latest.get(key) or {}).items()):
                    if "hist" in s:
                        charts.append(_bar_chart(
                            s["hist"], s["hist_range"],
                            f"{name}  (mean {s['mean']:.2e}, std "
                            f"{s['std']:.2e})"))
                if charts:
                    blocks.append(f"<h3>{title} — iteration "
                                  f"{latest.get('iteration')}</h3>"
                                  + "".join(charts))
            body = "".join(blocks) or "<p>(no histogram data yet)</p>"
        title = ("Histograms — " + _html.escape(session)) if session \
            else "Histograms"
        return f"""<!doctype html><html><head><title>{title}</title>
<meta http-equiv="refresh" content="10"></head>
<body style="font-family:sans-serif">
<h2>{title}</h2>
<p><a href="/train/">&larr; overview</a></p>
{body}
</body></html>"""

    def _render_system(self) -> str:
        """DL4J UI "System" tab parity: host RAM, process RSS, and the CUDA
        devices with their memory in use and total. Each page load appends
        an RSS sample, so the chart shows memory over time."""
        import html as _html
        import time as _time

        snap = _system_snapshot()
        self._sys_history.append((_time.time(), snap.get("process_rss_mb")))
        self._sys_history = self._sys_history[-500:]
        t0 = self._sys_history[0][0]
        pts = [(t - t0, v) for t, v in self._sys_history
               if isinstance(v, int)]
        chart = _line_chart(pts, "process RSS (MB) vs seconds") if pts \
            else ""
        host_rows = "".join(
            f"<tr><td>{_html.escape(str(k))}</td>"
            f"<td>{_html.escape(str(v))}</td></tr>"
            for k, v in snap.items() if k != "devices")
        dev_rows = "".join(
            "<tr>" + "".join(
                f"<td>{_html.escape(str(d.get(c, '')))}</td>"
                for c in ("id", "platform", "kind", "mem_in_use_mb",
                          "mem_limit_mb")) + "</tr>"
            for d in snap.get("devices", []))
        return f"""<!doctype html><html><head><title>System</title>
<meta http-equiv="refresh" content="10"></head>
<body style="font-family:sans-serif">
<h2>System</h2>
<p><a href="/train/">&larr; overview</a></p>
{chart}
<h3>Host</h3><table border=1 cellpadding=4>{host_rows}</table>
<h3>Devices</h3><table border=1 cellpadding=4>
<tr><th>id</th><th>platform</th><th>kind</th><th>mem in use (MB)</th>
<th>mem limit (MB)</th></tr>{dev_rows}</table>
</body></html>"""


def _system_snapshot() -> dict:
    """Host and device facts for the System page (and tests)."""
    import platform
    import sys as _sys

    snap: dict = {"python": _sys.version.split()[0],
                  "platform": platform.platform()}
    try:  # host memory via /proc (Linux; this image)
        with open("/proc/meminfo") as f:
            mem = {l.split(":")[0]: l.split()[1] for l in f if ":" in l}
        snap["host_mem_total_mb"] = int(mem.get("MemTotal", 0)) // 1024
        snap["host_mem_available_mb"] = int(
            mem.get("MemAvailable", 0)) // 1024
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    snap["process_rss_mb"] = int(line.split()[1]) // 1024
    except OSError:
        pass
    try:
        import torch

        snap["torch"] = torch.__version__
        devs = []
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                row = {"id": i, "platform": "cuda", "kind": props.name,
                       "mem_limit_mb": props.total_memory // 2**20}
                if torch.cuda.is_initialized():
                    row["mem_in_use_mb"] = \
                        torch.cuda.memory_allocated(i) // 2**20
                devs.append(row)
        snap["devices"] = devs
    except Exception:
        snap["devices"] = []
    return snap


_PALETTE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
            "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]


def _bar_chart(counts, value_range, label, w=420, h=120, pad=24) -> str:
    """Histogram bars → inline SVG (DL4J histogram panels)."""
    import html as _html

    if not counts or max(counts) == 0:
        return "<p>(empty histogram)</p>"
    n = len(counts)
    peak = max(counts)
    bw = (w - 2 * pad) / n
    bars = []
    for i, c in enumerate(counts):
        bh = (h - 2 * pad) * c / peak
        bars.append(
            f'<rect x="{pad + i * bw:.1f}" y="{h - pad - bh:.1f}" '
            f'width="{max(bw - 1, 1):.1f}" height="{bh:.1f}" '
            f'fill="{_PALETTE[0]}"/>')
    lo, hi = value_range
    return (
        f'<svg width="{w}" height="{h + 16}" '
        f'xmlns="http://www.w3.org/2000/svg">'
        f'<text x="{pad}" y="14" font-size="11">{_html.escape(label)}</text>'
        f'<g transform="translate(0,10)">{"".join(bars)}'
        f'<text x="{pad}" y="{h - 4}" font-size="10">{lo:.3g}</text>'
        f'<text x="{w - pad}" y="{h - 4}" font-size="10" '
        f'text-anchor="end">{hi:.3g}</text></g></svg>')


def _multi_line_chart(series, label, w=640, h=240, pad=40) -> str:
    """Named series → one SVG with a legend (DL4J per-layer charts)."""
    allpts = [p for pts in series.values() for p in pts]
    if not allpts:
        return "<p>(no data yet)</p>"
    x0, x1 = min(p[0] for p in allpts), max(p[0] for p in allpts)
    y0, y1 = min(p[1] for p in allpts), max(p[1] for p in allpts)
    if y1 == y0:
        y1 = y0 + 1.0
    sx = lambda x: pad + (x - x0) / max(x1 - x0, 1) * (w - 2 * pad)
    sy = lambda y: h - pad - (y - y0) / (y1 - y0) * (h - 2 * pad)
    lines, legend = [], []
    for i, (name, pts) in enumerate(sorted(series.items())):
        color = _PALETTE[i % len(_PALETTE)]
        coords = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
        lines.append(f'<polyline fill="none" stroke="{color}" '
                     f'stroke-width="1.2" points="{coords}"/>')
        legend.append(f'<tspan x="{w - pad + 4}" dy="14" '
                      f'fill="{color}">{name}</tspan>')
    return (f'<svg width="{w + 160}" height="{h}">'
            f'<rect width="{w}" height="{h}" fill="#fafafa" stroke="#ccc"/>'
            + "".join(lines)
            + f'<text x="{w // 2}" y="16" font-size="13" '
              f'text-anchor="middle">{label}</text>'
            + f'<text x="{w - pad + 4}" y="24" font-size="10">{"".join(legend)}</text>'
            + f'<text x="4" y="{pad}" font-size="11">{y1:.4g}</text>'
            + f'<text x="4" y="{h - pad}" font-size="11">{y0:.4g}</text></svg>')


def _line_chart(points, label, w=640, h=240, pad=40) -> str:
    if not points:
        return "<p>(no data yet)</p>"
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y1 = y0 + 1.0
    sx = lambda x: pad + (x - x0) / max(x1 - x0, 1) * (w - 2 * pad)
    sy = lambda y: h - pad - (y - y0) / (y1 - y0) * (h - 2 * pad)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in points)
    return (f'<svg width="{w}" height="{h}">'
            f'<rect width="{w}" height="{h}" fill="#fafafa" stroke="#ccc"/>'
            f'<polyline fill="none" stroke="#1f77b4" stroke-width="1.5" '
            f'points="{pts}"/>'
            f'<text x="{pad}" y="{h - 8}" font-size="11">{x0}</text>'
            f'<text x="{w - pad}" y="{h - 8}" font-size="11" '
            f'text-anchor="end">{x1}</text>'
            f'<text x="4" y="{pad}" font-size="11">{y1:.4g}</text>'
            f'<text x="4" y="{h - pad}" font-size="11">{y0:.4g}</text>'
            f'<text x="{w // 2}" y="16" font-size="13" '
            f'text-anchor="middle">{label}</text></svg>')
