"""The telemetry endpoints of the UI server (the port's copy of
``UIServer._metrics_text`` ``:163``, ``_slo_json`` ``:182`` and
``_healthz`` ``:193`` of deeplearning4j_tpu/util/ui_server.py): the bodies
the model server answers ``GET /metrics``, ``/slo`` and ``/healthz``
with.

Device liveness in ``/healthz`` is the serving device's: the CUDA devices
torch sees when the model server serves on the card, and the CPU when the
caller asked for it. The dashboard (``attach``, the training charts), the
``/costs`` route and the stats storage come with ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import json
import sys


class UIServer:
    """The telemetry endpoints of the reference's UIServer (see the module
    doc); static, as the model server calls them."""

    @staticmethod
    def _metrics_text() -> str:
        """Prometheus text for ``/metrics``, the default collectors
        installed on the first scrape."""
        from deeplearning4j_tpu_torch.util import telemetry as tm

        return tm.install_default_collectors().prometheus_text()

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
        serving, fleet and SLO sections where those modules are loaded
        (``sys.modules`` guards: a probe imports nothing). The SLO engine
        evaluates first, so a budget spent since the last probe turns this
        answer into a 503."""
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
                ("serving", "deeplearning4j_tpu_torch.serving.router"),
                ("fleet", "deeplearning4j_tpu_torch.serving.fleet")):
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
