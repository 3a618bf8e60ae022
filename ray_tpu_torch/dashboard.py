"""Cluster dashboard: REST API + a small live HTML overview (copy of
``ray_tpu/dashboard.py``, serving its own copy of ``_dashboard_static/``).

Counterpart of the reference's dashboard head
(``dashboard/head.py`` — an aiohttp REST server with per-module routes —
plus the React frontend in ``dashboard/client/``). Re-designed for this
runtime: cluster state already lives in the driver-attached head, so the
dashboard is a stdlib ``ThreadingHTTPServer`` thread inside any attached
process — no separate daemon, no node agents, no build step. Endpoints
mirror the reference's REST surface (nodes/actors/tasks/jobs/metrics) and
``/metrics`` serves Prometheus text like the metrics agent
(``dashboard/modules/reporter/reporter_agent.py``).

Usage::

    ray_tpu_torch.init()
    url = ray_tpu_torch.dashboard.start()     # -> http://127.0.0.1:8265
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None


def _payload(path: str):
    import ray_tpu_torch
    from ray_tpu_torch.util import metrics as um
    from ray_tpu_torch.util import state as st

    from urllib.parse import parse_qs, urlsplit

    parts = urlsplit(path)
    path, query = parts.path.rstrip("/"), parse_qs(parts.query)

    if path == "/api/version":
        return {ray_tpu_torch.__name__: getattr(ray_tpu_torch, "__version__", "dev"), "dashboard": 1}
    if path == "/api/nodes":
        return st.list_nodes()
    if path == "/api/actors":
        return st.list_actors()
    if path == "/api/tasks":
        return st.list_tasks()
    if path == "/api/objects":
        return st.list_objects()
    if path == "/api/placement_groups":
        return st.list_placement_groups()
    if path == "/api/summary":
        return st.summary()
    if path == "/api/cluster_resources":
        return {
            "total": ray_tpu_torch.cluster_resources(),
            "available": ray_tpu_torch.available_resources(),
        }
    if path == "/api/node_stats":
        return st.get_node_stats()
    if path == "/api/worker_stacks":
        return st.get_worker_stacks()
    if path == "/api/profile":
        seconds = min(max(float(query.get("seconds", ["2"])[0]), 0.05), 60.0)
        return st.profile_workers(duration_s=seconds)
    if path == "/api/timeline":
        return st.timeline()
    if path == "/api/jobs":
        try:
            from ray_tpu_torch.job import list_jobs

            return [j if isinstance(j, dict) else j.__dict__ for j in list_jobs()]
        except Exception:
            return []
    if path == "/api/logs":
        # job log tail (reference: dashboard log endpoints serve the
        # session log dir; here job supervisors capture entrypoint output)
        job_id = (query.get("job_id") or [""])[0]
        try:
            tail = int((query.get("tail") or ["2000"])[0])
        except ValueError:
            tail = 2000  # malformed client value: default, not a 500
        try:
            from ray_tpu_torch.job import get_job_logs

            text = get_job_logs(job_id)
        except Exception as e:
            return {"job_id": job_id, "logs": f"(unavailable: {e})"}
        lines = (text or "").splitlines()
        return {"job_id": job_id, "logs": "\n".join(lines[-tail:])}
    if path == "/api/metrics":
        return um.collect()
    if path == "/api/percentiles":
        # p50/p95/p99 snapshots for every cluster histogram (obs top's
        # TTFT/ITL view over HTTP)
        return um.histogram_percentiles()
    if path == "/api/series":
        # merged metric time series (?name= narrows to one metric) — the
        # data `obs series` renders, JSON for dashboards/tooling
        name = (query.get("name") or [None])[0]
        return um.collect_series(name)
    if path == "/api/alerts":
        # SLO burn-rate engine state (?eval=1 forces a pass first)
        return st.get_alerts(eval_now=(query.get("eval") or ["0"])[0] == "1")
    if path == "/api/events":
        # flight-recorder drain (cluster-wide, newest last); ?request_id=
        # narrows to one request, ?tail= caps the reply
        from ray_tpu_torch._private import events as ev

        rid = (query.get("request_id") or [None])[0]
        try:
            tail = int((query.get("tail") or ["500"])[0])
        except ValueError:
            tail = 500
        return ev.collect_cluster_events(rid)[-tail:]
    if path == "/api/request":
        # one request's merged timeline (same data as `obs req <id>`)
        from ray_tpu_torch.obs import request_events

        rid = (query.get("id") or [""])[0]
        if not rid:
            return {"error": "pass ?id=<request_id>"}
        return request_events(rid)
    if path == "/api/grafana":
        from ray_tpu_torch.util.grafana import dashboard_json

        return dashboard_json()
    return None


# The SPA now lives in _dashboard_static/ (index.html / app.js /
# style.css) — hand-written, no build step; served by _Handler below.
_STATIC_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "_dashboard_static"
)
_STATIC = {
    "/": ("index.html", "text/html; charset=utf-8"),
    "/index.html": ("index.html", "text/html; charset=utf-8"),
    "/app.js": ("app.js", "text/javascript; charset=utf-8"),
    "/style.css": ("style.css", "text/css; charset=utf-8"),
}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet by default
        pass

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        try:
            if self.path.split("?")[0] in _STATIC:
                fname, ctype = _STATIC[self.path.split("?")[0]]
                with open(os.path.join(_STATIC_DIR, fname), "rb") as f:
                    body = f.read()
            elif self.path == "/metrics":
                from ray_tpu_torch.util import metrics as um

                body = um.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                data = _payload(self.path)
                if data is None:
                    self.send_error(404)
                    return
                body = json.dumps(data, default=str).encode()
                ctype = "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except BrokenPipeError:
            pass
        except Exception as e:  # surface handler bugs as 500s, not hangs
            try:
                self.send_error(500, str(e))
            except Exception:
                pass


def start(host: str = "127.0.0.1", port: Optional[int] = None) -> str:
    """Start the dashboard server (idempotent). Returns its URL.

    Default port comes from the ``dashboard_port`` config flag (8265, like
    the reference); ``port=0`` picks a free port (the URL reports it)."""
    if port is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        port = GLOBAL_CONFIG.dashboard_port
    global _server, _thread
    if _server is not None:
        h, p = _server.server_address[:2]
        return f"http://{h}:{p}"
    _server = ThreadingHTTPServer((host, port), _Handler)
    _server.daemon_threads = True
    _thread = threading.Thread(target=_server.serve_forever, name="dashboard", daemon=True)
    _thread.start()
    try:
        # live core series for /metrics + the generated Grafana board
        from ray_tpu_torch.util.metrics import start_core_metrics

        start_core_metrics()
    except Exception:
        pass  # dashboard is usable without the sampler
    h, p = _server.server_address[:2]
    return f"http://{h}:{p}"


def stop() -> None:
    global _server, _thread
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server = None
        _thread = None
