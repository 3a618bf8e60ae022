"""OTLP-JSON export: spans, flight-recorder events, and metric series in
the OpenTelemetry wire schema (copy of ``ray_tpu/util/otlp.py``).

The obs plane's native formats (chrome traces, JSONL rings, merged series
dicts) leave the cluster only as bespoke files; this module maps all three
onto OTLP/JSON so any OpenTelemetry-speaking backend (collector, Jaeger,
Tempo, Loki, Prometheus-via-collector) ingests them directly:

* spans          → ``resourceSpans``   (``scopeSpans[].spans[]``)
* recorder events → ``resourceLogs``   (``scopeLogs[].logRecords[]``)
* metric series  → ``resourceMetrics`` (``scopeMetrics[].metrics[]`` with
  ``sum``/``gauge``/``histogram`` data points)

Resource identity is (node, process): every span/event/series groups under
a resource carrying ``service.name``, ``process.pid``, and ``node.id``
attributes. A request id (16 hex chars) widens into the 32-hex OTLP
``traceId``, so one request's spans and log records correlate in any OTLP
backend exactly as they do in ``obs req``.

Sinks: the FILE sink always works (``export(path=...)``, one JSON document
holding all three sections — what ``obs export --otlp`` and the CI
postmortem artifact write); the HTTP sink is best-effort behind
``RAY_TPU_OTLP_ENDPOINT`` (each section POSTs to the standard
``/v1/traces`` / ``/v1/logs`` / ``/v1/metrics`` path, failures are
reported, never raised).

The port's document differs from the reference's in two names: the
instrumentation scope is ``ray_tpu_torch.obs`` and every resource's
``service.name`` is ``ray_tpu_torch``, so a backend fed by both packages
tells them apart. Everything else is the reference's: the field names, the
``ray_tpu_`` prefix of metric names (the one ``prometheus_text()`` adds in
both), the trace and span ids, the severities and the data points. Metric
descriptions come from the port's registries, which word two of them
differently (``device_step_seconds`` and ``device_retraces`` describe step
functions and new shapes where the reference's describe jit compiles).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Optional

_SCOPE = {"name": "ray_tpu_torch.obs", "version": "1"}


# ---------------------------------------------------------------------------
# AnyValue / attribute encoding
# ---------------------------------------------------------------------------


def _any_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP JSON carries int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, str):
        return {"stringValue": v}
    try:
        return {"stringValue": json.dumps(v)}
    except TypeError:
        return {"stringValue": repr(v)}


def _attrs(d: dict) -> list[dict]:
    return [{"key": str(k), "value": _any_value(v)} for k, v in d.items()]


def _resource(pid: Any, node: Optional[str]) -> dict:
    attrs = {"service.name": "ray_tpu_torch"}
    if pid is not None:
        attrs["process.pid"] = str(pid)
    if node:
        attrs["node.id"] = str(node)
    return {"attributes": _attrs(attrs)}


def _trace_id(request_id: Optional[str]) -> str:
    """32-hex OTLP traceId from a 16-hex request id (zero-padded left);
    spans with no request root get a hashed synthetic id."""
    if request_id:
        rid = "".join(c for c in str(request_id) if c in "0123456789abcdef")
        if rid:
            return rid[:32].rjust(32, "0")
    return hashlib.sha1(repr(request_id).encode()).hexdigest()[:32]


def _span_id(*parts: Any) -> str:
    return hashlib.sha1("|".join(repr(p) for p in parts).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# spans (chrome-trace "X" entries → OTLP spans)
# ---------------------------------------------------------------------------


def spans_to_otlp(spans: list[dict]) -> list[dict]:
    """Map chrome-trace complete events (the shape ``tracing.get_spans`` /
    ``state.timeline`` produce: ``ts``/``dur`` in µs, ``pid``/``tid``
    lanes, ``args``) to ``resourceSpans``."""
    by_res: dict[tuple, list] = {}
    for s in spans:
        if s.get("ph") not in (None, "X"):
            continue  # instant markers export as log records, not spans
        args = dict(s.get("args") or {})
        rid = args.get("request_id")
        ts_us = float(s.get("ts", 0.0))
        dur_us = float(s.get("dur", 0.0))
        span = {
            "traceId": _trace_id(rid),
            "spanId": _span_id(s.get("name"), ts_us, dur_us, s.get("pid"), s.get("tid")),
            "name": str(s.get("name", "span")),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(ts_us * 1000)),
            "endTimeUnixNano": str(int((ts_us + dur_us) * 1000)),
            "attributes": _attrs(args),
            "status": {},
        }
        key = (str(s.get("pid", "")), None)
        by_res.setdefault(key, []).append(span)
    return [
        {
            "resource": _resource(pid, node),
            "scopeSpans": [{"scope": _SCOPE, "spans": sp}],
        }
        for (pid, node), sp in sorted(
            by_res.items(), key=lambda kv: (kv[0][0], kv[0][1] or "")
        )
    ]


# ---------------------------------------------------------------------------
# flight-recorder events → log records
# ---------------------------------------------------------------------------

_SEVERITY = (
    ("crash.", ("ERROR", 17)),
    ("alert.fire", ("WARN", 13)),
    ("ci.", ("WARN", 13)),
)


def _severity(etype: str) -> tuple[str, int]:
    for prefix, sev in _SEVERITY:
        if etype.startswith(prefix):
            return sev
    return ("INFO", 9)


def events_to_otlp(events: list[dict]) -> list[dict]:
    by_res: dict[tuple, list] = {}
    for e in events:
        etype = str(e.get("type", "event"))
        sev_text, sev_num = _severity(etype)
        rid = e.get("request_id")
        attrs = {
            k: v
            for k, v in e.items()
            if k not in ("ts", "type", "seq", "pid", "node") and v is not None
        }
        rec = {
            "timeUnixNano": str(int(float(e.get("ts", 0.0)) * 1e9)),
            "severityText": sev_text,
            "severityNumber": sev_num,
            "body": {"stringValue": etype},
            "attributes": _attrs(attrs),
        }
        if rid:
            rec["traceId"] = _trace_id(rid)
        key = (str(e.get("pid", "")), e.get("node"))
        by_res.setdefault(key, []).append(rec)
    return [
        {
            "resource": _resource(pid, node),
            "scopeLogs": [{"scope": _SCOPE, "logRecords": recs}],
        }
        for (pid, node), recs in sorted(
            by_res.items(), key=lambda kv: (kv[0][0], kv[0][1] or "")
        )
    ]


# ---------------------------------------------------------------------------
# metric series → resourceMetrics
# ---------------------------------------------------------------------------


def _dp_attrs(tagset: str) -> list[dict]:
    try:
        tags = json.loads(tagset) if tagset else {}
    except ValueError:
        tags = {}
    return _attrs(tags)


def series_to_otlp(merged: dict, help_text: Optional[dict] = None) -> list[dict]:
    """Merged cluster series (``metrics.collect_series`` shape) as ONE
    cluster resource of ``resourceMetrics``."""
    metrics_out = []
    for name in sorted(merged):
        ent = merged[name]
        kind = ent.get("kind", "counter")
        metric: dict = {
            "name": f"ray_tpu_{name}",
            "description": (help_text or {}).get(name, ""),
            "unit": "",
        }
        if kind == "histogram":
            bounds = [float(b) for b in (ent.get("boundaries") or ())]
            dps = []
            for tagset, points in ent.get("series", {}).items():
                for ts, vec in points:
                    if not isinstance(vec, (list, tuple)):
                        continue
                    buckets, s, count = vec[:-2], vec[-2], vec[-1]
                    dps.append(
                        {
                            "attributes": _dp_attrs(tagset),
                            "timeUnixNano": str(int(ts * 1e9)),
                            "count": str(int(count)),
                            "sum": float(s),
                            "bucketCounts": [str(int(c)) for c in buckets],
                            "explicitBounds": bounds,
                        }
                    )
            metric["histogram"] = {
                "dataPoints": dps,
                "aggregationTemporality": 2,  # CUMULATIVE
            }
        else:
            dps = [
                {
                    "attributes": _dp_attrs(tagset),
                    "timeUnixNano": str(int(ts * 1e9)),
                    "asDouble": float(v),
                }
                for tagset, points in ent.get("series", {}).items()
                for ts, v in points
                if isinstance(v, (int, float))
            ]
            if kind == "counter":
                metric["sum"] = {
                    "dataPoints": dps,
                    "aggregationTemporality": 2,
                    "isMonotonic": True,
                }
            else:
                metric["gauge"] = {"dataPoints": dps}
        metrics_out.append(metric)
    if not metrics_out:
        return []
    return [
        {
            "resource": _resource(None, None),
            "scopeMetrics": [{"scope": _SCOPE, "metrics": metrics_out}],
        }
    ]


# ---------------------------------------------------------------------------
# export + sinks
# ---------------------------------------------------------------------------


def export(
    path: Optional[str] = None,
    spans: Optional[list[dict]] = None,
    events: Optional[list[dict]] = None,
    series: Optional[dict] = None,
    help_text: Optional[dict] = None,
) -> dict:
    """Build the OTLP document (and write it when ``path`` is given).
    Returns ``{"resourceSpans": [...], "resourceLogs": [...],
    "resourceMetrics": [...]}`` — the three standard OTLP/JSON payload
    sections in one file."""
    doc = {
        "resourceSpans": spans_to_otlp(spans or []),
        "resourceLogs": events_to_otlp(events or []),
        "resourceMetrics": series_to_otlp(series or {}, help_text),
    }
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def otlp_endpoint() -> Optional[str]:
    return os.environ.get("RAY_TPU_OTLP_ENDPOINT") or None


def post(doc: dict, endpoint: Optional[str] = None, timeout: float = 5.0) -> dict:
    """Best-effort HTTP sink: POST each non-empty section to the standard
    OTLP path under ``endpoint`` (default ``RAY_TPU_OTLP_ENDPOINT``).
    Returns ``{path: status-or-error}``; never raises — export must not
    fail because a collector is down."""
    endpoint = endpoint or otlp_endpoint()
    out: dict[str, Any] = {}
    if not endpoint:
        return out
    import urllib.request

    sections = (
        ("/v1/traces", "resourceSpans"),
        ("/v1/logs", "resourceLogs"),
        ("/v1/metrics", "resourceMetrics"),
    )
    for urlpath, key in sections:
        body = doc.get(key) or []
        if not body:
            continue
        url = endpoint.rstrip("/") + urlpath
        try:
            req = urllib.request.Request(
                url,
                data=json.dumps({key: body}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out[urlpath] = resp.status
        except Exception as e:  # collector down / bad endpoint: report, go on
            out[urlpath] = f"error: {e!r}"
    return out


def export_cluster(
    path: Optional[str] = None,
    events_dir: Optional[str] = None,
    offline: bool = False,
) -> tuple[dict, dict]:
    """Gather the cluster's spans + events + series and export them.
    ``offline=True`` skips every live drain and reads crash-flush JSONL
    only (CI postmortems, dead clusters). Returns ``(doc, counts)``."""
    from ray_tpu_torch._private import events as _ev

    spans: list[dict] = []
    events: list[dict] = list(_ev.load_crash_files(events_dir))
    series: dict = {}
    help_text: dict = {}
    if not offline:
        from ray_tpu_torch.util import metrics as _m
        from ray_tpu_torch.util import state as _st
        from ray_tpu_torch.util import tracing as _t

        try:
            spans = _st.timeline() + _t.collect_cluster_spans()
        except Exception:
            spans = _t.get_spans()
        try:
            seen = {(e.get("pid"), e.get("seq"), e.get("ts")) for e in events}
            for e in _ev.collect_cluster_events():
                if (e.get("pid"), e.get("seq"), e.get("ts")) not in seen:
                    events.append(e)
        except Exception:
            pass
        try:
            series = _m.collect_series()
            help_text = _m.collect().get("help", {})
        except Exception:
            series = {}
    doc = export(path, spans=spans, events=events, series=series,
                 help_text=help_text)
    counts = {
        "spans": sum(
            len(ss["spans"]) for r in doc["resourceSpans"] for ss in r["scopeSpans"]
        ),
        "events": sum(
            len(sl["logRecords"]) for r in doc["resourceLogs"] for sl in r["scopeLogs"]
        ),
        "metrics": sum(
            len(sm["metrics"]) for r in doc["resourceMetrics"]
            for sm in r["scopeMetrics"]
        ),
    }
    return doc, counts
