"""Request latency attribution (copy of the attribution half of
``ray_tpu/obs.py``): ``attribute_rows`` joins the phase-plane events
(``llm.phase.ledger`` from the engine, ``llm.phase.proxy`` from the HTTP
proxy) into one decomposition per request, ``attribution_report`` folds
them into per-phase percentiles, the slowest requests and the phase-sum
identity, and ``render_attribution`` prints the ``obs attribute`` table.
``llm.loadgen`` reads them per arm. ``request_events`` gathers one
request's events (live rings, crash-flush files, spans, task events).

The rest of the reference's ``obs`` — the ``python -m ray_tpu.obs`` CLI
(``main`` and the ``cmd_*`` commands: top, req, series, alerts, waterfall,
objects, arena, export, overhead, timeline) — is not ported yet (ROADMAP.md,
queue A5); reaching one of those names raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import sys
from typing import Optional

#: the reference's CLI half, not ported yet: reaching a name raises
_NOT_PORTED = (
    "main", "cmd_top", "cmd_req", "cmd_series", "cmd_alerts", "cmd_export",
    "cmd_waterfall", "cmd_overhead", "cmd_attribute", "cmd_events",
    "cmd_timeline", "cmd_objects", "cmd_arena",
    "render_request", "measure_overhead", "offline_trace", "render_series",
    "render_alerts", "render_waterfall", "render_objects", "render_audit",
    "render_arena", "sparkline",
)


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.obs.{name} is not ported yet (ROADMAP.md, queue A5): "
            "only the request latency attribution is"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _load_crash_files(events_dir: Optional[str]) -> list[dict]:
    """Crash-flush JSONL files (``events.flush``) — the postmortem side of
    ``events``/``req``: a killed worker can't answer the live drain, but
    its flushed ring is still on disk."""
    from ray_tpu_torch._private import events as ev

    return ev.load_crash_files(events_dir)


def request_events(request_id: str, events_dir: Optional[str] = None) -> list[dict]:
    """Everything known about one request, merged and time-ordered: live
    flight-recorder rings (cluster drain), crash-flush files, and span/
    task-event records tagged with the id."""
    from ray_tpu_torch._private import events as ev
    from ray_tpu_torch.util import state as st
    from ray_tpu_torch.util import tracing

    merged = ev.collect_cluster_events(request_id)
    for rec in _load_crash_files(events_dir):
        if rec.get("request_id") == request_id:
            merged.append(rec)
    # spans (cluster-wide) whose args carry the id become span events
    for s in tracing.collect_cluster_spans():
        if (s.get("args") or {}).get("request_id") != request_id:
            continue
        merged.append(
            {
                "ts": s["ts"] / 1e6,
                "type": f"span:{s['name']}",
                "dur_s": round(s.get("dur", 0.0) / 1e6, 6),
                "request_id": request_id,
                "pid": s.get("pid"),
            }
        )
    # runtime task events (submitted/running/finished hops)
    try:
        for t in st.get_task_events():
            if t.get("request_id") != request_id:
                continue
            merged.append(
                {
                    "ts": t["time"],
                    "type": f"task:{t.get('name') or t['task_id'][:8]}:{t['state']}",
                    "request_id": request_id,
                }
            )
    except Exception:
        pass  # state API gone (detached postmortem): recorder data stands alone
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return _dedup(merged)


def _dedup(evs: list[dict]) -> list[dict]:
    """Drop events that arrived through more than one channel (the live
    drain AND a crash-flush file — a process that flushed but survived
    answers both), keyed on per-process identity."""
    seen = set()
    out = []
    for e in evs:
        key = (e.get("ts"), e.get("type"), e.get("pid"), e.get("seq"))
        if key in seen:
            continue
        seen.add(key)
        out.append(e)
    return out


def _fmt_us(seconds: float) -> str:
    if seconds is None or (isinstance(seconds, float) and math.isnan(seconds)):
        return "-"
    if seconds >= 0.1:
        return f"{seconds:.2f}s"
    if seconds >= 0.001:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds * 1e6:.0f}us"


def attribute_rows(evs: list[dict]) -> list[dict]:
    """Join the phase-plane events (``llm.phase.ledger`` from the engine,
    ``llm.phase.proxy`` from the HTTP proxy) into one decomposition per
    request.  The join is pure anchor arithmetic and telescopes exactly:
    ``proxy + dispatch|failover + Σ(engine phases) + stream == t_done −
    t_recv`` (engine-only rows: ``Σ(engine phases) == t_finish −
    t_submit`` — the by-construction cursor identity).  A resumed
    request's surviving ledger covers only the second attempt; the gap
    back to the proxy's dispatch anchor — the dead attempt plus the
    re-dispatch — is reported as ``failover``, never re-counted into
    token phases."""
    from ray_tpu_torch.util import phases as ph

    ledgers: dict = {}
    proxies: dict = {}
    for e in evs:
        rid = e.get("request_id")
        if not rid:
            continue
        t = e.get("type")
        if t == "llm.phase.ledger":
            cur = ledgers.get(rid)
            # keep the newest fold: after a mid-stream failover only the
            # surviving attempt's ledger describes delivered work
            if cur is None or e.get("t_finish", 0.0) >= cur.get("t_finish", 0.0):
                ledgers[rid] = e
        elif t == "llm.phase.proxy":
            proxies[rid] = e
    order = [name for name, _o, _d in ph.PHASES]
    rows = []
    for rid, led in sorted(ledgers.items()):
        eng = led.get("phases") or {}
        phases = {k: float(eng.get(k, 0.0)) for k in ph.ENGINE_PHASES}
        row = {
            "request_id": rid,
            "resumed": bool(led.get("resumed")),
            "reason": led.get("reason"),
        }
        t_submit = led.get("t_submit", 0.0)
        t_finish = led.get("t_finish", 0.0)
        prox = proxies.get(rid)
        if prox is not None and prox.get("t_dispatch") is not None:
            t_recv, t_done = prox["t_recv"], prox["t_done"]
            t_disp = prox["t_dispatch"]
            phases["proxy"] = max(0.0, t_disp - t_recv)
            if row["resumed"]:
                phases["failover"] = max(0.0, t_submit - t_disp)
            else:
                phases["dispatch"] = max(0.0, t_submit - t_disp)
            phases["stream"] = max(0.0, t_done - t_finish)
            row["e2e"] = max(0.0, t_done - t_recv)
            row["scope"] = "proxy"
        else:
            row["e2e"] = max(0.0, t_finish - t_submit)
            row["scope"] = "engine"
        row["phases"] = {
            k: round(phases[k], 6) for k in order if phases.get(k)
        }
        s = sum(phases.values())
        row["phase_sum"] = round(s, 6)
        row["err"] = (
            abs(s - row["e2e"]) / row["e2e"] if row["e2e"] > 0 else 0.0
        )
        row["dominant"] = (
            max(row["phases"], key=row["phases"].get) if row["phases"] else None
        )
        rows.append(row)
    return rows


def _pcts_of(vals: list[float]) -> dict:
    vals = sorted(vals)
    n = len(vals)

    def q(p: float):
        return vals[min(n - 1, int(round(p * (n - 1))))] if n else None

    return {
        "count": n,
        "p50": q(0.50),
        "p95": q(0.95),
        "p99": q(0.99),
        "mean": (sum(vals) / n) if n else None,
    }


def attribution_report(
    rows: list[dict], top: int = 10, eps: float = 0.05
) -> dict:
    """Fleet-level critical-path report over per-request decompositions:
    per-phase p50/p95/p99, the top-N slowest requests with their dominant
    phase, and the p99-budget identity — the fraction of requests whose
    phases sum to measured end-to-end within ``eps`` (the acceptance
    gate loadgen and the CI smoke assert headlessly)."""
    from ray_tpu_torch.util import phases as ph

    per_phase: dict = {}
    for r in rows:
        for k, v in r["phases"].items():
            per_phase.setdefault(k, []).append(v)
    order = [name for name, _o, _d in ph.PHASES]
    within = [r for r in rows if r["err"] <= eps]
    slowest = sorted(rows, key=lambda r: -r["e2e"])[:top]
    e2e = _pcts_of([r["e2e"] for r in rows])
    return {
        "n_requests": len(rows),
        "eps": eps,
        "within_eps": len(within),
        "within_eps_frac": (len(within) / len(rows)) if rows else None,
        "worst_err": max((r["err"] for r in rows), default=None),
        "scopes": {
            s: sum(1 for r in rows if r["scope"] == s)
            for s in ("proxy", "engine")
        },
        "resumed": sum(1 for r in rows if r["resumed"]),
        "e2e": e2e,
        "per_phase": {
            k: _pcts_of(per_phase[k]) for k in order if k in per_phase
        },
        "slowest": [
            {
                "request_id": r["request_id"],
                "e2e": round(r["e2e"], 6),
                "dominant": r["dominant"],
                "dominant_s": round(
                    r["phases"].get(r["dominant"], 0.0), 6
                ) if r["dominant"] else 0.0,
                "resumed": r["resumed"],
                "reason": r["reason"],
            }
            for r in slowest
        ],
    }


def render_attribution(report: dict) -> str:
    """The ``obs attribute`` tables: per-phase percentiles (below-2-samples
    ``—`` contract), the p99 budget line, and the slowest requests."""
    n = report["n_requests"]
    if not n:
        return "no phase ledgers found (no llm.phase.* events — is the " \
               "engine serving with RAY_TPU_PHASES enabled?)"
    lines = [
        f"request phase attribution: {n} requests "
        f"(proxy-joined={report['scopes']['proxy']} "
        f"engine-only={report['scopes']['engine']} "
        f"resumed={report['resumed']})",
        f"{'PHASE':<12} {'N':>6}  {'P50':>9} {'P95':>9} {'P99':>9}",
    ]
    for name, p in report["per_phase"].items():
        if p.get("count", 0) < 2:
            lines.append(f"{name:<12} {p.get('count', 0):>6}  "
                         f"{'—':>9} {'—':>9} {'—':>9}")
            continue
        lines.append(
            f"{name:<12} {p['count']:>6}  {_fmt_us(p['p50']):>9} "
            f"{_fmt_us(p['p95']):>9} {_fmt_us(p['p99']):>9}"
        )
    e2e = report["e2e"]
    lines.append(
        f"{'e2e':<12} {e2e['count']:>6}  "
        + (
            f"{_fmt_us(e2e['p50']):>9} {_fmt_us(e2e['p95']):>9} "
            f"{_fmt_us(e2e['p99']):>9}"
            if e2e.get("count", 0) >= 2
            else f"{'—':>9} {'—':>9} {'—':>9}"
        )
    )
    frac = report["within_eps_frac"]
    lines.append(
        f"p99 budget: phases sum to e2e within ε={report['eps']:.0%} for "
        f"{report['within_eps']}/{n} requests ({frac:.1%})"
        + (
            f", worst err {report['worst_err']:.2%}"
            if report.get("worst_err") is not None
            else ""
        )
    )
    if report["slowest"]:
        lines.append(f"{'SLOWEST':<28} {'E2E':>9}  DOMINANT")
        for s in report["slowest"]:
            lines.append(
                f"{s['request_id'][:26]:<28} {_fmt_us(s['e2e']):>9}  "
                f"{s['dominant']}={_fmt_us(s['dominant_s'])}"
                + (" (resumed)" if s["resumed"] else "")
                + (f" [{s['reason']}]" if s.get("reason") else "")
            )
    return "\n".join(lines)


if __name__ == "__main__":
    print(
        "python -m ray_tpu_torch.obs: the obs CLI is not ported yet "
        "(ROADMAP.md, queue A5)",
        file=sys.stderr,
    )
    raise NotImplementedError("the obs CLI is not ported yet (ROADMAP.md, queue A5)")
