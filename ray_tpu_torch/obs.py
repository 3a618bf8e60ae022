"""Live observability CLI: ``python -m ray_tpu_torch.obs <command>`` (copy of
``ray_tpu/obs.py``).

Reference: the state CLI (``ray summary`` / ``ray list`` /
``ray timeline``) plus the dashboard's live cluster view, folded into one
terminal tool over this repo's three observability surfaces:

* ``util.metrics`` — cluster-merged counters/gauges/histograms (now with
  bucket-interpolated percentile snapshots),
* the flight recorder (``_private/events.py``) — every process's
  always-on ring of structured events, drained live through the head,
* ``util.tracing`` — spans + task events correlated by ``request_id``.

Commands::

    python -m ray_tpu_torch.obs top --address HOST:PORT [--watch 2]
        Live cluster + LLM engine view: nodes, tasks by state,
        running/waiting requests, KV utilization, speculative acceptance
        rate, tokens/s, TTFT/ITL p50/p95/p99.

    python -m ray_tpu_torch.obs req <request_id> --address HOST:PORT
        One request's life as a timeline: proxy -> replica -> engine
        events (admission, prefill chunks, first token, per-step
        decode/verify with accepted counts, preemptions, finish), with
        relative timestamps and a latency summary.

    python -m ray_tpu_torch.obs attribute --address HOST:PORT [--top 10]
        Request latency attribution: joins the per-request phase ledgers
        (``llm.phase.*`` events, live drain + crash-flush rings) into
        per-phase p50/p95/p99, the slowest requests with their dominant
        phase, and the p99-budget identity (phases sum to end-to-end
        within ε).

    python -m ray_tpu_torch.obs events --address HOST:PORT [--tail 50]
        Tail the cluster-wide flight recorder (newest last).

    python -m ray_tpu_torch.obs timeline --address HOST:PORT -o trace.json
        Chrome-trace export (task events + spans + one lane per request);
        load in chrome://tracing or Perfetto.

    python -m ray_tpu_torch.obs series llm_generated_tokens --address HOST:PORT
        Metric history without Grafana: sparkline of the rate (counters) /
        value (gauges) / observations-per-second + windowed percentiles
        (histograms), from the head-drained time-series rings.

    python -m ray_tpu_torch.obs alerts --address HOST:PORT [--eval-once]
        The SLO burn-rate engine's state: every rule with FIRING/OK/
        RESOLVED status, current burn value, firing age, and labels.

    python -m ray_tpu_torch.obs waterfall --address HOST:PORT [--probe N]
        Task-hop waterfall: the head's per-phase histograms (submit →
        serialize → socket-write → head-dispatch → worker-deserialize →
        exec → reply, plus total) folded from sampled tasks' stamp
        lists, rendered as a p50/p95/p99 table.  ``--probe N`` first
        drives N sync noop tasks under a traced context so a fresh
        cluster has data (the CI waterfall-probe job does exactly this
        and uploads the --json output).

    python -m ray_tpu_torch.obs objects --address HOST:PORT [--top 20] [--audit]
        The object-plane ledger: every directory entry's state (inline /
        arena / segment / spilled / poisoned), owner node, size, ref and
        pin counts, and age, largest first, plus the freed-forensics
        tail.  ``--audit`` runs the cluster-wide leak audit (orphaned
        arena bytes, dangling locators, orphaned/missing spill files,
        stale pins) and exits non-zero when it finds anything — CI runs
        it after the chaos suite.

    python -m ray_tpu_torch.obs arena --address HOST:PORT
        Per-node arena residency bars: occupancy against capacity with
        the 90% degrade watermark marked, pinned bytes, live pin count
        and oldest pin age, and bytes spilled to disk.

    python -m ray_tpu_torch.obs export -o otlp.json --address HOST:PORT
        OTLP-JSON export of spans, flight-recorder events, and metric
        series (resourceSpans/resourceLogs/resourceMetrics in one file);
        --events-dir exports crash-flush postmortems with no cluster, and
        RAY_TPU_OTLP_ENDPOINT (or --post) adds a best-effort HTTP sink.

Every command needs a running cluster (``--address``, or
``RAY_TPU_ADDRESS``); ``req``/``events`` also read crash-flush JSONL
files from ``--events-dir`` so a killed worker's last events still show.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional

# `obs overhead` probe metrics (raylint RL012 registry): created only by
# measure_overhead() in the probing process, never in a serving cluster
METRIC_NAMES = (
    "obs_overhead_counter",
    "obs_overhead_gauge",
    "obs_overhead_hist",
)


def _attach(address: Optional[str]):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address or os.environ.get("RAY_TPU_ADDRESS") or None)
    return ray_tpu_torch


def _offline(args) -> bool:
    """True when the command should run purely from crash-flush JSONL:
    an explicit --events-dir and no address to attach to.  Booting a
    fresh local cluster just to read files off disk would be slow, can
    fail in restricted sandboxes, and contributes zero events — the
    postmortem flow (CI artifact triage, a dead cluster's events dir)
    must work with nothing alive."""
    return bool(
        getattr(args, "events_dir", None)
        and not (args.address or os.environ.get("RAY_TPU_ADDRESS"))
    )


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:.1f}ms"


def _fmt_pcts(p: dict) -> str:
    def one(v):
        return "-" if v is None or (isinstance(v, float) and math.isnan(v)) else _fmt_ms(v)

    return (
        f"p50={one(p.get('p50'))} p95={one(p.get('p95'))} "
        f"p99={one(p.get('p99'))} (n={p.get('count', 0)})"
    )


def hist_pcts_row(p: Optional[dict]) -> str:
    """Percentile summary honoring the below-2-samples contract shared by
    every series-derived row (waterfall_top_row, core_batch_top_row, the
    phase tables): fewer than two observations renders ``—``, never a
    percentile faked out of one sample."""
    if not p or p.get("count", 0) < 2:
        return "—"
    return _fmt_pcts(p)


def _first_series(per_tag: dict):
    """A metric's sole (or first) tagged series — engine metrics are
    untagged, so this is the value."""
    for v in per_tag.values():
        return v
    return None


def _load_crash_files(events_dir: Optional[str]) -> list[dict]:
    """Crash-flush JSONL files (``events.flush``) — the postmortem side of
    ``events``/``req``: a killed worker can't answer the live drain, but
    its flushed ring is still on disk."""
    from ray_tpu_torch._private import events as ev

    return ev.load_crash_files(events_dir)


# ---------------------------------------------------------------------------
# top
# ---------------------------------------------------------------------------


def _series_rate(merged: dict, name: str) -> Optional[float]:
    """Newest delta/dt of a cluster-merged counter series (summed across
    tagsets), or None when fewer than 2 samples exist — a one-frame
    ``obs top`` must never fake a rate out of a lifetime counter."""
    from ray_tpu_torch.util.metrics import latest_rate

    ent = merged.get(name)
    if not ent:
        return None
    rates = [
        r for r in (latest_rate(points) for points in ent["series"].values())
        if r is not None
    ]
    if not rates:
        return None
    return sum(rates)


def _series_rate_text(merged: dict, name: str) -> str:
    rate = _series_rate(merged, name)
    return "—" if rate is None else f"{rate:.1f}"


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TB"


def _render_top() -> None:
    """One frame of ``obs top``. Rates come from the metric time-series
    (delta/dt of the head-drained rings), not lifetime counters."""
    from ray_tpu_torch.util import state as st
    from ray_tpu_torch.util.metrics import collect, collect_series, histogram_percentiles

    data = collect()
    metrics = data.get("metrics", {})
    series = collect_series()
    summary = st.summary()
    nodes = [n for n in st.list_nodes() if n.get("Alive", n.get("alive", True))]

    def gauge(name, default=None):
        v = _first_series(metrics.get(name, {}))
        return default if v is None else v

    lines = [
        time.strftime("-- ray_tpu_torch obs top -- %H:%M:%S"),
        f"nodes: {len(nodes)}  "
        f"tasks: {summary.get('tasks', {}).get('by_state') or {}}  "
        f"actors: {summary.get('actors', {}).get('by_state') or {}}",
    ]
    req_rate = _series_rate_text(series, "serve_requests")
    if req_rate != "—":
        lines.append(f"serve: requests/s={req_rate}")
    wf_line = _waterfall_top_line()
    if wf_line:
        lines.append(wf_line)
    batch_line = core_batch_top_row(metrics, histogram_percentiles())
    if batch_line:
        lines.append(batch_line)
    dp_line = core_data_plane_top_row(metrics, series)
    if dp_line:
        lines.append(dp_line)
    if "llm_running_requests" in metrics:
        acc = gauge("llm_spec_acceptance_rate")
        # runtime retrace count (device_prof): nonzero after warmup means
        # a jit site is recompiling mid-traffic (RL014's runtime twin)
        retraces = sum(
            v
            for v in metrics.get("device_retraces", {}).values()
            if isinstance(v, (int, float))
        )
        lines.append(
            "engine: "
            f"running={int(gauge('llm_running_requests', 0) or 0)} "
            f"waiting={int(gauge('llm_waiting_requests', 0) or 0)} "
            f"kv_util={float(gauge('llm_kv_block_utilization', 0.0) or 0.0):.2f} "
            f"tokens/step={gauge('llm_tokens_per_step', 0)} "
            + (f"accept_rate={acc:.2f} " if acc is not None else "")
            + (
                f"retraces={int(retraces)} "
                if "device_retraces" in metrics
                else ""
            )
            + f"tokens/s={_series_rate_text(series, 'llm_generated_tokens')} "
            + f"req/s={_series_rate_text(series, 'llm_finished_requests')}"
        )
        pcts = histogram_percentiles()
        ttft = _first_series(pcts.get("llm_time_to_first_token_s", {}))
        itl = _first_series(pcts.get("llm_inter_token_latency_s", {}))
        if ttft:
            lines.append(f"TTFT: {hist_pcts_row(ttft)}")
        if itl:
            lines.append(f"ITL:  {hist_pcts_row(itl)}")
    else:
        lines.append("engine: (no llm_* metrics published — no LLM replica running)")
    firing = _firing_alerts()
    if firing:
        lines.append(
            "ALERTS: " + "  ".join(
                f"{a['rule']}=FIRING({a['value']:.2f})" for a in firing
            )
        )
    print("\n".join(lines), flush=True)


def core_batch_top_row(metrics: dict, pcts: dict) -> Optional[str]:
    """The ``obs top`` task-plane batching row: submit-window
    and reply-batch size p50/p99 plus the submitter's remaining window
    credits. Same below-2-samples contract as the waterfall row — a
    histogram with fewer than two observations renders ``—``."""
    if (
        "core_submit_batch_size" not in metrics
        and "core_reply_batch_size" not in metrics
    ):
        return None

    def hist(name: str) -> str:
        p = _first_series(pcts.get(name, {})) or {}
        if p.get("count", 0) < 2:
            return "—"
        return f"{p['p50']:.0f}/{p['p99']:.0f}"

    credits = _first_series(metrics.get("core_submit_credits", {}))
    return (
        "core-batch(p50/p99): "
        f"submit={hist('core_submit_batch_size')} "
        f"reply={hist('core_reply_batch_size')}"
        + (f" credits={int(credits)}" if credits is not None else "")
    )


def core_data_plane_top_row(metrics: dict, series: dict) -> Optional[str]:
    """The ``obs top`` data-plane row: shm put/get throughput
    (rates from the drained time-series, same below-2-samples ``—``
    contract as every other rate on the frame), the zero-copy locality
    hit rate (lifetime local hits over all shm reads), and the worst
    node's arena occupancy."""
    if (
        "core_shm_put_bytes" not in metrics
        and "core_shm_get_bytes" not in metrics
        and "core_arena_occupancy" not in metrics
    ):
        return None

    def mbps(name: str) -> str:
        rate = _series_rate(series, name)
        return "—" if rate is None else f"{rate / (1 << 20):.1f}"

    def total(name: str) -> float:
        return sum(
            v for v in metrics.get(name, {}).values()
            if isinstance(v, (int, float))
        )

    parts = [f"put={mbps('core_shm_put_bytes')}MB/s",
             f"get={mbps('core_shm_get_bytes')}MB/s"]
    reads = total("core_data_local_hits") + total("core_data_remote_pulls")
    if reads:
        parts.append(f"local={total('core_data_local_hits') / reads:.0%}")
    occ = _first_series(metrics.get("core_arena_occupancy", {}))
    if occ is not None:
        parts.append(f"arena={float(occ):.0%}")
    return "data-plane: " + " ".join(parts)


def waterfall_top_row(summary: dict) -> str:
    """The ``obs top`` waterfall row: per-hop ``p50/p99`` from the head's
    phase histograms, honoring the below-2-samples contract — a hop that
    has fewer than two folded samples renders ``—``, never a number
    faked out of one observation."""
    parts = []
    for name, _i, _j in _wf_legs():
        p = summary.get("legs", {}).get(name) or {}
        if p.get("count", 0) < 2:
            parts.append(f"{name}=—")
        else:
            parts.append(f"{name}={_fmt_us(p['p50'])}/{_fmt_us(p['p99'])}")
    return "waterfall(p50/p99): " + " ".join(parts)


def _wf_legs():
    from ray_tpu_torch.util.waterfall import LEGS

    return LEGS


def _fmt_us(seconds: float) -> str:
    if seconds is None or (isinstance(seconds, float) and math.isnan(seconds)):
        return "-"
    if seconds >= 0.1:
        return f"{seconds:.2f}s"
    if seconds >= 0.001:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds * 1e6:.0f}us"


def _waterfall_top_line() -> Optional[str]:
    try:
        from ray_tpu_torch._private.runtime import get_ctx

        s = get_ctx().call("waterfall")
    except Exception:
        return None
    if not s or not s.get("folded"):
        return None
    return waterfall_top_row(s)


def _firing_alerts() -> list[dict]:
    try:
        from ray_tpu_torch._private.runtime import get_ctx

        return [a for a in get_ctx().call("alerts") if a.get("status") == "FIRING"]
    except Exception:
        return []


def cmd_top(args) -> int:
    ray_tpu_torch = _attach(args.address)
    try:
        while True:
            _render_top()
            if args.once:
                return 0
            time.sleep(max(args.watch, 0.2))
            print()
    except KeyboardInterrupt:
        return 0
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# series / alerts / export
# ---------------------------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 48) -> str:
    """Terminal sparkline of the newest ``width`` values."""
    vals = [v for v in values[-width:] if v is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))] for v in vals)


def render_series(name: str, ent: dict, window_s: float) -> str:
    """One metric's history as text: per-tagset sparkline + summary.
    Counters render as rates, gauges as raw values, histograms as an
    observations/s sparkline plus a percentile summary over the window."""
    from ray_tpu_torch.util.metrics import (
        series_percentiles_over_window,
        series_rate,
    )

    kind = ent.get("kind", "counter")
    lines = [f"{name} ({kind})"]
    for tagset, points in sorted(ent.get("series", {}).items()):
        label = tagset or "(untagged)"
        if kind == "histogram":
            counts = [(ts, v[-1]) for ts, v in points if isinstance(v, (list, tuple))]
            rates = series_rate(counts)
            pct = series_percentiles_over_window(
                points, ent.get("boundaries") or (), window_s
            )
            if rates:
                lines.append(
                    f"  {label}: obs/s {sparkline([r for _t, r in rates])}  "
                    f"last={rates[-1][1]:.1f}/s"
                )
            else:
                lines.append(f"  {label}: — (needs ≥2 samples)")
            lines.append(f"    window {int(window_s)}s: {_fmt_pcts(pct)}")
        elif kind == "counter":
            rates = series_rate(points)
            if rates:
                lines.append(
                    f"  {label}: rate {sparkline([r for _t, r in rates])}  "
                    f"last={rates[-1][1]:.1f}/s"
                )
            else:
                lines.append(f"  {label}: — (needs ≥2 samples)")
        else:
            vals = [float(v) for _t, v in points]
            if vals:
                lines.append(
                    f"  {label}: {sparkline(vals)}  last={vals[-1]:.3f}"
                )
            else:
                lines.append(f"  {label}: (no samples)")
    if len(lines) == 1:
        lines.append("  (no series — metric never sampled)")
    return "\n".join(lines)


def cmd_series(args) -> int:
    from ray_tpu_torch.util.metrics import collect_series

    ray_tpu_torch = _attach(args.address)
    try:
        merged = collect_series(args.metric or None)
        if args.metric:
            ent = merged.get(args.metric)
            if ent is None:
                print(f"no series for metric {args.metric!r}")
                return 1
            print(render_series(args.metric, ent, args.window))
        else:
            for name in sorted(merged):
                print(render_series(name, merged[name], args.window))
        return 0
    finally:
        ray_tpu_torch.shutdown()


def render_alerts(alerts: list[dict]) -> str:
    """The ``obs alerts`` table: rule, status, value, age, labels."""
    if not alerts:
        return "no SLO rules registered"
    now = time.time()
    lines = [f"{'RULE':<22} {'STATUS':<9} {'VALUE':>9}  {'SINCE':>8}  DETAIL"]
    for a in alerts:
        since = a.get("since")
        age = f"{now - since:.0f}s" if since else "-"
        detail = a.get("detail") or {}
        parts = []
        if "fast_burn" in detail:
            parts.append(
                f"burn fast={detail['fast_burn']:.2f} slow={detail.get('slow_burn', 0):.2f}"
            )
        if detail.get("no_data"):
            parts.append("no data")
        if a.get("labels"):
            parts.append(",".join(f"{k}={v}" for k, v in a["labels"].items()))
        lines.append(
            f"{a['rule']:<22} {a['status']:<9} {a.get('value', 0.0):>9.3f}  "
            f"{age:>8}  {' '.join(parts)}"
        )
    return "\n".join(lines)


def cmd_alerts(args) -> int:
    from ray_tpu_torch._private.runtime import get_ctx

    ray_tpu_torch = _attach(args.address)
    try:
        alerts = get_ctx().call("alerts", eval_now=bool(args.eval_once))
        if args.json:
            print(json.dumps(alerts, default=repr))
        else:
            print(render_alerts(alerts))
        return 0
    finally:
        ray_tpu_torch.shutdown()


def cmd_export(args) -> int:
    from ray_tpu_torch.util import otlp

    offline = _offline(args)
    ray_tpu_torch = None
    if not offline:
        ray_tpu_torch = _attach(args.address)
    try:
        doc, counts = otlp.export_cluster(
            path=args.output, events_dir=args.events_dir, offline=offline
        )
        posted = otlp.post(doc) if (args.post or otlp.otlp_endpoint()) else {}
        where = "offline, crash-flush only" if offline else "live cluster"
        print(
            f"wrote OTLP export to {args.output} ({where}): "
            f"{counts['spans']} spans, {counts['events']} events, "
            f"{counts['metrics']} metric series"
        )
        for path, status in posted.items():
            print(f"  POST {path}: {status}")
        return 0
    finally:
        if ray_tpu_torch is not None:
            ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# waterfall: the task-plane phase breakdown (head-folded histograms)
# ---------------------------------------------------------------------------


def render_waterfall(summary: dict) -> str:
    """The ``obs waterfall`` table: one row per phase with p50/p95/p99
    and sample count (``—`` below 2 samples, same contract as top)."""
    lines = [
        f"task-hop waterfall: {summary.get('folded', 0)} folded, "
        f"{summary.get('incomplete', 0)} incomplete",
        f"{'PHASE':<20} {'N':>6}  {'P50':>9} {'P95':>9} {'P99':>9}",
    ]
    for name, _i, _j in _wf_legs():
        p = summary.get("legs", {}).get(name) or {}
        n = p.get("count", 0)
        if n < 2:
            lines.append(f"{name:<20} {n:>6}  {'—':>9} {'—':>9} {'—':>9}")
            continue
        lines.append(
            f"{name:<20} {n:>6}  {_fmt_us(p['p50']):>9} "
            f"{_fmt_us(p['p95']):>9} {_fmt_us(p['p99']):>9}"
        )
    return "\n".join(lines)


def run_waterfall_probe(n: int) -> None:
    """Drive ``n`` sync noop tasks under one traced (sampled) context so
    the head folds a full waterfall per task — the burst ``obs waterfall
    --probe`` and the CI waterfall-probe job measure.  Sync on purpose:
    one submit→reply round trip per task is the per-task IPC cost the
    100k-tasks/s work needs broken down, with no pipelining to blur it."""
    import ray_tpu_torch
    from ray_tpu_torch.util import tracing

    @ray_tpu_torch.remote
    def _wf_probe_noop(i):
        return i

    with tracing.trace_context():
        for i in range(n):
            ray_tpu_torch.get(_wf_probe_noop.remote(i))


def cmd_waterfall(args) -> int:
    from ray_tpu_torch._private.runtime import get_ctx

    ray_tpu_torch = _attach(args.address)
    try:
        if args.probe:
            run_waterfall_probe(args.probe)
        s = get_ctx().call("waterfall", recent=args.recent)
        if args.json:
            print(json.dumps(s))
        else:
            print(render_waterfall(s))
            for rec in s.get("recent", []):
                print(json.dumps(rec))
        return 0 if s.get("folded") else 1
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# overhead: self-measured emit-path costs (no cluster needed)
# ---------------------------------------------------------------------------


def measure_overhead(n: int = 200_000) -> dict:
    """Microbenchmark the telemetry hot paths IN THIS PROCESS: ns per
    flight-recorder event, per unsampled trace context (mint + span),
    per counter increment / gauge set / histogram observe.  These are the
    numbers the OBSERVABILITY.md overhead budget pins — one command to
    spot a hot-path regression without booting a cluster."""
    from ray_tpu_torch._private import events as ev
    from ray_tpu_torch.util import metrics as um
    from ray_tpu_torch.util import tracing as tr

    def bench(fn, k=n) -> float:
        fn()  # warm (ring/cell/context creation off the measured loop)
        t0 = time.perf_counter_ns()
        for _ in range(k):
            fn()
        return (time.perf_counter_ns() - t0) / k

    out: dict = {"n": n}

    prev_enabled = ev.enabled()
    ev.set_enabled(True)
    out["event_record_ns"] = bench(lambda: ev.record("obs.overhead", i=1))
    ev.set_enabled(False)
    out["event_record_disabled_ns"] = bench(lambda: ev.record("obs.overhead"))
    ev.set_enabled(prev_enabled)

    # unsampled context: the mint decision + installing the token + a
    # span that must short-circuit (the zero-cost tracing contract)
    prev_rate = os.environ.get("RAY_TPU_TRACE_SAMPLE")
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "0"
    try:
        def unsampled_hop():
            with tr.trace_context():
                with tr.span("obs.overhead"):
                    pass

        # per-REQUEST cost: mint (sampling decision + id) + install + one span
        out["unsampled_context_ns"] = bench(unsampled_hop, k=max(1, n // 4))

        # per-SPAN cost under an already-unsampled context — the
        # "unsampled tracing is free" contract is THIS number
        prev_ctx = tr.set_trace_context(tr.mint_context())

        def unsampled_span():
            with tr.span("obs.overhead"):
                pass

        out["unsampled_span_ns"] = bench(unsampled_span)
        tr.set_trace_context(prev_ctx)
    finally:
        if prev_rate is None:
            os.environ.pop("RAY_TPU_TRACE_SAMPLE", None)
        else:
            os.environ["RAY_TPU_TRACE_SAMPLE"] = prev_rate

    c = um.Counter("obs_overhead_counter", "obs overhead probe")
    out["counter_inc_ns"] = bench(c.inc)
    g = um.Gauge("obs_overhead_gauge", "obs overhead probe")
    out["gauge_set_ns"] = bench(lambda: g.set(1.0))
    h = um.Histogram("obs_overhead_hist", "obs overhead probe")
    out["histogram_observe_ns"] = bench(lambda: h.observe(0.5))

    # task-hop waterfall emit paths (util.waterfall): the sampled path is
    # one clock read + list append per stamp; the UNSAMPLED path — what
    # every untraced task pays at submit — must cost no more than a
    # disabled record() (one type check; tests/test_obs_hotpath.py pins
    # the ratio)
    from ray_tpu_torch.util import device_prof as dp
    from ray_tpu_torch.util import waterfall as wfl

    out["waterfall_stamp_ns"] = bench(lambda: wfl.stamp([0.0]))
    out["waterfall_unsampled_ns"] = bench(lambda: wfl.maybe_start(None))

    # request phase-ledger charge (util.phases): the per-stamp cost every
    # engine phase transition pays — the ≤2µs/stamp budget's probe
    from ray_tpu_torch.util import phases as ph

    led = ph.new_ledger(time.time())
    out["phase_charge_ns"] = bench(lambda: ph.charge(led, ph.DECODE, 1.0))

    # device-step profiler emit path (cache-size probe + tagged observe);
    # the probe target has no _cache_size, like any non-jit callable
    prof = dp.JitProfiler(event="obs.overhead.retrace")

    def _plain():
        return None

    out["device_prof_note_ns"] = bench(lambda: prof.note("probe", _plain, 1e-4))
    return {k: round(v, 1) if isinstance(v, float) else v for k, v in out.items()}


def cmd_overhead(args) -> int:
    res = measure_overhead(args.n)
    if args.json:
        print(json.dumps(res))
        return 0
    print(f"telemetry emit-path self-measurement ({res['n']} iterations):")
    rows = [
        ("flight-recorder record()", res["event_record_ns"]),
        ("record() while disabled", res["event_record_disabled_ns"]),
        ("unsampled trace ctx + span", res["unsampled_context_ns"]),
        ("span under unsampled ctx", res["unsampled_span_ns"]),
        ("Counter.inc()", res["counter_inc_ns"]),
        ("Gauge.set()", res["gauge_set_ns"]),
        ("Histogram.observe()", res["histogram_observe_ns"]),
        ("waterfall stamp (sampled)", res["waterfall_stamp_ns"]),
        ("waterfall check (unsampled)", res["waterfall_unsampled_ns"]),
        ("phase-ledger charge()", res["phase_charge_ns"]),
        ("step-profiler note()", res["device_prof_note_ns"]),
    ]
    for label, v in rows:
        print(f"  {label:<28} {v:>9.1f} ns")
    return 0


# ---------------------------------------------------------------------------
# req
# ---------------------------------------------------------------------------


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


def render_request(request_id: str, evs: list[dict]) -> str:
    """Human-readable single-request timeline (what ``obs req`` prints)."""
    if not evs:
        return f"request {request_id}: no events found"
    t0 = evs[0].get("ts", 0.0)
    lines = [f"request {request_id}  ({len(evs)} events)"]
    for e in evs:
        rel = (e.get("ts", t0) - t0) * 1e3
        extras = {
            k: v
            for k, v in e.items()
            if k not in ("ts", "seq", "type", "request_id", "pid", "node")
        }
        where = e.get("node", "")[:8] or e.get("pid", "")
        detail = " ".join(f"{k}={v}" for k, v in extras.items())
        lines.append(f"  +{rel:9.1f}ms  {e.get('type', '?'):<24} {detail}  [{where}]")
    # summary: TTFT / decode steps / acceptance / finish
    ttft = next((e["ttft_s"] for e in evs if e.get("type") == "llm.first_token"), None)
    fin = next((e for e in evs if e.get("type") == "llm.finish"), None)
    verifies = [e for e in evs if e.get("type") == "llm.verify"]
    parts = []
    if ttft is not None:
        parts.append(f"ttft={_fmt_ms(ttft)}")
    if verifies:
        acc = sum(e.get("accepted", 0) for e in verifies)
        prop = sum(e.get("proposed", 0) for e in verifies)
        parts.append(
            f"spec: {len(verifies)} windows accepted {acc}/{prop} "
            f"({acc / max(prop, 1):.2f})"
        )
    if fin:
        parts.append(
            f"finished: {fin.get('reason')} after {fin.get('tokens_out')} tokens "
            f"in {_fmt_ms(fin.get('dur_s', 0.0))}"
        )
    if parts:
        lines.append("  -- " + "  ".join(parts))
    # phase lane: the request's own latency decomposition (one ledger
    # fold per engine attempt; attribute_rows joins it with the proxy
    # anchors for the cross-process legs)
    rows = attribute_rows(evs)
    for row in rows:
        lane = "  ".join(
            f"{k}={_fmt_ms(v)}"
            for k, v in row["phases"].items()
            if v > 0
        )
        lines.append(
            f"  -- phases ({row['scope']}, e2e={_fmt_ms(row['e2e'])}"
            + (", resumed" if row["resumed"] else "")
            + f"): {lane}"
        )
    return "\n".join(lines)


def cmd_req(args) -> int:
    if _offline(args):
        evs = [
            r for r in _load_crash_files(args.events_dir)
            if r.get("request_id") == args.request_id
        ]
        evs.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
        print(render_request(args.request_id, evs))
        return 0 if evs else 1
    ray_tpu_torch = _attach(args.address)
    try:
        evs = request_events(args.request_id, args.events_dir)
        print(render_request(args.request_id, evs))
        return 0 if evs else 1
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# attribute: per-request phase decomposition + fleet critical-path report
# ---------------------------------------------------------------------------


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


def cmd_attribute(args) -> int:
    from ray_tpu_torch._private import events as ev

    ray_tpu_torch = None
    if not _offline(args):
        ray_tpu_torch = _attach(args.address)
    try:
        evs = ev.collect_cluster_events() if ray_tpu_torch is not None else []
        evs.extend(_load_crash_files(args.events_dir))
        evs = _dedup(evs)
        rows = attribute_rows(evs)
        report = attribution_report(rows, top=args.top, eps=args.eps)
        if args.output:
            with open(args.output, "w") as fh:
                json.dump({"report": report, "rows": rows}, fh, default=repr)
        if args.json:
            print(json.dumps(report, default=repr))
        else:
            print(render_attribution(report))
        return 0 if rows else 1
    finally:
        if ray_tpu_torch is not None:
            ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# events / timeline
# ---------------------------------------------------------------------------


def cmd_events(args) -> int:
    from ray_tpu_torch._private import events as ev

    ray_tpu_torch = None
    if not _offline(args):
        ray_tpu_torch = _attach(args.address)
    try:
        evs = (
            ev.collect_cluster_events(args.request_id or None)
            if ray_tpu_torch is not None
            else []
        )
        evs.extend(
            rec
            for rec in _load_crash_files(args.events_dir)
            if not args.request_id or rec.get("request_id") == args.request_id
        )
        if args.type:
            evs = [e for e in evs if str(e.get("type", "")).startswith(args.type)]
        evs.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
        evs = _dedup(evs)
        for e in evs[-args.tail :]:
            print(json.dumps(e, default=repr))
        return 0
    finally:
        if ray_tpu_torch is not None:
            ray_tpu_torch.shutdown()


def offline_trace(events_dir: Optional[str], output: str) -> list[dict]:
    """Chrome trace from crash-flush JSONL alone — no cluster needed.
    The postmortem path (CI artifacts, a dead cluster's events dir):
    every flushed event becomes an instant marker on its process's lane,
    and request-tagged events additionally get their per-request lane."""
    from ray_tpu_torch.util import tracing

    evs = _load_crash_files(events_dir)
    entries = []
    for e in evs:
        args = {
            k: v
            for k, v in e.items()
            if k not in ("ts", "type", "seq", "pid", "crash_flush")
        }
        entries.append(
            {
                "name": e.get("type", "event"),
                "cat": "recorder",
                "ph": "i",
                "s": "t",
                "ts": e.get("ts", 0.0) * 1e6,
                "pid": f"proc-{e.get('pid', '?')}",
                "tid": e.get("crash_flush", "events"),
                "args": args,
            }
        )
    entries += tracing.request_lanes([], evs)
    with open(output, "w") as f:
        json.dump(entries, f)
    return entries


def cmd_timeline(args) -> int:
    from ray_tpu_torch.util import tracing

    if args.events_dir:
        events = offline_trace(args.events_dir, args.output)
        lanes = {e["tid"] for e in events if e.get("pid") == "requests"}
        print(
            f"wrote {len(events)} events ({len(lanes)} request lanes) "
            f"to {args.output} (offline, from {args.events_dir})"
        )
        return 0
    ray_tpu_torch = _attach(args.address)
    try:
        events = tracing.export_chrome_trace(args.output)
        lanes = {e["tid"] for e in events if e.get("pid") == "requests"}
        print(
            f"wrote {len(events)} events ({len(lanes)} request lanes) "
            f"to {args.output}"
        )
        return 0
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# objects / arena: the object-plane flight deck
# ---------------------------------------------------------------------------


def render_objects(ledger: dict, sort: str = "size", top: int = 0) -> str:
    """The ``obs objects`` table: directory rows (already size-sorted by
    the head; re-sorted here for ``--sort age``), the poisoned refs folded
    from worker reports, the freed-forensics tail, and the summary."""
    rows = list(ledger.get("objects", ()))
    if sort == "age":
        rows.sort(key=lambda r: r.get("age_s") or 0.0, reverse=True)
    if top:
        rows = rows[:top]
    s = ledger.get("summary", {})
    by_state = s.get("by_state") or {}
    lines = [
        f"object ledger: {s.get('objects', 0)} objects, "
        f"{_fmt_bytes(s.get('bytes', 0))}  "
        + " ".join(f"{k}={v}" for k, v in sorted(by_state.items())),
        f"{'OBJECT':<18} {'STATE':<9} {'NODE':<10} {'SIZE':>9} "
        f"{'REFS':>5} {'PINS':>5} {'AGE':>8}  LOCATION",
    ]
    for r in rows:
        loc = r.get("spill_path") or r.get("seg") or "-"
        flag = " !err" if r.get("is_error") else ""
        lines.append(
            f"{r['object_id'][:16]:<18} {r['state']:<9} "
            f"{str(r['node'])[:10]:<10} {_fmt_bytes(r['size']):>9} "
            f"{r.get('refcount', 0):>5} {r.get('pins', 0):>5} "
            f"{r.get('age_s', 0.0):>7.1f}s  {loc}{flag}"
        )
    if not rows:
        lines.append("(no live objects match)")
    for p in ledger.get("poisoned", ()):
        lines.append(
            f"{p['object_id'][:16]:<18} {'poisoned':<9} "
            f"{str(p.get('node', '-'))[:10]:<10} {'-':>9} {'-':>5} {'-':>5} "
            f"{'-':>8}  pid={p.get('pid')}"
        )
    freed = ledger.get("freed") or []
    if freed:
        lines.append(f"recently freed ({len(freed)}):")
        for f in freed[-5:]:
            lines.append(
                f"  {f['object_id'][:16]} {_fmt_bytes(f['size'])} "
                f"lived {f['age_s']:.1f}s ({f['reason']})"
            )
    return "\n".join(lines)


def render_audit(audit: dict) -> str:
    """The ``obs objects --audit`` leak report: one line per finding with
    node/object provenance, or the clean bill with coverage counts."""
    checked = audit.get("checked", {})
    coverage = (
        f"checked {checked.get('objects', 0)} objects, "
        f"{checked.get('owned_allocations', 0)} allocations, "
        f"{checked.get('spill_files', 0)} spill files, "
        f"{checked.get('pins', 0)} pins "
        f"(pin lease {audit.get('pin_lease_s', 0):.0f}s)"
    )
    findings = audit.get("findings") or []
    if not findings:
        return f"object-plane audit: no leaks — {coverage}"
    lines = [f"object-plane audit: {len(findings)} finding(s) — {coverage}"]
    for f in findings:
        detail = " ".join(
            f"{k}={v}" for k, v in f.items() if k != "kind" and v is not None
        )
        lines.append(f"  LEAK {f['kind']}: {detail}")
    return "\n".join(lines)


def cmd_objects(args) -> int:
    from ray_tpu_torch._private.runtime import get_ctx

    ray_tpu_torch = _attach(args.address)
    try:
        ctx = get_ctx()
        # --sort age needs every row (the head's top-N cut is size-order)
        server_top = 0 if args.sort == "age" else args.top
        ledger = ctx.call(
            "object_ledger", top_n=server_top, node=args.node,
            state=args.state, timeout=args.timeout,
        )
        audit = (
            ctx.call("object_audit", timeout=args.timeout)
            if args.audit else None
        )
        doc = {"ledger": ledger}
        if audit is not None:
            doc["audit"] = audit
        if args.output:
            with open(args.output, "w") as fh:
                json.dump(doc, fh, default=repr)
        if args.json:
            print(json.dumps(doc, default=repr))
        else:
            print(render_objects(ledger, sort=args.sort, top=args.top))
            if audit is not None:
                print()
                print(render_audit(audit))
        return 1 if (audit is not None and audit.get("findings")) else 0
    finally:
        ray_tpu_torch.shutdown()


def _bar(frac: float, width: int = 30, mark: float = 0.9) -> str:
    """Occupancy bar with the degrade watermark marked: ``####..|...``."""
    frac = max(0.0, min(1.0, frac))
    fill = int(frac * width)
    cells = ["#" if i < fill else "." for i in range(width)]
    m = int(mark * width)
    if 0 <= m < width and cells[m] == ".":
        cells[m] = "|"
    return "".join(cells)


def render_arena(nodes: dict) -> str:
    """The ``obs arena`` per-node residency view: occupancy against
    capacity (watermark at the 90% degrade threshold data_plane puts
    honor), pinned bytes/count, oldest pin age, and spilled bytes."""
    if not nodes:
        return "no object-plane residency reported"
    lines = []
    for tag in sorted(nodes):
        s = nodes[tag] or {}
        used = s.get("used") or 0
        cap = s.get("capacity") or 0
        frac = (used / cap) if cap else 0.0
        pin_age = s.get("oldest_pin_age_s") or 0.0
        lines.append(
            f"{str(tag)[:12]:<12} [{_bar(frac)}] {frac:>4.0%} "
            f"{_fmt_bytes(used)}/{_fmt_bytes(cap)}  "
            f"pinned={_fmt_bytes(s.get('pinned_bytes') or 0)}"
            f"({s.get('pins') or 0})"
            + (f" oldest-pin={pin_age:.0f}s" if pin_age else "")
            + (
                f" spilled={_fmt_bytes(s['spill_bytes'])}"
                if s.get("spill_bytes") else ""
            )
        )
    return "\n".join(lines)


def cmd_arena(args) -> int:
    from ray_tpu_torch._private.runtime import get_ctx

    ray_tpu_torch = _attach(args.address)
    try:
        ledger = get_ctx().call(
            "object_ledger", top_n=1, timeout=args.timeout
        )
        nodes = ledger.get("nodes", {})
        if args.json:
            print(json.dumps(nodes, default=repr))
        else:
            print(render_arena(nodes))
        return 0
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.obs",
        description="live cluster / request observability",
    )
    parser.add_argument("--address", default=None, help="head HOST:PORT")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("top", help="live cluster + LLM engine view")
    p.add_argument("--watch", type=float, default=2.0, help="refresh seconds")
    p.add_argument("--once", action="store_true", help="print one frame and exit")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("req", help="one request's timeline")
    p.add_argument("request_id")
    p.add_argument("--events-dir", default=None, help="crash-flush JSONL dir")
    p.set_defaults(fn=cmd_req)

    p = sub.add_parser(
        "attribute",
        help="per-request phase decomposition + fleet p50/p95/p99 "
        "critical-path report (joins llm.phase.* events across processes)",
    )
    p.add_argument("--top", type=int, default=10,
                   help="slowest-requests rows to show")
    p.add_argument("--eps", type=float, default=0.05,
                   help="phase-sum identity tolerance (fraction of e2e)")
    p.add_argument("--events-dir", default=None,
                   help="also read crash-flush JSONL (offline with no address)")
    p.add_argument("--json", action="store_true")
    p.add_argument("-o", "--output", default=None,
                   help="write the full report + per-request rows JSON")
    p.set_defaults(fn=cmd_attribute)

    p = sub.add_parser("events", help="tail the cluster flight recorder")
    p.add_argument("--tail", type=int, default=50)
    p.add_argument("--type", default=None, help="event-type prefix filter")
    p.add_argument("--request-id", default=None)
    p.add_argument("--events-dir", default=None, help="crash-flush JSONL dir")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("timeline", help="export a chrome trace with request lanes")
    p.add_argument("-o", "--output", default="ray_tpu_trace.json")
    p.add_argument(
        "--events-dir", default=None,
        help="build the trace offline from crash-flush JSONL (no cluster)",
    )
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("series", help="metric time-series history (sparklines)")
    p.add_argument("metric", nargs="?", default=None, help="metric name (all if omitted)")
    p.add_argument("--window", type=float, default=60.0,
                   help="percentile window seconds (histograms)")
    p.set_defaults(fn=cmd_series)

    p = sub.add_parser("alerts", help="SLO rule engine state (burn-rate alerts)")
    p.add_argument("--eval-once", action="store_true",
                   help="force one evaluation pass before reporting (headless/CI)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_alerts)

    p = sub.add_parser(
        "waterfall",
        help="task-hop phase breakdown (submit→…→reply p50/p95/p99 "
        "from the head's folded histograms)",
    )
    p.add_argument("--probe", type=int, default=0,
                   help="first drive N sync noop tasks under a traced "
                   "context (fresh clusters have no folded data)")
    p.add_argument("--recent", type=int, default=0,
                   help="also print the newest N raw stamp records")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_waterfall)

    p = sub.add_parser(
        "overhead",
        help="self-measure telemetry emit-path cost (ns/event, "
        "ns/unsampled-context, ns/counter-inc) — no cluster needed",
    )
    p.add_argument("-n", type=int, default=200_000, help="iterations per probe")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_overhead)

    p = sub.add_parser(
        "objects",
        help="object-plane ledger: states, sizes, ages; --audit hunts leaks",
    )
    p.add_argument("--top", type=int, default=20,
                   help="row cap after filters (0 = all)")
    p.add_argument("--sort", choices=("size", "age"), default="size")
    p.add_argument("--node", default=None, help="owner-node hex filter")
    p.add_argument("--state", default=None,
                   help="state filter (inline/arena/segment/spilled/poisoned)")
    p.add_argument("--audit", action="store_true",
                   help="run the cluster leak audit; exit non-zero on findings")
    p.add_argument("--timeout", type=float, default=2.0,
                   help="worker report rendezvous deadline seconds")
    p.add_argument("--json", action="store_true")
    p.add_argument("-o", "--output", default=None,
                   help="also write the ledger (+audit) JSON to a file")
    p.set_defaults(fn=cmd_objects)

    p = sub.add_parser(
        "arena",
        help="per-node arena occupancy/watermark/pin bars",
    )
    p.add_argument("--timeout", type=float, default=2.0,
                   help="worker report rendezvous deadline seconds")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_arena)

    p = sub.add_parser(
        "export", help="OTLP-JSON export of spans + events + metric series"
    )
    p.add_argument("-o", "--output", default="ray_tpu_otlp.json")
    p.add_argument("--otlp", action="store_true",
                   help="(default) OTLP JSON — flag kept for explicitness")
    p.add_argument("--events-dir", default=None,
                   help="offline: export crash-flush JSONL only (no cluster)")
    p.add_argument("--post", action="store_true",
                   help="also POST to RAY_TPU_OTLP_ENDPOINT")
    p.set_defaults(fn=cmd_export)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
