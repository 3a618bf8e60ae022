"""Grafana dashboard JSON generator (copy of ``ray_tpu/util/grafana.py``).

Reference: ``dashboard/modules/metrics/grafana_dashboard_factory.py`` — the
reference generates its default Grafana boards (cluster utilization, task
states, node metrics) from panel templates at dashboard startup. Here the
generator builds one importable dashboard from (a) the core runtime series
every cluster exports once ``start_core_metrics()`` runs (the dashboard
server starts it) and (b) whatever user metrics are currently registered in
``ray_tpu_torch.util.metrics``. Output follows the modern schema (schemaVersion
39, timeseries panels) and imports cleanly into Grafana 9/10/11.

Usage::

    from ray_tpu_torch.util.grafana import write_dashboard
    write_dashboard("ray_tpu_dashboard.json")
    # or REST: GET /api/grafana on a running dashboard

The panels' series carry the ``ray_tpu_`` prefix that the port's
``prometheus_text()`` adds, as the reference's do; the static rows chart
the series of the port's registries (``llm.engine``, ``llm.prefix_cache``,
``util.device_prof``, ``util.phases``, ``util.waterfall``, the head's),
which are the reference's, and raylint's RL012 holds every query to a
series something exports. The static rows are the reference's panel for
panel. Two things differ, so that every metric the cluster collects has a
panel:

* ``_LLM_NAMES``, the names the dynamic loop skips, is read off the static
  rows' queries: a metric is skipped only where a row charts it. The
  reference's list names series no row charts (``llm_finished_requests``,
  ``llm_prefill_tokens``), and it skips every ``core_`` name, charted or
  not (``core_submit_credits``, ``core_arena_capacity_bytes``); those get
  panels here.
* The dynamic loop reads this process's registry and, on a running
  cluster, every metric the cluster collected (``metrics.collect()``):
  metrics registered only in worker processes (an engine in a replica or
  a job's actor) get panels too, where the reference's board charts this
  process's registry alone.
"""

from __future__ import annotations

import json
import re
from typing import Optional

# (title, promql expr, unit, description) — core series exported by
# util.metrics.start_core_metrics(); names carry the ray_tpu_ prefix that
# prometheus_text() adds.
_CORE_PANELS = [
    ("Tasks by state", 'ray_tpu_core_tasks{{state=~".+"}}', "short",
     "Cluster task counts per scheduler state (PENDING/RUNNING/...)."),
    ("Actors by state", 'ray_tpu_core_actors{{state=~".+"}}', "short",
     "Actor FSM states (PENDING/ALIVE/RESTARTING/DEAD)."),
    ("Alive nodes", "ray_tpu_core_nodes", "short",
     "Nodes registered and alive in the cluster."),
    ("Logical resource utilization", 'ray_tpu_core_resource_used{{resource=~".+"}}', "short",
     "Used amount per logical resource (CPU/GPU/custom)."),
    ("Logical resource capacity", 'ray_tpu_core_resource_total{{resource=~".+"}}', "short",
     "Registered total per logical resource — pair with utilization to see headroom."),
    ("Object store objects", "ray_tpu_core_objects", "short",
     "Objects tracked by the head directory."),
    ("Object store bytes", "ray_tpu_core_object_bytes", "bytes",
     "Total bytes of tracked objects (inline + shm)."),
    ("Spilled bytes", "ray_tpu_core_spilled_bytes", "bytes",
     "Bytes currently spilled to disk."),
]

# LLM serving row (engine metrics export from replica processes, so the
# registry-driven loop below can't discover them from the dashboard
# process — they get a static row instead; names: llm/engine.py).
_LLM_PANELS = [
    ("LLM tokens/s", "rate(ray_tpu_llm_generated_tokens[1m])", "short",
     "Engine-wide generation throughput."),
    # running and waiting are separate panels: both series are untagged,
    # so a PromQL `a or b` would drop `b` whenever `a` exists
    ("LLM running requests", "ray_tpu_llm_running_requests", "short",
     "Requests currently holding decode slots."),
    ("LLM waiting requests", "ray_tpu_llm_waiting_requests", "short",
     "Requests queued for admission (upscale pressure)."),
    ("KV block utilization", "ray_tpu_llm_kv_block_utilization", "percentunit",
     "Fraction of paged-KV blocks in use (preemption pressure above the threshold)."),
    ("TTFT p99",
     'histogram_quantile(0.99, rate(ray_tpu_llm_time_to_first_token_s_bucket[5m]))',
     "s", "Time to first token (SLO latency; obs top shows the live snapshot)."),
    ("Inter-token latency p99",
     'histogram_quantile(0.99, rate(ray_tpu_llm_inter_token_latency_s_bucket[5m]))',
     "s", "Gap between consecutive streamed tokens."),
    ("Speculative acceptance rate", "ray_tpu_llm_spec_acceptance_rate", "percentunit",
     "Accepted/proposed draft tokens of the last verify window."),
]


def _prefix_panels() -> list:
    """Cross-request prefix-cache row, DERIVED from the metric family
    ``llm.prefix_cache`` exports (``prefix_cache.METRIC_NAMES`` is the
    contract; tests cross-check this row against it so the dashboard
    can't silently drift from the code): hit rate, hit/miss token rates,
    eviction pressure, resident tree size."""
    return [
        ("Prefix cache hit rate", "ray_tpu_llm_prefix_cache_hit_rate",
         "percentunit",
         "Lifetime hit_tokens / (hit+miss) — prompt tokens served from "
         "cached KV instead of prefill."),
        ("Prefix hit tokens/s",
         "rate(ray_tpu_llm_prefix_cache_hit_tokens[1m])", "short",
         "Prompt tokens/s whose prefill was skipped via cached blocks."),
        ("Prefix miss tokens/s",
         "rate(ray_tpu_llm_prefix_cache_miss_tokens[1m])", "short",
         "Prompt tokens/s actually prefilled (compare llm_prefill_tokens)."),
        ("Prefix evictions/s",
         "rate(ray_tpu_llm_prefix_cache_evicted_blocks[1m])", "short",
         "Cached blocks reclaimed under KV pressure — sustained rate "
         "means the tree is thrashing; grow the pool."),
        ("Prefix cache blocks", "ray_tpu_llm_prefix_cache_blocks", "short",
         "KV blocks resident in the radix tree."),
    ]


def _profiling_panels() -> list:
    """Continuous-profiling row, DERIVED from the profiling-plane metric
    families (``util.waterfall.METRIC_NAMES``, ``util.device_prof
    .METRIC_NAMES`` and the engine's ``llm_hbm_*`` ledger gauges — tests
    cross-check this row against those registries): task-hop waterfall
    percentiles per phase, device-step time per step site, runtime
    retraces, and the HBM ledger the tiered-KV spill decision reads."""
    return [
        ("Submit window size p50",
         'histogram_quantile(0.5, rate(ray_tpu_core_submit_batch_size_bucket[5m]))',
         "short",
         "Tasks per pipelined submit window received by the head "
         "(core_submit_batch_size) — 1 means the plane is running "
         "un-batched sync round trips; bursts should push this toward "
         "core_submit_batch_max."),
        ("Submit window size p99",
         'histogram_quantile(0.99, rate(ray_tpu_core_submit_batch_size_bucket[5m]))',
         "short",
         "Tail submit-window size — how big bursts actually get before "
         "the core_submit_batch_max cap or a blocking RPC flushes them."),
        ("Reply batch size p50",
         'histogram_quantile(0.5, rate(ray_tpu_core_reply_batch_size_bucket[5m]))',
         "short",
         "Completions per coalesced worker reply message "
         "(core_reply_batch_size); pair with core_submit_credits on the "
         "submitter to spot window-credit stalls."),
        ("Reply batch size p99",
         'histogram_quantile(0.99, rate(ray_tpu_core_reply_batch_size_bucket[5m]))',
         "short",
         "Tail reply-batch size under load (the off-path flusher drains "
         "whatever accumulated, capped at core_reply_batch_max)."),
        ("Task-hop p99 by phase",
         'histogram_quantile(0.99, rate(ray_tpu_core_task_phase_s_bucket{{phase=~".+"}}[5m]))',
         "s",
         "Per-hop task-plane latency (submit/serialize/socket_write/"
         "head_dispatch/worker_deserialize/exec/reply/total) folded on "
         "the head from sampled tasks' waterfall stamps."),
        ("Waterfalls folded/s",
         "rate(ray_tpu_core_task_waterfalls[1m])", "short",
         "Complete 8-stamp records folded per second (sampled tasks "
         "only; core_task_waterfall_incomplete counts partial replies)."),
        ("Device step p99 by site",
         'histogram_quantile(0.99, rate(ray_tpu_device_step_seconds_bucket{{site=~".+"}}[5m]))',
         "s",
         "Wall time per step-function call (decode/prefill/verify/"
         "fork/train_step), first-call costs included."),
        ("Jit retraces/s",
         'rate(ray_tpu_device_retraces[5m])', "short",
         "Sites running a NEW shape AFTER warmup (RL014's runtime twin) — any "
         "sustained rate fires the retrace-storm SLO rule."),
        # one panel per ledger gauge. The pool-wide series is untagged, so
        # a PromQL `a or b` would collapse to `a` (same pitfall the
        # running/waiting panels document above); under a tensor-parallel
        # engine (EngineConfig(tp>1)) every gauge ALSO publishes one
        # series per mesh device tagged `device="<id>"` — a plain
        # metric-name expr renders them all as separate legend entries,
        # so these panels need no per-tp variant
        ("HBM params bytes", "ray_tpu_llm_hbm_params_bytes", "bytes",
         "Device bytes held by model params (per-device series under "
         "tp>1 exceed the even split: replicated leaves are a full copy "
         "each)."),
        ("HBM seq-owned KV bytes", "ray_tpu_llm_hbm_kv_seq_bytes", "bytes",
         "KV blocks owned by ≥1 live sequence × block bytes."),
        ("HBM cache-resident KV bytes", "ray_tpu_llm_hbm_kv_cache_bytes",
         "bytes",
         "Prefix-cache-ONLY residents — what a host-RAM tier would "
         "reclaim (the tiered-KV spill signal)."),
        ("HBM free KV bytes", "ray_tpu_llm_hbm_kv_free_bytes", "bytes",
         "Free-list blocks × block bytes."),
        ("HBM drafter bytes", "ray_tpu_llm_hbm_drafter_bytes", "bytes",
         "Speculative drafter params (0 for the n-gram drafter)."),
        ("KV pool footprint", "ray_tpu_llm_hbm_kv_pool_bytes", "bytes",
         "Total device bytes of the paged-KV pool arrays (fixed at "
         "engine start; per-device series under tp>1 are exactly 1/tp — "
         "the head axis is sharded)."),
    ]


def _data_plane_panels() -> list:
    """Zero-copy data-plane row, DERIVED from the object-plane
    metric families (``_private.runtime.METRIC_NAMES`` counters + the
    head's locality gauge): shm write/read throughput, where reads were
    served from, and how often the scheduler moved tasks to their data."""
    return [
        ("Shm put throughput", "rate(ray_tpu_core_shm_put_bytes[1m])", "Bps",
         "Serialized bytes/s producers wrote straight into shared memory "
         "(core_shm_put_bytes) — these bytes ship as locators, never as "
         "control-socket payload."),
        ("Shm get throughput", "rate(ray_tpu_core_shm_get_bytes[1m])", "Bps",
         "Serialized bytes/s consumers read back out of shared-memory "
         "maps (core_shm_get_bytes)."),
        ("Local hits vs remote pulls",
         "rate(ray_tpu_core_data_local_hits[1m])", "short",
         "Shm reads served zero-copy from a same-host map "
         "(core_data_local_hits); plot ray_tpu_core_data_remote_pulls "
         "beside it — a rising remote share means tasks are landing away "
         "from their data."),
        ("Remote pulls/s",
         "rate(ray_tpu_core_data_remote_pulls[1m])", "short",
         "Shm reads that crossed hosts via the p2p data plane "
         "(core_data_remote_pulls) — each one is a full payload copy the "
         "locality scheduler tries to avoid."),
        ("Scheduler locality hit rate",
         "ray_tpu_core_sched_locality_hit_rate", "percentunit",
         "Fraction of ref-arg task placements that landed on a node "
         "already holding the args' shm bytes "
         "(core_sched_locality_hit_rate); sustained low values mean "
         "byte-holding nodes are capacity-starved."),
    ]


def _objects_panels() -> list:
    """Object-ledger row, DERIVED from the head's object-plane
    metric family (``_private.head.METRIC_NAMES`` — tests cross-check this
    row against the registry): per-node arena residency, pin pressure,
    spill churn, object lifetimes, and the standing leak-audit verdict."""
    return [
        ("Arena used by node",
         'ray_tpu_core_arena_used_bytes{{node=~".+"}}', "bytes",
         "Bytes allocated in each node's native object arena "
         "(core_arena_used_bytes) — plot against "
         "ray_tpu_core_arena_capacity_bytes; the worst ratio drives the "
         "arena-pressure SLO rule."),
        ("Arena pinned by node",
         'ray_tpu_core_arena_pinned_bytes{{node=~".+"}}', "bytes",
         "Arena bytes held by live reader pins per node "
         "(core_arena_pinned_bytes) — pinned bytes can't be recycled; "
         "obs objects --audit flags pins older than the read lease."),
        ("Arena occupancy (worst node)",
         "ray_tpu_core_arena_occupancy", "percentunit",
         "Worst-node used/capacity ratio (core_arena_occupancy) — the "
         "arena-pressure SLO gauge."),
        ("Spilled bytes by node",
         'ray_tpu_core_spill_bytes{{node=~".+"}}', "bytes",
         "Directory objects currently spilled to each node's disk "
         "(core_spill_bytes)."),
        ("Object spills/s",
         "rate(ray_tpu_core_object_spills[1m])", "short",
         "Directory objects spilled under arena pressure "
         "(core_object_spills) — any sustained rate fires the spill-burn "
         "SLO rule."),
        ("Object lifetime p99",
         'histogram_quantile(0.99, rate(ray_tpu_core_object_age_s_bucket[5m]))',
         "s",
         "Object age at free/evict (core_object_age_s) — a growing tail "
         "means refs are outliving their usefulness and holding arena "
         "bytes."),
        ("Object-plane leaks",
         "ray_tpu_core_object_leaks", "short",
         "Findings of the last leak audit (core_object_leaks; obs objects "
         "--audit / rpc_object_audit) — anything non-zero deserves a "
         "look: orphaned arena bytes, stale pins, dangling locators, or "
         "orphaned spill files."),
    ]


def _phases_panels() -> list:
    """Request-phases row, DERIVED from the phase registry
    (``util.phases.PHASES`` — tests cross-check this row against it):
    where a served request's milliseconds go, per phase. Assembly-only
    phases (computed by ``obs attribute`` from anchors, never exported
    as series) are skipped — a panel over a never-emitted series would
    be permanently empty."""
    from ray_tpu_torch.util.phases import PHASES

    m = "ray_tpu_llm_request_phase_s"
    panels = [
        ("Request phase p99 (by phase)",
         f"histogram_quantile(0.99, sum by (le, phase) "
         f"(rate({m}_bucket[5m])))", "s",
         "p99 seconds per phase of the request lifecycle "
         "(llm_request_phase_s) — the fleet view of `obs attribute`: "
         "whichever line dominates owns the latency budget."),
        ("Request phase share (mean s/req)",
         f"sum by (phase) (rate({m}_sum[5m])) / ignoring(phase) "
         f"group_left sum(rate({m}_count[5m]))", "s",
         "Mean seconds each phase contributes per request — the stacked "
         "decomposition of end-to-end latency."),
    ]
    for name, owner, edges in PHASES:
        if owner == "assembly":
            continue  # no series: derived at attribution time
        panels.append((
            f"Phase {name} p99",
            f'histogram_quantile(0.99, rate({m}_bucket{{phase="{name}"}}'
            f"[5m]))", "s",
            f"{edges} (owner: {owner}).",
        ))
    return panels


def _slo_panels() -> list:
    """SLO / burn-rate row DERIVED from ``util.slo.default_rules()`` — the
    panels interpolate the same threshold/objective/window the head's alert
    engine evaluates (all env-tunable), so Grafana and ``obs alerts`` agree
    on what 'burning' means even after an operator retunes the rules."""
    from ray_tpu_torch.util.slo import default_rules

    panels = []
    for rule in default_rules():
        budget = max(1e-9, 1.0 - rule.objective)
        window = f"[{max(int(rule.fast_window_s), 15)}s]"
        if rule.kind == "histogram_burn":
            m = f"ray_tpu_{rule.metric}"
            # the rule's series filter (e.g. phase="queue") rides both the
            # bucket and count selectors, matching _tags_match at eval time
            tagsel = "".join(
                f', {k}="{v}"' for k, v in (rule.tags or {}).items()
            )
            csel = "{" + tagsel[2:] + "}" if tagsel else ""
            expr = (
                f'(1 - (rate({m}_bucket{{le="{rule.threshold:g}"{tagsel}}}'
                f"{window}) "
                f"/ rate({m}_count{csel}{window}))) / {budget:g}"
            )
            title = f"{rule.name} fast burn rate"
        elif rule.kind == "counter_burn":
            m = f"ray_tpu_{rule.metric}"
            sel = ",".join(
                f'{k}="{v}"' for k, v in (rule.bad_tags or {}).items()
            )
            expr = (
                f"(sum(rate({m}{{{sel}}}{window})) "
                f"/ sum(rate({m}{window}))) / {budget:g}"
            )
            title = f"{rule.name} burn rate"
        else:  # gauge_threshold: show the gauge against its bound
            expr = f"ray_tpu_{rule.metric}"
            title = f"{rule.name} (fires ≥ {rule.threshold:g} for {rule.for_s:g}s)"
        panels.append((title, expr, "short", rule.description or rule.name))
    panels += [
        ("Serve requests/s",
         "sum(rate(ray_tpu_serve_requests[1m]))", "short",
         "Proxied HTTP request throughput across status classes."),
        ("Dropped spans/s",
         "rate(ray_tpu_tracing_dropped_spans[5m])", "short",
         "Spans evicted by the per-process retention cap "
         "(RAY_TPU_TRACE_MAX_SPANS) — sustained drops mean raise the cap "
         "or lower RAY_TPU_TRACE_SAMPLE."),
    ]
    return panels

def _static_rows() -> list:
    """Every static row, in the board's order."""
    return (_CORE_PANELS + _LLM_PANELS + _prefix_panels() + _profiling_panels()
            + _data_plane_panels() + _objects_panels() + _phases_panels() + _slo_panels())


_PROM_NAME = re.compile(r"ray_tpu_([a-z][a-z0-9_]*)")


def _charted(rows: list) -> frozenset:
    """The metric names the rows' queries read (a histogram's name as well
    as its ``_bucket``/``_sum``/``_count`` series)."""
    names = set()
    for _title, expr, _unit, _desc in rows:
        for name in _PROM_NAME.findall(expr):
            names.add(name)
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix):
                    names.add(name[: -len(suffix)])
    return frozenset(names)


# names the static rows already chart — the dynamic metric loop skips them
# to avoid duplicate panels (read off the rows, so a name is skipped only
# where a panel charts it)
_LLM_NAMES = _charted(_static_rows())

#: the board's title and tag: this package's name (the reference's board
#: is titled with its own)
_PACKAGE = __name__.split(".")[0]


def _panel(panel_id: int, title: str, expr: str, unit: str, desc: str, y: int) -> dict:
    return {
        "id": panel_id,
        "type": "timeseries",
        "title": title,
        "description": desc,
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"h": 8, "w": 12, "x": 12 * (panel_id % 2), "y": y},
        "fieldConfig": {
            "defaults": {
                "unit": unit,
                "custom": {"drawStyle": "line", "lineWidth": 1, "fillOpacity": 12},
            },
            "overrides": [],
        },
        "targets": [
            {
                "expr": expr.replace("{{", "{").replace("}}", "}"),
                "legendFormat": "__auto",
                "refId": "A",
                "datasource": {"type": "prometheus", "uid": "${datasource}"},
            }
        ],
    }


def dashboard_json(extra_metric_names: Optional[list[str]] = None) -> dict:
    """Build the dashboard dict. ``extra_metric_names`` defaults to every
    metric registered in this process's registry and, on a running
    cluster, every metric the cluster collected (module doc)."""
    from ray_tpu_torch.util import metrics as um

    kinds: dict[str, str] = {}
    if extra_metric_names is None:
        with um._registry_lock:
            kinds = {m.name: m.kind for m in um._registry}
        try:  # the cluster's metrics, worker processes' included
            kinds.update(um.collect().get("kinds", {}))
        except Exception:
            pass  # no cluster to ask: this process's registry alone
        names = sorted(kinds)
    else:
        names = list(extra_metric_names)
    panels = []
    y = 0
    pid = 0
    for title, expr, unit, desc in _static_rows():
        panels.append(_panel(pid, title, expr, unit, desc, y))
        pid += 1
        if pid % 2 == 0:
            y += 8
    for name in names:
        if name in _LLM_NAMES:
            continue
        if kinds.get(name) == "histogram":
            # the exporter emits _bucket/_sum/_count for histograms, never
            # the bare name — a bare-name panel would be permanently empty
            expr = (
                f"histogram_quantile(0.99, "
                f"rate(ray_tpu_{name}_bucket[5m]))"
            )
            title = f"{name} (p99)"
        else:
            expr = f"ray_tpu_{name}"
            title = name
        panels.append(
            _panel(pid, title, expr, "short", f"User metric {name!r}.", y)
        )
        pid += 1
        if pid % 2 == 0:
            y += 8
    return {
        "title": _PACKAGE,
        "uid": "ray-tpu-core",
        "tags": [_PACKAGE, "generated"],
        "timezone": "browser",
        "schemaVersion": 39,
        "version": 1,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {
            "list": [
                {
                    "name": "datasource",
                    "type": "datasource",
                    "query": "prometheus",
                    "current": {},
                }
            ]
        },
        "panels": panels,
        "annotations": {"list": []},
        "editable": True,
    }


def write_dashboard(path: str, **kw) -> str:
    with open(path, "w") as f:
        json.dump(dashboard_json(**kw), f, indent=2)
    return path
