"""Declarative SLO rules and the burn-rate math behind them.

Reference shape: the SRE-workbook multi-window multi-burn-rate alerting
policy (fast window catches a cliff in minutes, slow window keeps a slow
leak from paging and from auto-resolving mid-incident), applied to the
cluster-merged metric time series ``util.metrics.collect_series`` produces.
This module is PURE — rules in, ``{breached, value, detail}`` out — so the
burn-rate math is golden-testable without a cluster; the stateful
fire/resolve machine lives in ``_private/alerts.py``.

Three rule kinds cover the default SLOs:

* ``histogram_burn`` — a latency SLO over a histogram metric: "``objective``
  of events complete within ``threshold`` seconds". Bad events per window =
  observations above the threshold bucket; burn rate = bad-fraction /
  error-budget. Fires when BOTH the fast and the slow window burn above
  their factors.
* ``counter_burn`` — an availability SLO over a tagged counter: bad events
  are the series matching ``bad_tags`` (e.g. ``status=5xx``), total is every
  series of the metric. Same multi-window burn evaluation.
* ``gauge_threshold`` — a saturation SLO: the gauge has been at/above
  ``threshold`` for ``for_s`` seconds continuously (KV-pool exhaustion).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

from ray_tpu_torch.util import metrics as _m


@dataclasses.dataclass
class SLORule:
    name: str
    metric: str
    kind: str  # "histogram_burn" | "counter_burn" | "gauge_threshold"
    #: fraction of good events promised (burn kinds)
    objective: float = 0.99
    #: latency bound in seconds (histogram_burn) / gauge bound (gauge_threshold)
    threshold: float = 0.0
    #: tag subset selecting the BAD series of a counter_burn metric
    bad_tags: Optional[dict] = None
    #: tag subset selecting WHICH series of the metric the rule reads at
    #: all (histogram_burn over one member of a tagged family, e.g.
    #: ``llm_request_phase_s{phase=queue}``); None = every series
    tags: Optional[dict] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    #: SRE-workbook page factors scaled to the in-memory retention window
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    #: gauge_threshold: how long the gauge must hold above threshold
    for_s: float = 0.0
    #: hysteresis: a firing alert resolves only after this long clean
    resolve_after_s: float = 60.0
    #: consumers key off these (the serve autoscaler reacts to
    #: ``{"serve": "upscale"}``)
    labels: dict = dataclasses.field(default_factory=dict)
    description: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def budget_burn(bad: float, total: float, objective: float) -> float:
    """Burn rate: observed bad fraction over the allowed bad fraction.
    1.0 = exactly spending budget at the sustainable pace; 0 when the
    window saw no events (no evidence is not an outage)."""
    if total <= 0:
        return 0.0
    budget = max(1e-9, 1.0 - objective)
    return (bad / total) / budget


def _tags_match(tagset: str, want: Optional[dict]) -> bool:
    if not want:
        return True
    try:
        tags = json.loads(tagset) if tagset else {}
    except ValueError:
        return False
    return all(tags.get(k) == v for k, v in want.items())


def _hist_bad_total(
    points: list, boundaries, threshold: float, window_s: float, now: float
) -> tuple[float, float]:
    delta = _m.hist_window_delta(points, window_s, now)
    if not delta:
        return 0.0, 0.0
    buckets, total = delta[:-2], delta[-1]
    good = sum(
        c for b, c in zip(boundaries or (), buckets) if float(b) <= threshold
    )
    return max(0.0, total - good), float(total)


def _counter_windows(
    series: dict, rule: "SLORule", window_s: float, now: float
) -> tuple[float, float]:
    bad = total = 0.0
    for tagset, points in series.items():
        delta = _m.series_window_delta(points, window_s, now) or 0.0
        total += delta
        if _tags_match(tagset, rule.bad_tags):
            bad += delta
    return bad, total


def evaluate_rule(rule: SLORule, merged: dict, now: Optional[float] = None) -> dict:
    """One evaluation of ``rule`` against ``merge_proc_series`` output.
    Returns ``{"breached": bool, "value": float, "detail": dict}`` where
    ``value`` is the fast-window burn rate (burn kinds) or the latest gauge
    reading (gauge_threshold)."""
    now = time.time() if now is None else now
    ent = merged.get(rule.metric)
    if ent is None:
        return {"breached": False, "value": 0.0, "detail": {"no_data": True}}
    series = ent.get("series", {})

    if rule.kind == "histogram_burn":
        bounds = ent.get("boundaries") or ()
        bf = bt = sf = st_ = 0.0
        for tagset, points in series.items():
            if not _tags_match(tagset, rule.tags):
                continue
            b, t = _hist_bad_total(points, bounds, rule.threshold,
                                   rule.fast_window_s, now)
            bf, bt = bf + b, bt + t
            b, t = _hist_bad_total(points, bounds, rule.threshold,
                                   rule.slow_window_s, now)
            sf, st_ = sf + b, st_ + t
        fast = budget_burn(bf, bt, rule.objective)
        slow = budget_burn(sf, st_, rule.objective)
        return {
            "breached": fast >= rule.fast_burn and slow >= rule.slow_burn,
            "value": fast,
            "detail": {"fast_burn": fast, "slow_burn": slow,
                       "bad_fast": bf, "total_fast": bt},
        }

    if rule.kind == "counter_burn":
        bf, bt = _counter_windows(series, rule, rule.fast_window_s, now)
        bs, bt_s = _counter_windows(series, rule, rule.slow_window_s, now)
        fast = budget_burn(bf, bt, rule.objective)
        slow = budget_burn(bs, bt_s, rule.objective)
        return {
            "breached": fast >= rule.fast_burn and slow >= rule.slow_burn,
            "value": fast,
            "detail": {"fast_burn": fast, "slow_burn": slow,
                       "bad_fast": bf, "total_fast": bt},
        }

    if rule.kind == "gauge_threshold":
        # newest reading across tagsets decides the value; breach requires
        # every sample of the trailing for_s window at/above the threshold
        # with coverage reaching back the full window
        best: Optional[tuple] = None
        for points in series.values():
            if points and (best is None or points[-1][0] > best[0]):
                best = points[-1]
                window = points
        if best is None:
            return {"breached": False, "value": 0.0, "detail": {"no_data": True}}
        value = float(best[1])
        if rule.for_s <= 0:
            breached = value >= rule.threshold
        else:
            # sustained: every sample inside the trailing for_s window is
            # at/above the threshold AND the last sample BEFORE the window
            # was too (coverage proof — a gauge that only just spiked has
            # no sample that old and must not page yet)
            start = now - rule.for_s
            in_window = [(ts, float(v)) for ts, v in window if ts > start]
            older = [float(v) for ts, v in window if ts <= start]
            breached = (
                bool(in_window)
                and all(v >= rule.threshold for _ts, v in in_window)
                and bool(older)
                and older[-1] >= rule.threshold
            )
        return {"breached": breached, "value": value, "detail": {}}

    raise ValueError(f"unknown SLO rule kind {rule.kind!r}")


# ---------------------------------------------------------------------------
# default rules (env-tunable so tests and small clusters can retune windows
# without code changes)
# ---------------------------------------------------------------------------


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def default_rules() -> list[SLORule]:
    """The shipped SLOs: TTFT p99 latency, serve request availability, and
    KV-pool saturation. Windows default to 60s/300s — sized to the
    in-memory series retention, not the workbook's 5m/1h."""
    fast = _envf("RAY_TPU_SLO_FAST_WINDOW_S", 60.0)
    slow = _envf("RAY_TPU_SLO_SLOW_WINDOW_S", 300.0)
    resolve = _envf("RAY_TPU_SLO_RESOLVE_AFTER_S", 60.0)
    return [
        SLORule(
            name="ttft-p99",
            metric="llm_time_to_first_token_s",
            kind="histogram_burn",
            objective=_envf("RAY_TPU_SLO_TTFT_OBJECTIVE", 0.99),
            threshold=_envf("RAY_TPU_SLO_TTFT_THRESHOLD_S", 2.5),
            fast_window_s=fast,
            slow_window_s=slow,
            fast_burn=_envf("RAY_TPU_SLO_FAST_BURN", 14.4),
            slow_burn=_envf("RAY_TPU_SLO_SLOW_BURN", 6.0),
            resolve_after_s=resolve,
            labels={"serve": "upscale", "severity": "page"},
            description="99% of requests reach their first token within the "
                        "threshold; both burn windows above factor pages.",
        ),
        SLORule(
            name="queue-time-burn",
            metric="llm_request_phase_s",
            kind="histogram_burn",
            tags={"phase": "queue"},
            objective=_envf("RAY_TPU_SLO_QUEUE_OBJECTIVE", 0.99),
            threshold=_envf("RAY_TPU_SLO_QUEUE_THRESHOLD_S", 1.0),
            fast_window_s=fast,
            slow_window_s=slow,
            fast_burn=_envf("RAY_TPU_SLO_FAST_BURN", 14.4),
            slow_burn=_envf("RAY_TPU_SLO_SLOW_BURN", 6.0),
            resolve_after_s=resolve,
            labels={"serve": "upscale", "severity": "page"},
            description="99% of requests spend under the threshold waiting "
                        "in the engine queue (phase ledger's queue leg) — "
                        "queue burn is the capacity signal: it pages and "
                        "asks the autoscaler for replicas BEFORE TTFT "
                        "breaches, because queueing is where overload "
                        "lands first (the loadgen overload arm is the "
                        "reproduction).",
        ),
        SLORule(
            name="request-errors",
            metric="serve_requests",
            kind="counter_burn",
            objective=_envf("RAY_TPU_SLO_ERROR_OBJECTIVE", 0.99),
            bad_tags={"status": "5xx"},
            fast_window_s=fast,
            slow_window_s=slow,
            fast_burn=_envf("RAY_TPU_SLO_FAST_BURN", 14.4),
            slow_burn=_envf("RAY_TPU_SLO_SLOW_BURN", 6.0),
            resolve_after_s=resolve,
            labels={"severity": "page"},
            description="99% of proxied requests succeed (non-5xx).",
        ),
        SLORule(
            name="kv-pool-exhaustion",
            metric="llm_kv_block_utilization",
            kind="gauge_threshold",
            threshold=_envf("RAY_TPU_SLO_KV_THRESHOLD", 0.97),
            for_s=_envf("RAY_TPU_SLO_KV_FOR_S", 30.0),
            resolve_after_s=resolve,
            labels={"serve": "upscale", "severity": "warn"},
            description="Paged-KV pool pinned at/above the threshold long "
                        "enough that preemption thrash is imminent.",
        ),
        SLORule(
            name="rlhf-staleness",
            metric="rlhf_weights_staleness",
            kind="gauge_threshold",
            # the async RLHF learner publishes the mean version-age of
            # every batch it consumes; sustained high staleness means
            # weight pushes are not landing on the rollout engines
            # (object-plane backlog, dead rollout actor, learner
            # outrunning generation) and the importance correction is
            # carrying more off-policy drift than the trust region wants
            threshold=_envf("RAY_TPU_SLO_RLHF_STALENESS", 8.0),
            for_s=_envf("RAY_TPU_SLO_RLHF_STALENESS_FOR_S", 30.0),
            resolve_after_s=resolve,
            labels={"severity": "warn"},
            description="RLHF trajectories consumed by the learner are "
                        "persistently many weight versions stale — the "
                        "rollout plane is falling behind the sync push.",
        ),
        SLORule(
            name="retrace-storm",
            metric="device_retraces",
            kind="counter_burn",
            # EVERY retrace is a bad event (bad_tags None selects all
            # series): a jit site recompiling after its warmup baseline
            # (util.device_prof — RL014's runtime twin) pays a full
            # XLA compile mid-traffic, so any nonzero window rate burns
            # the whole budget and fires while the storm is live; zero
            # retraces is the steady state and evaluates as no-evidence
            objective=_envf("RAY_TPU_SLO_RETRACE_OBJECTIVE", 0.99),
            fast_window_s=fast,
            slow_window_s=slow,
            fast_burn=_envf("RAY_TPU_SLO_FAST_BURN", 14.4),
            slow_burn=_envf("RAY_TPU_SLO_SLOW_BURN", 6.0),
            resolve_after_s=resolve,
            labels={"severity": "warn"},
            description="A jitted entry point (decode/prefill/verify/"
                        "fork/train step) is RECOMPILING after warmup — "
                        "static shapes are broken somewhere; each retrace "
                        "stalls every request in the batch for a compile.",
        ),
        SLORule(
            name="engine-stall",
            metric="llm_watchdog_step_age_s",
            kind="gauge_threshold",
            # the watchdog (llm.watchdog) publishes the age of the last
            # engine step while work is pending, 0 when idle/healthy — a
            # sustained non-zero age is a wedged step loop, the whole
            # replica's streams frozen at once
            threshold=_envf("RAY_TPU_SLO_STALL_S", 30.0),
            for_s=_envf("RAY_TPU_SLO_STALL_FOR_S", 10.0),
            resolve_after_s=resolve,
            labels={"severity": "page"},
            description="LLM engine step loop has made no progress with "
                        "work pending — streams are frozen; the watchdog's "
                        "llm.watchdog.stall event carries the diagnosis.",
        ),
        SLORule(
            name="arena-pressure",
            metric="core_arena_occupancy",
            kind="gauge_threshold",
            # the head publishes the WORST node's arena used/capacity
            # ratio (object ledger); sustained occupancy above
            # the bound means puts are about to degrade to the inline
            # path (agents) or start spilling (head) — check obs arena
            # for the node and obs objects for what holds the bytes
            threshold=_envf("RAY_TPU_SLO_ARENA_OCCUPANCY", 0.9),
            for_s=_envf("RAY_TPU_SLO_ARENA_FOR_S", 30.0),
            resolve_after_s=resolve,
            labels={"severity": "warn"},
            description="A node's object arena is sustained at/above the "
                        "occupancy bound — zero-copy puts are about to "
                        "degrade (agent inline fallback / head spilling).",
        ),
        SLORule(
            name="spill-burn",
            metric="core_object_spills",
            kind="counter_burn",
            # EVERY spill is a bad event (bad_tags None selects all
            # series): each one is a full serialize-to-disk round trip
            # plus a restore on next access, so a sustained window rate
            # burns the whole budget while the thrash is live; zero
            # spills is the steady state and evaluates as no-evidence
            objective=_envf("RAY_TPU_SLO_SPILL_OBJECTIVE", 0.99),
            fast_window_s=fast,
            slow_window_s=slow,
            fast_burn=_envf("RAY_TPU_SLO_FAST_BURN", 14.4),
            slow_burn=_envf("RAY_TPU_SLO_SLOW_BURN", 6.0),
            resolve_after_s=resolve,
            labels={"severity": "warn"},
            description="The head is spilling directory objects to disk "
                        "under arena pressure — the working set no longer "
                        "fits; every get of a spilled object pays a "
                        "restore round trip.",
        ),
    ]
