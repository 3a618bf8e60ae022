"""Per-request phase ledger: where a served LLM request's milliseconds go
(copy of ``ray_tpu/util/phases.py``).

The task-plane waterfall (``util.waterfall``) breaks one *task hop* into
phases; this module does the same for one *LLM request* across its whole
life — proxy recv → router dispatch → engine queue → admission →
prefill → decode → stream delivery — so ``obs attribute`` can say which
phase owns the p99 instead of "the engine took 2s".

Design (hot-path contract, ≤2µs/stamp):

* **Engine side** — every ``Request`` carries a tiny ledger: a plain
  float list ``[cursor, dur_0 .. dur_K]`` where ``cursor`` is the wall
  time of the last stamp and ``dur_i`` accumulates seconds attributed
  to engine phase ``i``. The one stamp primitive, :func:`charge`, is
  two float ops and two list stores — no locks, no allocation, no dict
  lookups (call sites pass the module's integer index constants). All
  ledger touches happen on the thread that owns the request at that
  moment (the submitter at submit, the step thread afterwards — the
  engine lock serializes the handoff), so the ledger is single-writer
  by construction. ``tests/test_torch_observability.py`` pins
  ``new_ledger`` / ``charge`` at zero transitive lock acquisitions.
* **Complete and non-overlapping by construction** — the cursor model
  attributes *every* interval from submit to finish to exactly one
  phase: each engine event charges "now − cursor" to its phase and
  advances the cursor. There is nothing to double-count and no gap to
  lose; the identity "Σ engine phases == finish − submit" is exact up
  to float rounding (``tests/test_torch_engine_hooks.py`` pins it across
  spec-decode, preemption recompute, prefix hits and deadlines).
* **Preemption is attributed, not lumped** — a preempted request's
  recompute (re-queue, re-admit, re-prefill) charges the ``preempt``
  phase via ``Request.phase_recompute``, never ``queue``/``prefill``,
  so recompute cost is visible as its own line.
* **Prefix-cache hits land in ``admit``** — admission performs the
  radix match and block sharing, so matched-prefix time is charged to
  ``admit`` by the cursor; ``prefill`` covers only the uncached suffix.
* **Proxy side** — the proxy stamps four wall-clock anchors (recv,
  dispatch, first chunk, done-sentinel receipt ≈ engine finish, fully
  written) and folds them at stream completion; the dispatch anchor
  additionally rides the request's sampled ``trace_ctx`` dict
  (``t_dispatch``) so the engine can observe the cross-process
  ``dispatch`` leg into the histogram family.
* **Failover resume never double-counts** — a resumed submit
  (``resume_tokens``) starts a FRESH ledger covering only the second
  attempt; already-delivered token phases are not re-charged, and the
  resumed engine skips the ``dispatch`` observe (its gap to the proxy
  dispatch anchor spans the dead attempt — ``obs attribute`` reports
  that interval as the ``failover`` component instead).

Clocks: stamps are ``time.time()`` so anchors compare across processes
on one host (same contract as ``util.waterfall``); a wall-clock step can
produce a negative leg, which folds clamp at zero. Cross-host proxy ↔
replica skew is absorbed into the ``dispatch``/``stream`` legs — the
engine-internal phases are single-clock and immune.

Export: the low-cardinality ``llm_request_phase_s{phase=…}`` histogram
family (fleet percentiles survive ring eviction) plus two recorder
events — ``llm.phase.ledger`` (engine fold at finish: the full
decomposition + submit/finish anchors) and ``llm.phase.proxy`` (proxy
fold at stream completion: the four anchors). ``obs attribute`` merges
both into per-request decompositions; ``RAY_TPU_PHASES=0`` disables
stamping entirely (the bench A/B arm).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ray_tpu_torch._private import events as _events

#: the full phase registry — (name, owner, start → stop edges). Order is
#: the canonical report order; grafana's derived "request phases" row and
#: the OBSERVABILITY.md table are generated/checked against this, so a
#: renamed phase cannot drift. Owners: ``proxy`` (observed by the HTTP
#: proxy), ``engine`` (observed by the engine/scheduler under its step
#: lock), ``assembly`` (computed only by ``obs attribute`` from event
#: anchors — no histogram series).
PHASES = (
    ("proxy", "proxy",
     "HTTP request parsed → stream thread hands off to the router"),
    ("dispatch", "engine",
     "proxy dispatch anchor → engine submit (cross-process; skipped for "
     "resumed submits)"),
    ("queue", "engine", "engine submit → admission pops the request"),
    ("admit", "engine",
     "admission pop → slot installed (prefix match, evict-to-fit, shed "
     "check, CoW queue — matched-prefix time lands HERE, not prefill)"),
    ("cow_fork", "engine",
     "queued copy-on-write forks applied as a batched device copy"),
    ("prefill", "engine",
     "chunked prefill of the uncached suffix (inter-chunk waits included)"),
    ("decode", "engine",
     "plain decode steps (inter-token waits included)"),
    ("spec_verify", "engine",
     "speculative draft + verify decode steps"),
    ("preempt", "engine",
     "eviction under KV pressure + the whole recompute (re-queue, "
     "re-admit, re-prefill) until the slot is running again"),
    ("stream", "proxy",
     "engine finish (done-sentinel receipt) → response fully written"),
    ("failover", "assembly",
     "proxy dispatch → resumed engine submit when a replica died "
     "mid-stream (includes the lost attempt)"),
    ("total", "proxy", "HTTP request parsed → response fully written"),
)

#: engine-ledger phases in slot order — ledger index i+1 accumulates
#: ENGINE_PHASES[i]; the integer constants below are what the engine's
#: hot call sites pass to charge() (no per-stamp dict lookups)
ENGINE_PHASES = (
    "queue", "admit", "cow_fork", "prefill", "decode", "spec_verify",
    "preempt",
)
QUEUE, ADMIT, COW_FORK, PREFILL, DECODE, SPEC_VERIFY, PREEMPT = range(
    1, len(ENGINE_PHASES) + 1
)

#: the metric and event names this module exports
METRIC_NAMES = ("llm_request_phase_s",)
EVENT_NAMES = ("llm.phase.ledger", "llm.phase.proxy")

#: sub-ms admission/queue legs up through multi-second decode tails —
#: the default metrics boundaries start at 5ms and would flatten the
#: engine-internal legs into one bucket
_PHASE_BOUNDARIES = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: per-phase tag dicts built once — folds run at every request finish
_PHASE_TAGS = {name: {"phase": name} for name, _o, _d in PHASES}

_METRICS = None
_METRICS_LOCK = threading.Lock()

#: module gate (``RAY_TPU_PHASES``, default on) — read once at import so
#: the bench A/B subprocess arms get an honest OFF; set_enabled() is the
#: in-process test hook
_ENABLED = os.environ.get("RAY_TPU_PHASES", "1") != "0"


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip the gate in-process (tests); returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def _metrics() -> dict:
    global _METRICS
    if _METRICS is not None:
        return _METRICS
    with _METRICS_LOCK:
        if _METRICS is not None:
            return _METRICS
        from ray_tpu_torch.util.metrics import Histogram

        _METRICS = {
            "phase": Histogram(
                "llm_request_phase_s",
                "per-request latency attributed by phase (proxy/dispatch/"
                "queue/admit/cow_fork/prefill/decode/spec_verify/preempt/"
                "stream/total)",
                boundaries=_PHASE_BOUNDARIES,
                tag_keys=("phase",),
            ),
        }
    return _METRICS


# ---------------------------------------------------------------------------
# emit path (engine submit/step threads) — must stay lock-free
# ---------------------------------------------------------------------------


def new_ledger(t: float) -> list:
    """A fresh request ledger anchored at wall time ``t`` (the submit):
    ``[cursor, 0.0 × len(ENGINE_PHASES)]``."""
    led = [0.0] * (len(ENGINE_PHASES) + 1)
    led[0] = t
    return led


def charge(led: list, idx: int, now: float) -> None:
    """Attribute the interval since the last stamp to engine phase
    ``idx`` (one of the module's QUEUE..PREEMPT constants) and advance
    the cursor. Two float ops — the ≤2µs/stamp budget's whole cost."""
    led[idx] += now - led[0]
    led[0] = now


# ---------------------------------------------------------------------------
# fold paths (request finish — off the per-token path)
# ---------------------------------------------------------------------------


def fold_engine(req, now: float, reason: str) -> Optional[dict]:
    """Engine-side fold at finish (called under the engine lock, once
    per request): observe every non-zero engine phase into the histogram
    family and record the full decomposition + anchors as ONE
    ``llm.phase.ledger`` event. The caller has already charged the tail
    interval, so Σ phases == now − submit exactly."""
    led = req.phase_led
    if led is None:
        return None
    observe = _metrics()["phase"].observe
    decomp = {}
    for i, name in enumerate(ENGINE_PHASES):
        dur = led[i + 1]
        if dur < 0.0:
            dur = 0.0  # clamp wall-clock steps
        decomp[name] = round(dur, 6)
        if dur > 0.0:
            observe(dur, tags=_PHASE_TAGS[name])
    fields = dict(
        request_id=req.trace_id, engine_req=req.id, reason=reason,
        t_submit=round(req.arrival_t, 6), t_finish=round(now, 6),
        resumed=req.resumed_from, phases=decomp,
    )
    if req.phase_dispatch_s is not None:
        fields["dispatch_s"] = round(req.phase_dispatch_s, 6)
    _events.record("llm.phase.ledger", **fields)
    return decomp


def note_dispatch(req, ctx) -> None:
    """Engine-side at submit: when the request's sampled trace context
    carries the proxy's dispatch anchor, observe the cross-process
    ``dispatch`` leg. Resumed submits skip it — their gap to the anchor
    spans the dead attempt and belongs to ``failover`` (assembly)."""
    req.phase_dispatch_s = None
    if type(ctx) is not dict:
        return
    t_disp = ctx.get("t_dispatch")
    if t_disp is None or req.resumed_from:
        return
    dur = req.arrival_t - t_disp
    if dur < 0.0:
        dur = 0.0  # cross-process clock step: clamp, don't discard
    req.phase_dispatch_s = dur
    _metrics()["phase"].observe(dur, tags=_PHASE_TAGS["dispatch"])


def fold_proxy(
    request_id: str,
    t_recv: float,
    t_dispatch: Optional[float],
    t_first: Optional[float],
    t_finish: Optional[float],
    t_done: float,
    status: int = 200,
) -> None:
    """Proxy-side fold at stream completion: observe the proxy-owned
    legs (``proxy``, ``stream``, ``total``) and record the anchors as
    ONE ``llm.phase.proxy`` event — what ``obs attribute`` joins against
    the engine ledger(s) to compute ``dispatch``/``stream``/``failover``
    exactly. ``t_finish`` is the done-sentinel receipt (≈ engine finish
    plus one hop; the event-anchor join uses the engine's exact
    ``t_finish`` instead)."""
    observe = _metrics()["phase"].observe
    if t_dispatch is not None:
        observe(max(0.0, t_dispatch - t_recv), tags=_PHASE_TAGS["proxy"])
    if t_finish is not None:
        observe(max(0.0, t_done - t_finish), tags=_PHASE_TAGS["stream"])
    observe(max(0.0, t_done - t_recv), tags=_PHASE_TAGS["total"])
    fields = dict(
        request_id=request_id, status=status,
        t_recv=round(t_recv, 6), t_done=round(t_done, 6),
    )
    if t_dispatch is not None:
        fields["t_dispatch"] = round(t_dispatch, 6)
    if t_first is not None:
        fields["t_first"] = round(t_first, 6)
    if t_finish is not None:
        fields["t_finish"] = round(t_finish, 6)
    _events.record("llm.phase.proxy", **fields)
