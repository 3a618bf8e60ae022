"""Task-hop waterfall: where a task's microseconds go, hop by hop.

The core plane is IPC-bound (BENCH_r06 showed telemetry absent from the
sync-task profile), but "IPC-bound" is not actionable — batched RPCs and
submission pipelining need to know WHICH hop owns the time.  This module
stamps monotonic phase timestamps onto task specs and replies and folds
completed records into per-phase histograms on the head:

    submit → serialize → socket_write → head_dispatch →
    worker_deserialize → exec_start → exec_end → reply_recv

Eight stamps give the eight-phase breakdown ``obs waterfall`` renders
(seven consecutive legs plus ``total``):

| phase | measures |
|---|---|
| ``submit``             | argument serialization (``serialize_args``) |
| ``serialize``          | spec build + submit-RPC entry |
| ``socket_write``       | client→head transfer + head queue/schedule |
| ``head_dispatch``      | head→worker transfer + worker queue |
| ``worker_deserialize`` | function resolve + argument fetch/deserialize |
| ``exec``               | the task body itself |
| ``reply``              | result store + worker→head completion |
| ``total``              | submit → reply received |

Zero-cost contract: stamps ride the SAMPLED trace path only.
``maybe_start`` returns a stamp list only for a sampled dict context —
unsampled tokens, lazy rootless contexts, and streaming tasks ship no
stamps and pay one ``type()`` check.  The emit path (``maybe_start`` /
``stamp``) is append-plus-clock: no locks, no allocation beyond the one
list per sampled task — ``tests/test_obs_hotpath.py`` extends the
index-backed zero-lock lint fixture over both functions.  All folding
cost (histogram observes, the recent-record ring) lives on the head at
reply time, off every submitter's and worker's path.

Clocks: stamps are ``time.time()`` so they compare across processes on
one host (workers share the head's clock).  A wall-clock step can
produce a negative leg; the fold clamps legs at zero rather than
discarding the record.

Batched legs: the 7-phase contract survives submission
pipelining and reply coalescing — each task keeps its OWN stamp list,
and batching moves WHERE a stamp is taken, never whether.  A spec
buffered in a driver/worker submit outbox takes ``socket_write`` when
its batch is actually written (queue time charges the socket_write leg);
``head_dispatch`` covers the head outbox + coalesced ``run_task_batch``
write + the worker recv loop's receive-and-parse, with
``worker_deserialize`` stamped AT that receipt — so task #64 of a deep
batch charges its exec-queue wait to its own
worker_deserialize→exec_start leg, not to the head's hop; a completion
deferred into the worker's reply outbox charges the defer + batch write
to its ``reply`` leg.  Phases are never dropped for batched tasks, and
per-task stamps stay monotonic because every boundary is stamped at the
moment that task's bytes (or its batch's bytes) move.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

#: stamp names in spec/reply order — index i of a record's stamp list
PHASES = (
    "submit",
    "serialize",
    "socket_write",
    "head_dispatch",
    "worker_deserialize",
    "exec_start",
    "exec_end",
    "reply_recv",
)

#: the rendered breakdown: (leg name, start stamp index, end stamp index)
LEGS = (
    ("submit", 0, 1),
    ("serialize", 1, 2),
    ("socket_write", 2, 3),
    ("head_dispatch", 3, 4),
    ("worker_deserialize", 4, 5),
    ("exec", 5, 6),
    ("reply", 6, 7),
    ("total", 0, 7),
)

#: raylint RL012 registry — the per-leg histogram the head folds into
#: and the fold counters beside it
METRIC_NAMES = (
    "core_task_phase_s",
    "core_task_waterfalls",
    "core_task_waterfall_incomplete",
)

#: boundaries sized for per-hop microseconds on a local socket up through
#: real execution seconds (the default metrics boundaries start at 5ms —
#: every IPC leg would land in the first bucket)
_PHASE_BOUNDARIES = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 1.0, 5.0,
)

_METRICS = None
_METRICS_LOCK = threading.Lock()

#: per-leg tag dicts built once — fold() runs on the head at every reply
#: receipt, and 8 dict literals per fold showed up in the reply-leg p50
_LEG_TAGS = {name: {"phase": name} for name, _i, _j in LEGS}

# newest folded records, for chrome-trace nested slices (obs timeline)
# and obs waterfall --recent; bounded drop-oldest
_RECENT_CAP = 256
_recent: deque = deque(maxlen=_RECENT_CAP)
_folded = 0
_incomplete = 0

#: raylint RL017 — _recent is appended by whichever head thread folds a
#: reply and snapshot by summary() with list(); deque ops are GIL-atomic
#: (the RuntimeError retry in summary() handles the one observable race).
#: clear() is a tests-only reset, suppressed inline below.
LOCKFREE = ("_recent: atomic",)


def _metrics() -> dict:
    global _METRICS
    if _METRICS is not None:
        return _METRICS
    with _METRICS_LOCK:
        if _METRICS is not None:
            return _METRICS
        from ray_tpu_torch.util.metrics import Counter, Histogram

        _METRICS = {
            "phase": Histogram(
                "core_task_phase_s",
                "per-hop task-plane latency (submit/serialize/socket_write/"
                "head_dispatch/worker_deserialize/exec/reply/total)",
                boundaries=_PHASE_BOUNDARIES,
                tag_keys=("phase",),
            ),
            "folded": Counter(
                "core_task_waterfalls",
                "complete 8-stamp waterfall records folded on the head",
            ),
            "incomplete": Counter(
                "core_task_waterfall_incomplete",
                "stamped tasks whose reply carried a partial stamp list "
                "(errors before exec, retries re-dispatched, streaming)",
            ),
        }
    return _METRICS


# ---------------------------------------------------------------------------
# emit path (submitter / head / worker) — must stay lock-free
# ---------------------------------------------------------------------------


def maybe_start(spec_ctx) -> Optional[list]:
    """The submit stamp, taken only when the spec ships a SAMPLED dict
    trace context.  Unsampled tokens / lazy roots / no context return
    None — the task pays one ``type()`` check and ships nothing."""
    if type(spec_ctx) is dict:
        return [time.time()]
    return None


def stamp(wf: list) -> None:
    """Append the next phase timestamp (clock read + list append)."""
    wf.append(time.time())


# ---------------------------------------------------------------------------
# fold path (head, at reply receipt) and query surface
# ---------------------------------------------------------------------------


def fold(wf: list, spec: Optional[dict] = None) -> bool:
    """Head-side: close a reply's stamp list with ``reply_recv``, observe
    every leg into the per-phase histogram, and keep the record for the
    timeline.  Only exact 7-stamp replies fold (an error before
    ``exec_start``, or a retry whose spec accumulated a second
    ``head_dispatch``, yields a partial list — counted, not folded).
    Returns True when the record folded."""
    global _folded, _incomplete
    m = _metrics()
    if len(wf) == len(PHASES):
        wf = list(wf)  # reply_recv already stamped at message receipt
    elif len(wf) != len(PHASES) - 1:
        _incomplete += 1
        m["incomplete"].inc()
        return False
    else:
        wf = list(wf)
        wf.append(time.time())
    legs = {}
    observe = m["phase"].observe
    for name, i, j in LEGS:
        dur = max(0.0, wf[j] - wf[i])  # clamp wall-clock steps
        legs[name] = dur
        observe(dur, tags=_LEG_TAGS[name])
    m["folded"].inc()
    _folded += 1
    rec = {"stamps": wf, "legs": legs}
    if spec is not None:
        rec["name"] = spec.get("name")
        rec["kind"] = spec.get("kind")
        tctx = spec.get("trace_ctx")
        if tctx is not None:
            rec["request_id"] = tctx.get("request_id")
    _recent.append(rec)
    return True


def summary(recent: int = 0) -> dict:
    """The head's folded view: per-leg percentile summaries (what ``obs
    waterfall`` / the ``obs top`` row render) plus, optionally, the
    newest ``recent`` raw records (what the chrome trace nests)."""
    m = _metrics()
    legs = {
        name: m["phase"].percentiles(
            qs=(0.5, 0.95, 0.99), tags={"phase": name}
        )
        for name, _i, _j in LEGS
    }
    out = {
        "folded": _folded,
        "incomplete": _incomplete,
        "phases": list(PHASES),
        "legs": legs,
    }
    if recent:
        try:
            rows = list(_recent)
        except RuntimeError:
            # a concurrent fold appended mid-iteration (deque iterators
            # refuse mutation); one retry sees the settled ring
            rows = list(_recent)
        out["recent"] = rows[-recent:]
    return out


def clear() -> None:
    """Test hook: drop the recent ring + fold counts (histograms are
    process-lifetime like every metric). A reset racing a live fold is
    advisory by contract — tests quiesce the plane first — hence the
    RL017 suppressions on the fold-counter stores."""
    global _folded, _incomplete
    _recent.clear()
    _folded = 0  # raylint: disable=RL017
    _incomplete = 0  # raylint: disable=RL017


def chrome_slices(records: list[dict]) -> list[dict]:
    """Nested chrome-trace slices for folded records (``obs timeline``):
    per record one ``total`` slice with the seven legs nested inside it,
    on a ``waterfall`` process group — request-tagged records lane by
    request id, the rest by task name."""
    out = []
    for rec in records:
        stamps = rec.get("stamps")
        if not stamps or len(stamps) != len(PHASES):
            continue
        rid = rec.get("request_id")
        tid = f"req:{rid}" if rid else (rec.get("name") or "task")
        base = {
            "cat": "waterfall",
            "ph": "X",
            "pid": "waterfall",
            "tid": tid,
        }
        args = {"kind": rec.get("kind"), "name": rec.get("name")}
        if rid:
            args["request_id"] = rid
        out.append(
            {
                **base,
                "name": rec.get("name") or "task",
                "ts": stamps[0] * 1e6,
                "dur": max(0.0, stamps[-1] - stamps[0]) * 1e6,
                "args": args,
            }
        )
        for name, i, j in LEGS:
            if name == "total":
                continue
            out.append(
                {
                    **base,
                    "name": name,
                    "ts": stamps[i] * 1e6,
                    "dur": max(0.0, stamps[j] - stamps[i]) * 1e6,
                }
            )
    return out
