"""Task/actor tracing (copy of ``ray_tpu/util/tracing.py``; reference: ``python/ray/util/tracing/tracing_helper.py``
— OpenTelemetry spans around submit/execute when RAY_TRACING_ENABLED).

OpenTelemetry isn't bundled, so spans are recorded into the head's task-event
stream instead: every task already carries PENDING/RUNNING/FINISHED
transitions with timestamps (``head.task_events``), which ``timeline()``
exports as a Chrome trace. This module adds the *user-defined* span surface
on top: application code brackets its own regions and they land in the same
timeline, nested per process/actor.

    from ray_tpu_torch.util import tracing

    with tracing.span("preprocess", batch=i):
        ...

``tracing.export_chrome_trace(path)`` merges runtime task events, user
spans, and flight-recorder request events into one chrome://tracing-loadable
JSON file — with one lane per request for everything that carries a
``request_id``.

**Trace context.** A request_id is minted at the serve proxy (or by
``trace_context()`` in application code, or implicitly at ``remote()``
submission) and carried as a per-thread context: ``remote()`` /
actor-method submissions stamp it into the task spec, the executing worker
re-installs it around the task body, and every ``span``/flight-recorder
event recorded underneath is tagged with it.  One request's life across
proxy → router → replica → engine is thereby a single correlated trace
(``python -m ray_tpu_torch.obs req <id>``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional


def _env_max_spans() -> int:
    """Span retention cap (``RAY_TPU_TRACE_MAX_SPANS``): always-on tracing
    in a long-lived engine process must be bounded — before this cap the
    span list grew without limit for the process's lifetime."""
    try:
        return max(16, int(os.environ.get("RAY_TPU_TRACE_MAX_SPANS", "8192")))
    except ValueError:
        return 8192


_rate_cache: tuple = ("1", 1.0)  # (raw env string, parsed) — parse once


def _env_sample_rate() -> float:
    """Head-sampling rate (``RAY_TPU_TRACE_SAMPLE``, 0..1, default 1.0):
    the keep/drop decision is made once per request id, deterministically
    from the id itself, so every process in the request's path agrees
    without coordination (no half-sampled traces). The float parse is
    cached keyed on the raw env string — this sits on the span/context
    hot path, and tests retune the env on a live process."""
    global _rate_cache
    raw = os.environ.get("RAY_TPU_TRACE_SAMPLE", "1")
    cached_raw, cached = _rate_cache
    if raw == cached_raw:
        return cached
    try:
        rate = min(1.0, max(0.0, float(raw)))
    except ValueError:
        rate = 1.0
    _rate_cache = (raw, rate)
    return rate


_local = threading.local()
_lock = threading.Lock()
# finished spans of THIS process: bounded drop-oldest ring
_spans: deque = deque(maxlen=_env_max_spans())
_dropped_spans = 0
_drop_counter = None  # lazy metrics.Counter — created on first drop only


def _now_us() -> float:
    return time.time() * 1e6


def configure(max_spans: Optional[int] = None) -> None:
    """Resize the span ring (tests/tuning; keeps the newest spans)."""
    global _spans
    if max_spans is not None:
        with _lock:
            _spans = deque(_spans, maxlen=max(16, int(max_spans)))


def span_stats() -> dict:
    with _lock:
        return {
            "capacity": _spans.maxlen,
            "size": len(_spans),
            "dropped": _dropped_spans,
        }


def _count_dropped_span() -> None:
    # caller holds _lock; the metric is created lazily so processes that
    # never hit the cap never pay for a metrics registry entry
    global _dropped_spans, _drop_counter
    _dropped_spans += 1
    if _drop_counter is None:
        from ray_tpu_torch.util.metrics import safe_counter

        # False (not None) when unavailable: don't retry every drop
        _drop_counter = safe_counter(
            "tracing_dropped_spans",
            "spans evicted by the per-process retention cap",
        ) or False
    if _drop_counter:
        try:
            _drop_counter.inc()
        except Exception:
            pass


def trace_sampled(request_id: Optional[str]) -> bool:
    """Head-sampling decision for a request id (None = unsampled-context
    spans, always kept). Deterministic across processes: the id's leading
    hex bits against the sample rate."""
    rate = _env_sample_rate()
    if rate >= 1.0 or not request_id:
        return True
    if rate <= 0.0:
        return False
    try:
        bits = int(request_id[:8], 16)
    except ValueError:
        bits = hash(request_id) & 0xFFFFFFFF
    return bits / 0xFFFFFFFF < rate


# ---------------------------------------------------------------------------
# trace context (request_id propagation)
#
# Three context shapes ride the per-thread slot:
#
# * a plain dict ``{"request_id": rid}`` — a SAMPLED context: propagated in
#   task specs, tags spans/events (the original shape, still the
#   compatibility contract for hand-installed contexts);
# * :class:`UnsampledContext` — the head-sampling decision said "drop",
#   made ONCE at mint. It is an immutable token: spans under it skip
#   allocation/locking entirely, ``remote()`` skips spec tagging (no
#   cross-process shipping), and nothing downstream pays for tracing.
# * :class:`LazyTaskContext` — a rootless task executing on a worker. The
#   task-id-rooted request id (and its sampling decision) materialize only
#   when something actually asks (an event, a span, a nested submission) —
#   a plain noop task pays ZERO context cost end to end.
# ---------------------------------------------------------------------------


class UnsampledContext:
    """Immutable unsampled-trace token. Carries the request id so
    forensics stay correlated at ANY sample rate — ``record()`` events,
    head task-event rows, and `obs req <id>` all keep the request id;
    only SPANS are dropped, and they are dropped for free (the token
    short-circuits ``span()`` before any allocation). The token itself
    rides task specs — one shared immutable object per request, shipped
    by reference (no per-task dict copies) — so every downstream hop
    inherits the mint-time decision and half-sampled traces cannot
    happen (the module's no-coordination invariant)."""

    __slots__ = ("request_id",)
    sampled = False

    def __init__(self, request_id: Optional[str]):
        object.__setattr__(self, "request_id", request_id)

    def __setattr__(self, name, value):  # immutability: tokens are shared
        raise AttributeError("UnsampledContext is immutable")

    def __reduce__(self):  # __slots__ + frozen setattr need explicit pickle
        return (UnsampledContext, (self.request_id,))

    def get(self, key, default=None):  # dict-compatible read surface
        return self.request_id if key == "request_id" else default

    def __repr__(self):
        return f"UnsampledContext({self.request_id!r})"


class LazyTaskContext:
    """Rootless-task context: the request id derives from the task id the
    moment someone asks for it (and the sampling decision with it). Built
    worker-side for specs that carry no ``trace_ctx``."""

    __slots__ = ("_task_id", "_rid", "_sampled")

    def __init__(self, task_id: bytes):
        self._task_id = task_id
        self._rid = None
        self._sampled = None

    @property
    def request_id(self) -> str:
        rid = self._rid
        if rid is None:
            rid = self._rid = self._task_id.hex()[:16]
        return rid

    @property
    def sampled(self) -> bool:
        s = self._sampled
        if s is None:
            s = self._sampled = trace_sampled(self.request_id)
        return s

    def get(self, key, default=None):
        return self.request_id if key == "request_id" else default

    def __repr__(self):
        return f"LazyTaskContext({self.request_id!r})"


def new_request_id() -> str:
    """Mint a fresh request id (16 hex chars — short enough to grep, wide
    enough to never collide within a cluster's lifetime). ``os.urandom``
    rather than uuid4: same 64 bits of entropy at a fifth of the cost
    (this runs once per request on the serve hot path)."""
    return os.urandom(8).hex()


def mint_context(request_id: Optional[str] = None):
    """Build a context for ``request_id`` (minting an id if None), making
    the head-sampling decision HERE, once: sampled requests get the dict
    shape, unsampled requests get the cheap immutable token that every
    downstream hot path short-circuits on."""
    rid = request_id or new_request_id()
    if trace_sampled(rid):
        return {"request_id": rid}
    return UnsampledContext(rid)


def get_trace_context():
    """The calling thread's active trace context ({"request_id": ...}, an
    :class:`UnsampledContext`, a :class:`LazyTaskContext`) or None."""
    return getattr(_local, "trace_ctx", None)


def set_trace_context(ctx):
    """Install (or clear, with None) the thread's trace context; returns
    the previous one so callers can restore it."""
    prev = getattr(_local, "trace_ctx", None)
    _local.trace_ctx = ctx
    return prev


def context_sampled(ctx) -> bool:
    """Whether spans under ``ctx`` are kept. None (no context) keeps —
    context-less spans are always retained, as before."""
    if ctx is None:
        return True
    if type(ctx) is dict:
        # hand-installed dicts predate mint-time decisions: fall back to
        # the deterministic per-id check so sampling still applies
        return trace_sampled(ctx.get("request_id"))
    return ctx.sampled


def context_for_spec(ctx):
    """What ``remote()``/actor submission ships in ``spec["trace_ctx"]``
    for an active context: the dict or unsampled token itself (shipped
    by reference — no copy; the token keeps forensics correlated and
    pins the mint-time sampling decision downstream), or a context
    materialized from a lazy root — as a dict when its task-rooted id
    sampled, as a token when it didn't, so nested hops under a rootless
    root also inherit ONE coherent decision."""
    if type(ctx) is dict or type(ctx) is UnsampledContext:
        return ctx
    if type(ctx) is LazyTaskContext:
        if ctx.sampled:
            return {"request_id": ctx.request_id}
        return UnsampledContext(ctx.request_id)
    return None


def task_context(spec_ctx, task_id: bytes):
    """The context a worker installs around a task body: the submitter's
    shipped context when the spec carries one, else a lazy task-rooted
    context that costs nothing until observed."""
    if spec_ctx is not None:
        return spec_ctx
    return LazyTaskContext(task_id)


def current_request_id() -> Optional[str]:
    ctx = getattr(_local, "trace_ctx", None)
    if ctx is None:
        return None
    if type(ctx) is dict:
        return ctx.get("request_id")
    return ctx.request_id


@contextlib.contextmanager
def trace_context(request_id: Optional[str] = None) -> Iterator[str]:
    """Scope a request id onto this thread (minting one if not given);
    spans, flight-recorder events, and remote() hops underneath carry it.
    The sampling decision happens here, once per request."""
    ctx = mint_context(request_id)
    rid = ctx.get("request_id")  # both context shapes expose .get
    prev = set_trace_context(ctx)
    try:
        yield rid
    finally:
        set_trace_context(prev)


class _NullSpan:
    """Shared do-nothing span: what an unsampled request's ``span()``
    returns — no allocation, no clock read, no lock."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A recording span (context manager). Nesting tracks a per-thread
    stack so child spans indent under their parent in the trace viewer;
    an active trace context tags the span's args with its request_id
    (one lane per request in the exported trace)."""

    __slots__ = ("name", "attributes", "t0", "depth")

    def __init__(self, name: str, attributes: dict):
        self.name = name
        self.attributes = attributes

    def __enter__(self):
        self.depth = depth = getattr(_local, "depth", 0)
        _local.depth = depth + 1
        self.t0 = _now_us()
        return None

    def __exit__(self, *exc):
        depth = self.depth
        _local.depth = depth
        rec = {
            "name": self.name,
            "cat": "user",
            "ph": "X",
            "ts": self.t0,
            "dur": _now_us() - self.t0,
            "pid": f"proc-{os.getpid()}",
            "tid": f"thread-{threading.get_ident() & 0xFFFF}-d{depth}",
        }
        rid = current_request_id()
        attributes = self.attributes
        if attributes or rid:
            args = {k: _jsonable(v) for k, v in attributes.items()}
            if rid:
                args.setdefault("request_id", rid)
            rec["args"] = args
        with _lock:
            if len(_spans) == _spans.maxlen:
                _count_dropped_span()
            _spans.append(rec)
        return False


def span(name: str, **attributes: Any):
    """Record a named region (``with tracing.span("step", batch=i):``).

    ZERO-COST when unsampled: the mint-time head-sampling decision lives
    on the context, so an unsampled request's spans return a shared null
    manager — no record dict, no clock reads, no span-ring lock; the
    body just runs."""
    ctx = getattr(_local, "trace_ctx", None)
    if ctx is not None and not context_sampled(ctx):
        return _NULL_SPAN
    return _Span(name, attributes)


#: attribute types ``json.dumps`` always takes as they are
_JSON_SCALARS = (str, int, float, bool, type(None))


def _jsonable(v: Any):
    """``v`` when JSON can carry it, else its repr. The scalar types skip the
    trial ``json.dumps`` (each costs a few µs, and the engine's step span
    carries several attributes a step); the result is the reference's."""
    if type(v) in _JSON_SCALARS:
        return v
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


def get_spans() -> list[dict]:
    """Finished user spans recorded in this process."""
    with _lock:
        return list(_spans)


def clear() -> None:
    with _lock:
        _spans.clear()


def collect_cluster_spans() -> list[dict]:
    """Gather user spans from every live worker (a task per node would be
    overkill; workers ship spans through a collector task)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _drain():
        from ray_tpu_torch.util import tracing as t

        out = t.get_spans()
        t.clear()
        return out

    # best effort: one collector task (workers sharing that process drain);
    # driver-local spans are always included
    out = list(get_spans())
    try:
        out += ray_tpu_torch.get(_drain.remote(), timeout=10)
    except Exception:
        pass
    return out


def request_lanes(
    spans: list[dict], recorder_events: list[dict]
) -> list[dict]:
    """Chrome-trace entries giving each request its own lane: spans whose
    args carry a request_id are mirrored into pid="requests"/tid=<id>, and
    flight-recorder events with a request_id become instant markers on the
    same lane — proxy→replica→engine spans plus per-token events line up
    under one request.

    Single-entry ids are NOT mirrored: every rootless ``remote()``
    submission auto-mints a request_id, so a plain 50k-task batch job
    would otherwise double its trace into 50k one-slice lanes.  A lane
    only earns its row when the id correlates at least two records —
    which every served/multi-hop request does."""
    counts: dict[str, int] = {}
    for s in spans:
        rid = (s.get("args") or {}).get("request_id")
        if rid:
            counts[rid] = counts.get(rid, 0) + 1
    for ev in recorder_events:
        rid = ev.get("request_id")
        if rid:
            counts[rid] = counts.get(rid, 0) + 1
    lanes: list[dict] = []
    for s in spans:
        rid = (s.get("args") or {}).get("request_id")
        if not rid or counts[rid] < 2:
            continue
        lanes.append({**s, "pid": "requests", "tid": f"req:{rid}"})
    for ev in recorder_events:
        rid = ev.get("request_id")
        if not rid or counts[rid] < 2:
            continue
        args = {
            k: v
            for k, v in ev.items()
            if k not in ("ts", "type", "seq", "request_id")
        }
        lanes.append(
            {
                "name": ev.get("type", "event"),
                "cat": "request",
                "ph": "i",
                "s": "t",  # thread-scoped instant marker
                "ts": ev.get("ts", 0.0) * 1e6,
                "pid": "requests",
                "tid": f"req:{rid}",
                "args": args,
            }
        )
    return lanes


def export_chrome_trace(path: Optional[str] = None) -> list[dict]:
    """Runtime task events + user spans + per-request lanes as one Chrome
    trace (reference: ``ray timeline``, ``_private/state.py:924``). Every
    span/flight-recorder event carrying a request_id additionally lands in
    a ``requests``-group lane keyed by its id, so one request's whole life
    reads as a single row in chrome://tracing / Perfetto. Sampled tasks'
    folded waterfall records (util.waterfall) render as NESTED slices —
    a total-duration slice with the seven hop legs inside it — on a
    ``waterfall`` process group."""
    from ray_tpu_torch._private import events as ev
    from ray_tpu_torch.util import state as st

    spans = st.timeline() + collect_cluster_spans()
    recorder = ev.collect_cluster_events()
    events = spans + request_lanes(spans, recorder)
    try:
        from ray_tpu_torch._private.runtime import get_ctx
        from ray_tpu_torch.util import waterfall as _wf

        recent = get_ctx().call("waterfall", recent=_wf._RECENT_CAP)
        events += _wf.chrome_slices(recent.get("recent", []))
    except Exception:
        pass  # head without the waterfall rpc / no folded records
    if path:
        with open(path, "w") as f:
            json.dump(events, f)
    return events
