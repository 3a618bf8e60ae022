"""Request tracing: request ids, trace context, sampling and spans (copy
of ``ray_tpu/util/tracing.py``, the process-local part).

Application code brackets its own regions and they land in this process's
bounded span ring:

    from ray_tpu_torch.util import tracing

    with tracing.span("preprocess", batch=i):
        ...

The serving engine wraps every step in an ``llm_engine_step`` span.

**Trace context.** A request id is minted by ``trace_context()`` in
application code (or, in the reference, at its serve proxy) and carried
as a per-thread context; every ``span`` and flight-recorder event
recorded underneath is tagged with it, and an engine request submitted
under it takes it as its ``trace_id``. ``request_lanes`` renders this
process's spans and events as one Chrome-trace lane per request.

**Sampling.** ``RAY_TPU_TRACE_SAMPLE`` (0..1, the reference's knob) makes
the keep/drop decision once per request id, at mint: an unsampled context
records no spans at all, for free. ``RAY_TPU_TRACE_MAX_SPANS`` caps the
span ring. The cluster-wide collection (``collect_cluster_spans``,
``export_chrome_trace``) waits for the runtime's port (ROADMAP.md, queue
A).
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
