"""Flight recorder: an always-on, bounded ring of structured events (copy
of ``ray_tpu/_private/events.py``).

Reference shape: the GCS task-event stream + Ray's debug-state dumps — but
process-local and always armed, so a postmortem of a killed replica or a
preemption storm needs no re-run.

Hot-path architecture (OBSERVABILITY.md "hot-path
architecture & overhead budget"):

* **Per-thread SPSC rings.** Every emitting thread owns a private
  bounded ring (``_Ring``: one ``deque`` + counters). ``record()`` is
  thread-local append only — no shared lock, no cross-thread mutation,
  ever. The ring's ``dropped`` counter has exactly ONE writer (the
  owning thread), so overflow accounting is exact, not advisory.
* **Background collector.** A daemon thread (``events-collector``)
  folds rings whose owner thread has exited into a bounded ``_retired``
  deque (memory stays bounded by live threads + one capacity's worth of
  history from dead ones) and publishes the aggregate drop count as the
  ``events_dropped`` metric — created lazily, off the emit path.
* **Merge order.** Every event carries a process-global monotonic
  ``seq`` (``itertools.count`` — a single atomic C call, not a lock), so
  ``snapshot()`` merges the per-thread rings back into the exact global
  emission order and ``rpc_collect_events`` / crash-flush consumers see
  the same stream the one-ring design produced.
* **Signal safety.** ``snapshot()``/``flush()`` take no locks at all:
  the SIGTERM crash handler runs them from a signal frame that may have
  interrupted ``record()`` mid-append on the same thread, where any
  non-reentrant lock would deadlock the dying process. Ring creation is
  a plain dict store (atomic under the GIL) for the same reason.

Three consumers:

* **Live drain** — :func:`collect_cluster_events` gathers every live
  worker's rings through the head (same broadcast/mailbox machinery as
  the worker stack dumps), so ``python -m ray_tpu_torch.obs events`` / ``obs
  req <id>`` can reconstruct a request's life across processes.
* **Crash flush** — :func:`install_crash_handlers` arms ``sys.excepthook``
  / ``threading.excepthook`` / ``SIGTERM`` to dump the rings as JSONL into
  ``RAY_TPU_EVENTS_DIR`` before the process dies.  Workers are killed by
  SIGTERM (proc_handles), so a replica shot mid-stream still leaves its
  last ``capacity`` events per thread on disk.
* **Chrome trace** — ``util.tracing.export_chrome_trace`` renders events
  carrying a ``request_id`` as one per-request lane.

Knobs (environment, read at import):

* ``RAY_TPU_EVENTS`` — ``0`` disables recording entirely (bench A/B).
* ``RAY_TPU_EVENTS_CAPACITY`` — ring size per thread (default 8192).
* ``RAY_TPU_EVENTS_DIR`` — crash-flush directory (default
  ``<tempdir>/ray_tpu_events``).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Optional

# the one metric this module exports (raylint RL012 registry): total
# events evicted by ring overflow, across all per-thread rings
METRIC_NAMES = ("events_dropped",)

#: raylint RL017 registry — the zero-lock hot path, DECLARED so the
#: cross-thread-race analysis verifies the design instead of flagging it
#: (':atomic' = every write is one GIL-atomic operation):
#:
#: - _rings: id(ring) -> ring; registration is a plain dict store from the
#:   owning thread (atomic under the GIL — the module doc's signal-safety
#:   argument), the collector pops dead entries; snapshot() reads an
#:   atomic list() copy. The whole point of the rebuild is NO shared lock
#:   on first emit.
#: - _retired: rebuilt by the collector as ONE deque swap (publish-before-
#:   unregister); clear() is a tests/tools reset.
LOCKFREE = (
    "_rings: atomic",
    "_retired: atomic",
)


def _env_enabled() -> bool:
    return os.environ.get("RAY_TPU_EVENTS", "1").lower() not in ("0", "false", "off")


def _env_capacity() -> int:
    try:
        return max(16, int(os.environ.get("RAY_TPU_EVENTS_CAPACITY", "8192")))
    except ValueError:
        return 8192


class _Ring:
    """One thread's private event ring (SPSC: the owning thread appends,
    the collector and snapshot() only read). ``dropped`` is written by
    the owner thread alone — exact accounting, no read-modify-write race."""

    __slots__ = ("dq", "dropped", "thread", "ident")

    def __init__(self, capacity: int):
        self.dq: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.thread = threading.current_thread()
        self.ident = self.thread.ident


_enabled = _env_enabled()
_capacity = _env_capacity()
_tls = threading.local()
# id(ring) -> ring. Registration is a plain dict store (atomic under the
# GIL) so first-emit from ANY frame — including a signal handler — takes
# no lock; keying by object id means a signal-frame re-entry during ring
# creation registers a second ring instead of clobbering the first.
_rings: dict[int, _Ring] = {}
# rings of exited threads, folded here by the collector (bounded); its
# counters are collector-owned (single writer)
_retired: deque = deque(maxlen=_capacity)
_retired_dropped = 0
_seq = itertools.count()  # per-process monotonic id: stable merge order
_installed = False
_node: Optional[str] = None  # this process's node id (workers set it at boot)
_collector_started = False
_collector_gate = itertools.count()  # lock-free single-start gate
_drop_metric = None  # lazy metrics.Counter, created by the collector only
_drop_published = 0  # drops already forwarded to the metric (collector-owned)
_COLLECT_INTERVAL_S = 1.0


def set_node(node: Optional[str]) -> None:
    """Tag this process's events with its node id at the SOURCE (workers
    call this at boot). The live drain infers origin from the reply route,
    but crash-flush files and OTLP resources need it carried in-band."""
    global _node
    _node = node


def get_node() -> Optional[str]:
    return _node


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> None:
    """Toggle recording (benchmark A/B; tests). Always-on by default."""
    global _enabled
    _enabled = bool(flag)


def configure(capacity: Optional[int] = None) -> None:
    """Resize the rings (keeps the newest events; tests/tuning only —
    a producer racing the swap can lose one in-flight append)."""
    global _capacity, _retired
    if capacity is not None:
        _capacity = max(16, int(capacity))
        for ring in list(_rings.values()):
            ring.dq = deque(ring.dq, maxlen=_capacity)
        _retired = deque(_retired, maxlen=_capacity)


def record(etype: str, request_id: Optional[str] = None, **fields: Any) -> None:
    """Append one event. Hot path: a thread-local ring append — no shared
    lock, no serialization, no I/O; cost is paid only when a consumer
    drains.  Signal-safe: the crash handlers call this from signal frames
    that may have interrupted another ``record`` on the same thread, so
    every step here must be reentrant (deque.append and the counter
    increment below are single-writer or atomic C calls)."""
    if not _enabled:
        return
    ring = getattr(_tls, "ring", None)
    if ring is None:
        ring = _new_ring()
    dq = ring.dq
    if len(dq) == dq.maxlen:
        # only this thread appends to dq: the len check and the bump are
        # single-writer, so the overflow count is exact
        ring.dropped += 1
    dq.append((next(_seq), time.time(), etype, request_id, fields or None))


def _new_ring() -> _Ring:
    ring = _Ring(_capacity)
    _rings[id(ring)] = ring  # atomic dict store — no lock (see module doc)
    _tls.ring = ring
    _ensure_collector()
    return ring


_current_request_id = None  # lazily bound tracing.current_request_id


def active_request_id() -> Optional[str]:
    """The tracing request id bound to this thread, or ``None``. The cheap
    gate for per-read emits: ``core.object.map``/``unmap`` ride every
    zero-copy get, so they fire only inside a traced request (mint-time
    sampling alignment — the same deal spans get). An untraced bulk loop
    pays one thread-local read here instead of a ring append per read."""
    global _current_request_id
    rid_fn = _current_request_id
    if rid_fn is None:
        from ray_tpu_torch.util.tracing import current_request_id as rid_fn

        _current_request_id = rid_fn
    return rid_fn()


def emit(
    etype: str,
    obj_id: Optional[bytes] = None,
    size: Optional[int] = None,
    node: Optional[bytes] = None,
    request_id: Optional[str] = None,
    **fields: Any,
) -> None:
    """Object-plane emit: :func:`record` plus the ``core.object.*`` field
    conventions. ``obj_id``/``node`` accept the binary ids the
    runtime carries and land hex-encoded as ``oid``/``node`` (an explicit
    ``node`` field overrides this process's node in ``snapshot()`` — owner
    provenance, not emitter provenance). When no ``request_id`` is passed
    the active one is read from the tracing thread-local, so a request's
    data-plane hops line up under ``obs req <id>`` next to its waterfall.

    Hot path: same zero-lock budget as ``record``, and cheaper — the
    raw (obj_id, size, node, extras) tuple goes into the ring as-is and
    the hex encodes + field-dict build are deferred to :func:`snapshot`,
    so the emitting thread pays only the append (the rule: cost is
    paid when a consumer drains, not on the path)."""
    if not _enabled:
        return
    if request_id is None:
        global _current_request_id
        rid_fn = _current_request_id
        if rid_fn is None:
            from ray_tpu_torch.util.tracing import current_request_id as rid_fn

            _current_request_id = rid_fn
        request_id = rid_fn()
    # record()'s ring append, inlined (delegating would repack **fields a
    # second time); item[4] is a TUPLE here, not a dict — snapshot()
    # expands it. Nothing else looks inside item[4]: the collector folds
    # and configure() re-deques ring items opaquely.
    ring = getattr(_tls, "ring", None)
    if ring is None:
        ring = _new_ring()
    dq = ring.dq
    if len(dq) == dq.maxlen:
        ring.dropped += 1
    dq.append(
        (next(_seq), time.time(), etype, request_id,
         (obj_id, size, node, fields or None))
    )


def _iter_raw() -> list[tuple]:
    """All events currently held (retired + live rings), merged into
    global emission order by seq. Lock-free: list() over a deque and
    dict.values() are atomic snapshots under the GIL. De-duplicated by
    seq: a snapshot racing the collector's fold can see a just-folded
    ring's events in BOTH the new retired deque and the not-yet-popped
    ring (the fold publishes before unregistering so nothing is ever
    lost — the cheap side of that trade is dropping dups here)."""
    items = list(_retired)
    for ring in list(_rings.values()):
        items.extend(ring.dq)
    items.sort(key=lambda t: t[0])
    out = []
    last_seq = -1
    for item in items:
        if item[0] != last_seq:
            out.append(item)
            last_seq = item[0]
    return out


def snapshot(request_id: Optional[str] = None) -> list[dict]:
    """Events currently held (oldest first, exact emission order), as
    dicts. Optionally filtered to one request.

    Deliberately LOCK-FREE — the SIGTERM crash handler calls this from a
    signal frame that may have interrupted ``record()`` mid-append ON
    THIS THREAD, where taking any non-reentrant lock would deadlock a
    dying worker instead of flushing it."""
    pid = os.getpid()
    out = []
    node = _node
    for seq, ts, etype, rid, fields in _iter_raw():
        if request_id is not None and rid != request_id:
            continue
        ev = {"seq": seq, "ts": ts, "type": etype, "pid": pid}
        if node is not None:
            ev["node"] = node
        if rid is not None:
            ev["request_id"] = rid
        if type(fields) is tuple:
            # deferred emit() payload: (obj_id, size, node, extras) raw
            # off the hot path — format here, on the consumer's dime
            obj_id, size, onode, extras = fields
            if obj_id is not None:
                ev["oid"] = obj_id.hex() if isinstance(obj_id, bytes) else obj_id
            if size is not None:
                ev["size"] = size
            if onode is not None:
                # owner provenance overrides emitter provenance
                ev["node"] = onode.hex() if isinstance(onode, bytes) else onode
            if extras:
                ev.update(extras)
        elif fields:
            ev.update(fields)
        out.append(ev)
    return out


def stats() -> dict:
    # lock-free for the same signal-safety reason as snapshot(): every
    # read here is an atomic snapshot
    rings = list(_rings.values())
    return {
        "enabled": _enabled,
        "capacity": _capacity,
        "size": len(_retired) + sum(len(r.dq) for r in rings),
        "dropped": _retired_dropped + sum(r.dropped for r in rings),
        "rings": len(rings),
    }


def ring_stats() -> list[dict]:
    """Per-ring view (``obs overhead`` / tests): one row per live ring
    plus the retired fold."""
    rows = [
        {
            "thread": r.thread.name,
            "alive": r.thread.is_alive(),
            "size": len(r.dq),
            "dropped": r.dropped,
        }
        for r in list(_rings.values())
    ]
    rows.append(
        {
            "thread": "<retired>",
            "alive": False,
            "size": len(_retired),
            "dropped": _retired_dropped,
        }
    )
    return rows


def clear() -> None:
    """Reset contents + counters (tests/tools). Also rewinds the metric
    publication watermark: after a clear, total drops restart at 0, and
    without the rewind the collector would withhold the events_dropped
    counter until drops re-exceeded the pre-clear total."""
    global _retired_dropped, _drop_published
    for ring in list(_rings.values()):
        ring.dq.clear()
        ring.dropped = 0
    _retired.clear()
    _retired_dropped = 0
    _drop_published = 0


# ---------------------------------------------------------------------------
# background collector
# ---------------------------------------------------------------------------


def _ensure_collector() -> None:
    # lock-free single-start: record() reaches here on a thread's FIRST
    # emit, and the no-shared-lock hot-path contract (tests/test_raylint
    # hot-path check) forbids a lock even on this slow path — the count
    # gate hands exactly one caller the start
    global _collector_started
    if _collector_started or next(_collector_gate) != 0:
        return
    _collector_started = True
    try:
        threading.Thread(
            target=_collector_loop, name="events-collector", daemon=True
        ).start()
    except RuntimeError:
        pass  # interpreter tearing down: stats()/snapshot() still work


def _collect_once() -> None:
    """One collector pass: fold dead-thread rings into the retired deque
    (preserving seq order) and forward the aggregate drop count into the
    lazy ``events_dropped`` metric. Runs ONLY on the collector thread —
    its writes to ``_retired``/``_retired_dropped`` are single-writer."""
    global _retired, _retired_dropped, _drop_metric, _drop_published
    dead = [
        (rid_, ring)
        for rid_, ring in list(_rings.items())
        if not ring.thread.is_alive()
    ]
    if dead:
        # PUBLISH BEFORE UNREGISTERING: build the merged retired deque
        # (old retired + every dead ring, seq-interleaved) and install it
        # as ONE atomic global swap while the dead rings are still in
        # _rings. A crash-flush snapshot racing this pass therefore sees
        # every event at least once — possibly twice for a moment (new
        # retired + not-yet-popped ring), which _iter_raw de-dups by seq
        # — and never a half-built state that loses a dead thread's ring.
        items = list(_retired)
        for _rid, ring in dead:
            items.extend(ring.dq)
        items.sort(key=lambda t: t[0])
        keep = items[-_capacity:]
        # collector-owned counter (single writer); clear() is a tests/tools
        # reset documented to race only advisory state — the next pass
        # re-derives totals from the rings
        _retired_dropped += len(items) - len(keep) + sum(  # raylint: disable=RL017
            ring.dropped for _rid, ring in dead
        )
        _retired = deque(keep, maxlen=_capacity)
        for rid_, _ring in dead:
            _rings.pop(rid_, None)
    total_dropped = _retired_dropped + sum(
        r.dropped for r in list(_rings.values())
    )
    if total_dropped > _drop_published:
        delta = total_dropped - _drop_published
        _drop_published = total_dropped
        if _drop_metric is None:
            from ray_tpu_torch.util.metrics import safe_counter

            # False (not None) when unavailable: stats() still counts
            _drop_metric = safe_counter(
                "events_dropped",
                "flight-recorder events evicted by ring overflow",
            ) or False
        if _drop_metric:
            try:
                _drop_metric.inc(delta)
            except Exception:
                pass


def _collector_loop() -> None:
    while True:
        time.sleep(_COLLECT_INTERVAL_S)
        try:
            _collect_once()
        except Exception:  # raylint: disable=RL007
            # the collector must never take the process down, and the
            # only shared state it touches is advisory
            pass


def collector_pass_for_tests() -> None:
    """Run one synchronous collector pass (deterministic tests)."""
    _collect_once()


# ---------------------------------------------------------------------------
# crash flush
# ---------------------------------------------------------------------------


def events_dir() -> str:
    return os.environ.get(
        "RAY_TPU_EVENTS_DIR",
        os.path.join(tempfile.gettempdir(), "ray_tpu_events"),
    )


def load_crash_files(directory: Optional[str] = None) -> list[dict]:
    """Read back every crash-flush JSONL in ``directory`` (default: the
    events dir) — the postmortem half of the recorder: a killed worker
    can't answer the live drain, but its flushed rings are on disk.
    Events gain ``crash_flush`` (their source file) and the header's
    ``node`` when the event itself carries none."""
    d = directory or events_dir()
    out: list[dict] = []
    if not os.path.isdir(d):
        return out
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".jsonl"):
            continue
        node = None
        try:
            with open(os.path.join(d, fname)) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("_flight_recorder"):
                        node = rec.get("node")
                        continue  # header line
                    rec.setdefault("crash_flush", fname)
                    if node is not None:
                        rec.setdefault("node", node)
                    out.append(rec)
        except (OSError, ValueError):
            continue
    return out


def flush(path: Optional[str] = None, reason: str = "manual") -> Optional[str]:
    """Dump all rings as JSONL (one event per line in global seq order,
    preceded by a header line with process metadata). Returns the path,
    or None when nothing was recorded. Never raises — a flush failing
    must not mask the crash that triggered it."""
    try:
        events = snapshot()
        if not events:
            return None
        if path is None:
            d = events_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"events-{os.getpid()}.jsonl")
        with open(path, "w") as f:
            header = {
                "_flight_recorder": 1,
                "pid": os.getpid(),
                "node": _node,
                "reason": reason,
                "time": time.time(),
                **stats(),
            }
            f.write(json.dumps(header) + "\n")
            for ev in events:
                f.write(json.dumps(ev, default=repr) + "\n")
        return path
    except Exception:
        return None


def install_crash_handlers() -> None:
    """Arm flush-on-death (idempotent): unhandled exceptions in any thread
    and SIGTERM (how workers are killed). The previous hooks/handlers are
    chained, and SIGTERM re-raises the default action after flushing so
    the process still dies."""
    global _installed
    if _installed:
        return
    _installed = True

    prev_except = sys.excepthook

    def _excepthook(tp, val, tb):
        record("crash.exception", error=f"{tp.__name__}: {val}")
        flush(reason="excepthook")
        prev_except(tp, val, tb)

    sys.excepthook = _excepthook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        # daemon-thread crashes (engine loops, flushers) matter most here
        record(
            "crash.thread_exception",
            thread=getattr(args.thread, "name", None),
            error=f"{getattr(args.exc_type, '__name__', args.exc_type)}: {args.exc_value}",
        )
        flush(reason="threading.excepthook")
        prev_thread(args)

    threading.excepthook = _thread_hook

    if threading.current_thread() is threading.main_thread():
        import signal

        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            record("crash.sigterm")
            flush(reason="sigterm")
            if prev_term is signal.SIG_IGN:
                return  # the process chose to ignore SIGTERM: honor that
            if callable(prev_term) and prev_term is not signal.SIG_DFL:
                prev_term(signum, frame)
            else:
                # restore the default action and re-deliver so the process
                # dies with the conventional SIGTERM status
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            pass  # non-main interpreter / restricted env: hooks still armed


# ---------------------------------------------------------------------------
# cluster drain (head broadcast — same mailbox as worker stack dumps)
# ---------------------------------------------------------------------------


def collect_cluster_events(
    request_id: Optional[str] = None, timeout: float = 5.0
) -> list[dict]:
    """This process's rings + every live worker's, via the head broadcast
    (``rpc_collect_events``). Events gain a ``node``/``pid`` origin; order
    is (ts, seq) across processes. Best-effort: an unreachable cluster
    returns local events only."""
    out = list(snapshot(request_id))
    try:
        from ray_tpu_torch._private.runtime import get_ctx

        ctx = get_ctx()
        remote = ctx.call("collect_events", timeout=timeout)
    except Exception:
        remote = None
    if remote:
        # the caller's own rings come back through the drain too (as a
        # worker reply, or as the head's "head" entry for an in-process
        # driver) — de-dup by event identity, not by pid: a bare pid
        # check would silently drop a REMOTE node's worker that happens
        # to share the caller's pid
        seen = {(e["pid"], e["seq"], e["ts"]) for e in out}
        for node, per_pid in remote.items():
            for pid, evs in per_pid.items():
                if pid == "_errors" or not isinstance(evs, list):
                    continue
                for ev in evs:
                    if request_id is not None and ev.get("request_id") != request_id:
                        continue
                    key = (ev.get("pid"), ev.get("seq"), ev.get("ts"))
                    if key in seen:
                        continue
                    seen.add(key)
                    ev.setdefault("node", node)
                    out.append(ev)
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return out
