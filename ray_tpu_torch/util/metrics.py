"""User-defined metrics: Counter / Gauge / Histogram (copy of
``ray_tpu/util/metrics.py``).

Reference: ``python/ray/util/metrics.py`` (the user-facing wrappers over the
C++ OpenCensus stats pipeline, ``src/ray/stats/metric_defs.cc``). TPU-first
shape: no per-node metrics agent daemon — each process records locally and a
daemon flusher publishes aggregated snapshots into the head's KV store under
``__metrics__/<process-tag>``; ``collect()`` merges all snapshots, giving
every driver/worker a cluster-wide view through the control plane that
already exists. ``prometheus_text()`` renders the standard exposition format
for scraping.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Optional, Sequence

_FLUSH_INTERVAL_S = 2.0
_KV_PREFIX = "__metrics__/"

_registry_lock = threading.Lock()
_registry: list["Metric"] = []
_flusher_started = False


def _series_enabled() -> bool:
    return os.environ.get("RAY_TPU_METRICS_SERIES", "1").lower() not in (
        "0", "false", "off",
    )


def _series_capacity() -> int:
    try:
        return max(8, int(os.environ.get("RAY_TPU_METRICS_SERIES_CAPACITY", "512")))
    except ValueError:
        return 512


def _series_interval() -> float:
    try:
        return max(
            0.05, float(os.environ.get("RAY_TPU_METRICS_SERIES_INTERVAL_S", "1.0"))
        )
    except ValueError:
        return 1.0


def _tag_key(tags: Optional[dict]) -> str:
    if not tags:
        return ""
    return json.dumps(dict(sorted(tags.items())), separators=(",", ":"))


class Metric:
    """Base: named, tagged, locally aggregated.

    Hot-path architecture (OBSERVABILITY.md): increments
    land in **per-thread cells** — each emitting thread owns a private
    dict it alone mutates, registered once by an atomic ``list.append``.
    The emit path (``Counter.inc`` / ``Gauge.set`` /
    ``Histogram.observe``) therefore acquires NO shared lock, ever; the
    cells are merged only at snapshot time (the flusher's 1 Hz sample or
    an explicit ``collect()``), where all the aggregation cost lives.
    ``self._lock`` guards nothing on the emit path — it serializes
    snapshot-side compaction only."""

    kind = "metric"

    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        if not name or any(c in name for c in " /"):
            raise ValueError(f"Invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}
        self._lock = threading.Lock()
        self._data: dict[str, float | list] = defaultdict(float)
        self._tls = threading.local()
        # (owner thread, cell) per emitting thread. Appended lock-free at
        # first emit; dead threads' cells are folded into _data and
        # removed at snapshot time (under _lock) so thread churn — e.g.
        # serve's per-stream proxy threads — cannot grow this unboundedly
        self._cells: list[tuple] = []
        with _registry_lock:
            _registry.append(self)
        _ensure_flusher()

    def set_default_tags(self, tags: dict) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[dict]) -> str:
        if not tags and not self._default_tags:
            return ""  # untagged fast path: no dict build, no set math
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"Unknown tag(s) {sorted(extra)} for metric {self.name!r}")
        return _tag_key(merged)

    def _cell(self) -> dict:
        """This thread's private cell. First touch registers it via a
        plain list.append — atomic under the GIL, no lock (the raylint
        hot-path fixture asserts the emit path stays lock-free)."""
        try:
            return self._tls.cell
        except AttributeError:
            cell: dict = {}
            self._cells.append((threading.current_thread(), cell))
            self._tls.cell = cell
            return cell

    @staticmethod
    def _fold_into(out: dict, cell: dict) -> None:
        for k, v in cell.copy().items():
            if isinstance(v, list):  # histogram vector: elementwise sum
                prev = out.get(k)
                out[k] = (
                    [a + b for a, b in zip(prev, v)]
                    if isinstance(prev, list)
                    else list(v)
                )
            else:  # counter cell: sum
                out[k] = out.get(k, 0.0) + v

    def _merged_data(self) -> dict:
        """Base data + every thread cell, merged by kind (caller holds
        ``self._lock``). Cells are single-writer dicts; ``dict.copy`` is
        an atomic C call, so the merge sees a consistent point-in-time
        view of each cell. Cells whose owner thread has exited are folded
        PERMANENTLY into ``_data`` and dropped from the list — the owner
        can never write again, so the fold is exact, and per-stream /
        per-request threads can't leak cells for the process lifetime.
        (The lock serializes concurrent snapshots: without it two folds
        of the same dead cell would double-count.)"""
        for entry in list(self._cells):
            thread, cell = entry
            if not thread.is_alive():
                self._fold_into(self._data, cell)
                try:
                    self._cells.remove(entry)
                except ValueError:
                    pass
        out = dict(self._data)
        for _thread, cell in list(self._cells):
            self._fold_into(out, cell)
        return out

    def _snapshot(self) -> dict:
        with self._lock:
            snap = {
                "name": self.name,
                "kind": self.kind,
                "description": self.description,
                "data": self._merged_data(),
            }
            bounds = getattr(self, "boundaries", None)
            if bounds is not None:
                snap["boundaries"] = list(bounds)
            return snap


class Counter(Metric):
    """Monotonically increasing count (reference: util/metrics.py Counter).

    ``inc`` is lock-free: the increment lands in the calling thread's
    private cell (single-writer dict read-modify-write — exact), merged
    into the published total only at snapshot/flush time."""

    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        if value < 0:
            raise ValueError("Counter.inc() requires a non-negative value")
        key = self._tags(tags)
        try:
            cell = self._tls.cell
        except AttributeError:
            cell = self._cell()
        cell[key] = cell.get(key, 0.0) + value


class Gauge(Metric):
    """Last-value-wins measurement. ``set`` is a single atomic dict store
    into the shared data — last write wins by definition, so thread cells
    would only blur which write was last; no lock needed either way."""

    kind = "gauge"

    def set(self, value: float, tags: Optional[dict] = None):
        key = self._tags(tags)
        self._data[key] = float(value)


DEFAULT_BOUNDARIES = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)


class Histogram(Metric):
    """Bucketed distribution; records per-bucket counts + sum + count.

    ``observe`` is lock-free like ``Counter.inc``: the bucket vector
    lives in the calling thread's cell (single-writer, exact); snapshot
    merges vectors elementwise. A reader copying a cell mid-observe can
    see a vector whose bucket is bumped but whose count isn't yet — a
    one-sample transient the next snapshot corrects (same tolerance
    Prometheus scrapes have always had)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = DEFAULT_BOUNDARIES,
        tag_keys: Sequence[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(sorted(boundaries))

    def observe(self, value: float, tags: Optional[dict] = None):
        key = self._tags(tags)
        try:
            cell = self._tls.cell
        except AttributeError:
            cell = self._cell()
        cur = cell.get(key)
        if not isinstance(cur, list):
            cur = [0] * (len(self.boundaries) + 1) + [0.0, 0]  # buckets+sum+count
            cell[key] = cur
        idx = len(self.boundaries)
        for i, b in enumerate(self.boundaries):
            if value <= b:
                idx = i
                break
        cur[idx] += 1
        cur[-2] += value
        cur[-1] += 1

    record = observe  # reference alias

    def percentiles(
        self, qs: Sequence[float] = (0.5, 0.95, 0.99), tags: Optional[dict] = None
    ) -> dict:
        """This PROCESS's distribution snapshot: ``{"p50": ..., "p95": ...,
        "count": n, "sum": s}`` (bucket interpolation —
        :func:`percentiles_from_buckets`). Cluster-wide: ``histogram_percentiles``."""
        key = self._tags(tags)
        with self._lock:
            cur = self._merged_data().get(key)
            data = list(cur) if isinstance(cur, list) else None
        return _percentile_summary(self.boundaries, data, qs)


def safe_counter(name: str, description: str = "") -> Optional["Counter"]:
    """A ``Counter``, or None when the registry is unavailable (late
    interpreter teardown, import cycles). The shared shape for LAZY drop
    counters created off the hot path on first drop — tracing's
    ``tracing_dropped_spans`` and the flight recorder's
    ``events_dropped`` both construct through here."""
    try:
        return Counter(name, description)
    except Exception:
        return None


def percentiles_from_buckets(
    boundaries: Sequence[float], counts: Sequence[float], q: float
) -> float:
    """Quantile estimate from histogram buckets, Prometheus
    ``histogram_quantile`` style: linear interpolation inside the target
    bucket; the overflow (+Inf) bucket clamps to the highest boundary (no
    upper bound to interpolate toward). ``counts`` is the per-bucket
    (non-cumulative) layout ``observe()`` maintains — one slot per
    boundary plus overflow."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(boundaries):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            frac = (rank - prev) / max(counts[i], 1e-12)
            return lo + (b - lo) * min(max(frac, 0.0), 1.0)
        lo = b
    return float(boundaries[-1]) if boundaries else float("nan")


def _percentile_summary(
    boundaries: Sequence[float], data: Optional[list], qs: Sequence[float]
) -> dict:
    if not data:
        out = {f"p{round(q * 100) if q < 1 else 100}": float("nan") for q in qs}
        out.update(count=0, sum=0.0)
        return out
    buckets, total, s = data[:-2], data[-1], data[-2]
    out = {
        f"p{round(q * 100) if q < 1 else 100}": percentiles_from_buckets(
            boundaries, buckets, q
        )
        for q in qs
    }
    out.update(count=int(total), sum=float(s))
    return out


def histogram_percentiles(
    name: Optional[str] = None, qs: Sequence[float] = (0.5, 0.95, 0.99)
) -> dict:
    """CLUSTER-wide percentile snapshots from ``collect()``'s merged
    buckets: ``{metric_name: {tagset: {"p50": ..., "count": ...}}}``
    (optionally one metric). What ``obs top`` renders for TTFT/ITL."""
    data = collect()
    out: dict[str, dict] = {}
    for mname, series in data.get("metrics", {}).items():
        if data.get("kinds", {}).get(mname) != "histogram":
            continue
        if name is not None and mname != name:
            continue
        bounds = tuple(data.get("boundaries", {}).get(mname, ()))
        out[mname] = {
            tagset: _percentile_summary(bounds, val, qs)
            for tagset, val in series.items()
            if isinstance(val, list)
        }
    return out


# ---------------------------------------------------------------------------
# time series: a bounded in-process ring per (metric, tagset)
#
# Every process samples its OWN registry on a fixed cadence into fixed-size
# rings, and flush() ships only the not-yet-shipped samples to the head
# (``series_push`` — the same mailbox rendezvous the snapshot KV uses), where
# a bounded per-process store holds recent history.  ``collect_series()``
# merges the per-process series into one cluster view; rates/percentiles are
# derived at query time (``series_rate`` / ``series_window_delta`` /
# ``series_percentiles_over_window``) with Prometheus-style counter-reset
# handling, so ``obs top`` can show a real tokens/s and the SLO engine can
# evaluate burn rates over real windows without any external TSDB.
# ---------------------------------------------------------------------------

_series_lock = threading.Lock()
# name -> {"kind": str, "boundaries": list|None, "points": {tagset: deque}}
# deque entries: (sample_seq, ts, value) — value is a float for
# counters/gauges, the buckets+sum+count list for histograms
_series: dict[str, dict] = {}
_sample_seq = 0
_shipped_seq = 0


def _merged_local_snaps(snaps: list[dict]) -> dict[str, dict]:
    """Fold one process's registry snapshots into one entry per metric NAME
    (two same-name Metric objects in one process — e.g. re-created across
    test runs — must produce ONE sample per tick, merged with collect()'s
    semantics, not two appends that would corrupt the ring)."""
    out: dict[str, dict] = {}
    for snap in snaps:
        name, kind = snap["name"], snap["kind"]
        ent = out.setdefault(
            name,
            {"kind": kind, "boundaries": snap.get("boundaries"), "data": {}},
        )
        for tagset, val in snap["data"].items():
            if kind == "gauge":
                ent["data"][tagset] = val
            elif kind == "counter":
                ent["data"][tagset] = ent["data"].get(tagset, 0.0) + val
            else:
                prev = ent["data"].get(tagset)
                ent["data"][tagset] = (
                    [a + b for a, b in zip(prev, val)] if prev else list(val)
                )
    return out


def sample_series_now(now: Optional[float] = None) -> int:
    """Append one sample per (metric, tagset) to this process's rings.
    Called by the flusher thread on its cadence; tests and ``obs top
    --once`` call it directly for a deterministic sample."""
    global _sample_seq
    if not _series_enabled():
        return 0
    now = time.time() if now is None else now
    with _registry_lock:
        snaps = [m._snapshot() for m in _registry]
    merged = _merged_local_snaps(snaps)
    cap = _series_capacity()
    with _series_lock:
        _sample_seq += 1
        seq = _sample_seq
        for name, snap in merged.items():
            ent = _series.setdefault(
                name, {"kind": snap["kind"], "boundaries": None, "points": {}}
            )
            ent["kind"] = snap["kind"]
            if snap.get("boundaries") is not None:
                ent["boundaries"] = list(snap["boundaries"])
            for tagset, val in snap["data"].items():
                dq = ent["points"].get(tagset)
                if dq is None or dq.maxlen != cap:
                    dq = deque(dq or (), maxlen=cap)
                    ent["points"][tagset] = dq
                dq.append(
                    (seq, now, list(val) if isinstance(val, list) else float(val))
                )
    return seq


def get_local_series(name: Optional[str] = None) -> dict:
    """This PROCESS's rings as plain lists (oldest first)."""
    with _series_lock:
        out = {}
        for n, ent in _series.items():
            if name is not None and n != name:
                continue
            out[n] = {
                "kind": ent["kind"],
                "boundaries": ent["boundaries"],
                "points": {
                    tagset: [[ts, v] for (_seq, ts, v) in dq]
                    for tagset, dq in ent["points"].items()
                },
            }
        return out


def configure_series(capacity: Optional[int] = None) -> None:
    """Resize the per-process rings (tests/tuning; drops nothing unless
    shrinking)."""
    if capacity is not None:
        os.environ["RAY_TPU_METRICS_SERIES_CAPACITY"] = str(int(capacity))
        with _series_lock:
            for ent in _series.values():
                for tagset, dq in list(ent["points"].items()):
                    ent["points"][tagset] = deque(dq, maxlen=max(8, int(capacity)))


def _reset_series_for_tests() -> None:
    global _sample_seq, _shipped_seq
    with _series_lock:
        _series.clear()
        _sample_seq = 0
        _shipped_seq = 0


_ship_lock = threading.Lock()
# off-caller-path shipping rendezvous: callers that need fresh data at the
# head (collect_series) RAISE this condition instead of shipping inline;
# the flusher thread performs the I/O. Two sequence numbers make the
# handoff race-free: a waiter is satisfied only by a ship that STARTED
# after its request (the flusher claims _ship_req_seq BEFORE shipping and
# publishes it to _ship_done_seq after) — a request landing mid-ship is
# NOT consumed by that in-flight ship; the next loop pass ships again.
_ship_cv = threading.Condition()
_ship_req_seq = 0   # bumped by request_ship()
_ship_done_seq = 0  # last req seq fully shipped (flusher-owned)


def request_ship(wait: bool = False, timeout: float = 2.0) -> None:
    """Ask the flusher thread to run a ship pass NOW (and optionally wait
    for it to finish). This is the ONLY way query paths interact with
    series shipping — the telemetry I/O itself always runs on the
    dedicated flusher thread, never on the caller (the contract: no
    application thread blocks on telemetry I/O it didn't ask for).
    Falls back to an inline ship only when no flusher exists (a process
    that never created a metric has nothing to ship anyway)."""
    global _ship_req_seq
    if not _series_enabled():
        return
    if not _flusher_started:
        _ship_series()  # no flusher thread to hand off to
        return
    with _ship_cv:
        _ship_req_seq += 1
        mine = _ship_req_seq
        _ship_cv.notify_all()
        if wait:
            _ship_cv.wait_for(lambda: _ship_done_seq >= mine, timeout=timeout)


def _ship_series() -> None:
    """Push samples recorded since the last successful ship to the head's
    SeriesStore. Best-effort, like the KV snapshot flush. Runs on the
    flusher thread (``request_ship``) — plus inline at interpreter exit,
    the one moment there may be no flusher left to hand off to.

    Delivery is IDEMPOTENT: rows carry their sample seq and the head drops
    anything at/below its per-process watermark, so a push whose reply was
    lost (head applied it, caller retries the backlog) cannot duplicate
    rows; ``_ship_lock`` additionally serializes concurrent shippers (the
    flusher thread racing an exit-time flush would otherwise have the
    same backlog in flight twice)."""
    global _shipped_seq
    if not _series_enabled():
        return
    if not _ship_lock.acquire(blocking=False):
        return  # another thread is shipping this same backlog right now
    try:
        with _series_lock:
            if _sample_seq == _shipped_seq:
                return
            floor = _shipped_seq
            top = _sample_seq
            payload: dict[str, dict] = {}
            for name, ent in _series.items():
                rows = {}
                for tagset, dq in ent["points"].items():
                    new = [[seq, ts, v] for (seq, ts, v) in dq if seq > floor]
                    if new:
                        rows[tagset] = new
                if rows:
                    payload[name] = {"kind": ent["kind"], "points": rows}
                    if ent["boundaries"] is not None:
                        payload[name]["boundaries"] = ent["boundaries"]
        if not payload:
            with _series_lock:
                _shipped_seq = max(_shipped_seq, top)
            return
        from ray_tpu_torch._private.runtime import get_ctx

        try:
            ctx = get_ctx()
            ctx.call(
                "series_push",
                proc=_process_tag(),
                interval=_series_interval(),
                series=payload,
            )
        except Exception:
            return  # head gone / not initialized — retry backlog next flush
        with _series_lock:
            _shipped_seq = max(_shipped_seq, top)
    finally:
        _ship_lock.release()


class SeriesStore:
    """Head-side bounded store of per-process metric series.

    ``push`` appends one process's incremental samples; each (proc, metric,
    tagset) keeps at most ``capacity`` samples, so memory is bounded no
    matter the uptime. ``raw()`` is the drain format ``collect_series``
    merges client-side; the head's alert evaluator merges in-process."""

    _MAX_PROCS = 256

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._capacity = capacity or _series_capacity()
        # proc -> {"interval": float, "t": last-push, "metrics": {name: ent}}
        self._procs: dict[str, dict] = {}

    def push(self, proc: str, interval: float, series: dict) -> None:
        with self._lock:
            rec = self._procs.get(proc)
            if rec is None:
                if len(self._procs) >= self._MAX_PROCS:
                    oldest = min(self._procs, key=lambda p: self._procs[p]["t"])
                    del self._procs[oldest]
                rec = self._procs[proc] = {
                    "interval": interval, "metrics": {}, "seq": -1,
                }
            rec["interval"] = float(interval)
            rec["t"] = time.time()
            watermark = rec.get("seq", -1)
            top = watermark
            for name, ent in series.items():
                dest = rec["metrics"].setdefault(
                    name,
                    {"kind": ent["kind"], "boundaries": ent.get("boundaries"),
                     "points": {}},
                )
                dest["kind"] = ent["kind"]
                if ent.get("boundaries") is not None:
                    dest["boundaries"] = ent["boundaries"]
                for tagset, rows in ent["points"].items():
                    dq = dest["points"].get(tagset)
                    if dq is None:
                        dq = dest["points"][tagset] = deque(maxlen=self._capacity)
                    for row in rows:
                        if len(row) == 3:  # [seq, ts, v]: idempotent delivery
                            seq, ts, v = row
                            if seq <= watermark:
                                continue  # re-delivered after a lost reply
                            top = max(top, seq)
                        else:  # bare [ts, v] (tests / external feeders)
                            ts, v = row
                        dq.append((float(ts), v))
            rec["seq"] = top

    def raw(self, name: Optional[str] = None) -> dict:
        with self._lock:
            out: dict[str, dict] = {}
            for proc, rec in self._procs.items():
                metrics = {}
                for n, ent in rec["metrics"].items():
                    if name is not None and n != name:
                        continue
                    metrics[n] = {
                        "kind": ent["kind"],
                        "boundaries": ent["boundaries"],
                        "points": {
                            tagset: [[ts, v] for ts, v in dq]
                            for tagset, dq in ent["points"].items()
                        },
                    }
                if metrics:
                    out[proc] = {"interval": rec["interval"], "metrics": metrics}
            return out

    def merged(self, name: Optional[str] = None) -> dict:
        return merge_proc_series(self.raw(name))


def merge_proc_series(raw: dict) -> dict:
    """Merge per-process series into one cluster view, binned on the
    coarsest contributing sample interval: counters and histograms are
    forward-filled per process then summed (a process that missed a bin
    contributes its last known cumulative value, and a dead process's
    contribution freezes instead of vanishing — the merged counter stays
    monotonic through stragglers); gauges are last-write-wins by sample
    time, mirroring ``collect()``. Returns ``{name: {"kind", "boundaries",
    "series": {tagset: [(ts, value), ...]}}}``."""
    # (name, tagset) -> list of (per-proc sorted samples); plus metadata
    grouped: dict[str, dict] = {}
    for proc, rec in raw.items():
        interval = max(float(rec.get("interval", 1.0)), 0.05)
        for name, ent in rec.get("metrics", {}).items():
            g = grouped.setdefault(
                name,
                {"kind": ent["kind"], "boundaries": ent.get("boundaries"),
                 "interval": interval, "tagsets": {}},
            )
            g["interval"] = max(g["interval"], interval)
            if ent.get("boundaries") is not None:
                g["boundaries"] = ent["boundaries"]
            for tagset, rows in ent["points"].items():
                g["tagsets"].setdefault(tagset, []).append(
                    sorted((float(ts), v) for ts, v in rows)
                )
    out: dict[str, dict] = {}
    for name, g in grouped.items():
        series = {}
        for tagset, proc_samples in g["tagsets"].items():
            series[tagset] = _merge_one(proc_samples, g["kind"], g["interval"])
        out[name] = {
            "kind": g["kind"], "boundaries": g["boundaries"], "series": series,
        }
    return out


def _merge_one(proc_samples: list[list], kind: str, width: float) -> list[tuple]:
    if len(proc_samples) == 1:
        return list(proc_samples[0])
    bins = sorted({int(ts // width) for samples in proc_samples for ts, _v in samples})
    merged: list[tuple] = []
    cursors = [0] * len(proc_samples)
    last_val: list = [None] * len(proc_samples)
    for b in bins:
        end = (b + 1) * width
        bin_ts = None
        gauge_pick = None  # (ts, value) with max ts in bin
        for i, samples in enumerate(proc_samples):
            c = cursors[i]
            while c < len(samples) and samples[c][0] < end:
                ts, v = samples[c]
                last_val[i] = v
                if ts >= b * width:
                    bin_ts = ts if bin_ts is None else max(bin_ts, ts)
                    if gauge_pick is None or ts >= gauge_pick[0]:
                        gauge_pick = (ts, v)
                c += 1
            cursors[i] = c
        if bin_ts is None:
            continue  # no process sampled inside this bin
        if kind == "gauge":
            merged.append((bin_ts, gauge_pick[1]))
        elif kind == "histogram":
            total = None
            for v in last_val:
                if v is None:
                    continue
                total = list(v) if total is None else [a + b2 for a, b2 in zip(total, v)]
            merged.append((bin_ts, total))
        else:  # counter: sum of forward-filled cumulative values
            merged.append((bin_ts, sum(v for v in last_val if v is not None)))
    return merged


# ---- query helpers over merged (ts, value) sample lists -------------------


def series_rate(points: list) -> list[tuple]:
    """Per-interval rate from consecutive cumulative samples, with counter
    resets handled Prometheus-style (a decrease means the counter restarted
    from zero, so the post-reset value IS the increase)."""
    out = []
    prev = None
    for ts, v in points:
        if prev is not None:
            pts, pv = prev
            dt = ts - pts
            if dt > 0:
                delta = v - pv
                if delta < 0:
                    delta = v
                out.append((ts, delta / dt))
        prev = (ts, v)
    return out


def latest_rate(points: list):
    """Rate of the newest sample pair, or None with fewer than 2 samples —
    the ``obs top`` contract (render ``—``, never a lifetime-average)."""
    rates = series_rate(points[-2:] if len(points) >= 2 else points)
    return rates[-1][1] if rates else None


def series_window_delta(points: list, window_s: float, now: Optional[float] = None):
    """Reset-aware increase of a cumulative counter over the trailing
    window (the sample just before the window start is the baseline).
    Returns None when the window holds no step."""
    now = time.time() if now is None else now
    start = now - window_s
    total = None
    prev = None
    for ts, v in points:
        if prev is not None and ts > start:
            delta = v - prev
            if delta < 0:
                delta = v
            total = delta if total is None else total + delta
        prev = v
    return total


def hist_window_delta(points: list, window_s: float, now: Optional[float] = None):
    """Elementwise increase of a histogram's buckets+sum+count vector over
    the trailing window (reset-aware: a shrinking count restarts the
    baseline). None when no in-window step exists."""
    now = time.time() if now is None else now
    start = now - window_s
    total = None
    prev = None
    for ts, v in points:
        if prev is not None and ts > start:
            if v[-1] < prev[-1]:  # counter reset: the new vector IS the delta
                delta = list(v)
            else:
                delta = [a - b for a, b in zip(v, prev)]
            total = delta if total is None else [a + b for a, b in zip(total, delta)]
        prev = v
    return total


def series_percentiles_over_window(
    points: list,
    boundaries: Sequence[float],
    window_s: float,
    qs: Sequence[float] = (0.5, 0.95, 0.99),
    now: Optional[float] = None,
) -> dict:
    """Percentile summary of a histogram series restricted to the trailing
    window — what ``obs series`` and the TTFT SLO rule evaluate."""
    delta = hist_window_delta(points, window_s, now)
    return _percentile_summary(tuple(boundaries or ()), delta, qs)


def collect_series(name: Optional[str] = None) -> dict:
    """Cluster-wide merged time series from the head's SeriesStore (after
    shipping this process's own backlog). Same return shape as
    ``merge_proc_series``. Deliberately does NOT take a fresh sample: the
    background sampler's evenly spaced ticks are what make delta/dt rates
    meaningful — a collect-time sample would end every series with a
    near-zero interval and rate the newest pair at ~0."""
    from ray_tpu_torch._private.runtime import get_ctx

    request_ship(wait=True)
    try:
        ctx = get_ctx()
        raw = ctx.call("series_get", name=name)
    except Exception:
        raw = None
    if raw is None:
        raw = {
            _process_tag(): {
                "interval": _series_interval(),
                "metrics": get_local_series(name),
            }
        }
    return merge_proc_series(raw)


# ---------------------------------------------------------------------------
# publication + collection
# ---------------------------------------------------------------------------


def _process_tag() -> str:
    return f"pid-{os.getpid()}"


def flush(ship_inline: bool = False) -> None:
    """Publish this process's metric snapshots into the head KV. Series
    shipping is handed to the flusher thread (``request_ship``) unless
    ``ship_inline`` — the exit-time path, where the flusher may already
    be dead and this is the backlog's last chance off the process."""
    from ray_tpu_torch._private.runtime import get_ctx

    try:
        ctx = get_ctx()
    except Exception:
        return  # not initialized (yet/anymore) — metrics are best-effort
    with _registry_lock:
        snaps = [m._snapshot() for m in _registry]
    if not snaps:
        return
    try:
        ctx.call(
            "kv_put",
            key=_KV_PREFIX + _process_tag(),
            value=json.dumps({"time": time.time(), "metrics": snaps}).encode(),
        )
    except Exception:
        pass  # head gone (shutdown) — metrics are best-effort
    if ship_inline:
        _ship_series()
    else:
        # hand the I/O to the flusher thread but keep flush()'s contract
        # ("my samples are at the head when this returns") by waiting on
        # the rendezvous — bounded, and never from a submission path
        request_ship(wait=True)


def _ensure_flusher():
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def loop():
        # one thread does every off-path job on its own cadence: sample
        # the registry into the series rings every _series_interval()
        # (env, re-read each tick so tests can retune a live process),
        # ship snapshots + new samples every _FLUSH_INTERVAL_S, and
        # answer request_ship() nudges immediately — the condition wait
        # doubles as the tick sleep, so an on-demand ship never waits a
        # full interval
        global _ship_done_seq
        last_flush = 0.0
        last_sample = time.monotonic()
        while True:
            interval = _series_interval() if _series_enabled() else _FLUSH_INTERVAL_S
            with _ship_cv:
                if _ship_req_seq == _ship_done_seq:
                    _ship_cv.wait(timeout=max(0.01, last_sample + interval - time.monotonic()))
                # claim BEFORE the ship: requests arriving after this
                # read stay pending and trigger another pass
                claimed = _ship_req_seq
            now = time.monotonic()
            if now - last_sample >= interval:
                last_sample = now
                sample_series_now()
            if now - last_flush >= _FLUSH_INTERVAL_S:
                last_flush = now
                flush(ship_inline=True)
            elif claimed > _ship_done_seq:
                _ship_series()
            if claimed > _ship_done_seq:
                with _ship_cv:
                    _ship_done_seq = claimed
                    _ship_cv.notify_all()

    threading.Thread(target=loop, daemon=True, name="metrics-flusher").start()
    atexit.register(flush, ship_inline=True)


def collect() -> dict:
    """Cluster-wide merged view: {metric_name: {tagset: value-or-histogram}}.

    Counters/histograms sum across processes; gauges last-write-wins by
    publish time. Without a runtime in this process the view is this
    process's registry alone.
    """
    from ray_tpu_torch._private.runtime import get_ctx

    flush()
    try:
        ctx = get_ctx()
    except Exception:
        ctx = None
    if ctx is None:
        # no runtime in this process (a bare engine): the merge over this
        # process's registry alone — what the cluster merge gives with one
        # process
        with _registry_lock:
            snaps = [m._snapshot() for m in _registry]
        merged_local = _merged_local_snaps(snaps)
        return {
            "kinds": {name: ent["kind"] for name, ent in merged_local.items()},
            "metrics": {name: ent["data"] for name, ent in merged_local.items()},
            "boundaries": {
                name: ent["boundaries"]
                for name, ent in merged_local.items()
                if ent["boundaries"] is not None
            },
            "help": {snap["name"]: snap["description"] for snap in snaps if snap["description"]},
        }
    keys = ctx.call("kv_keys", prefix=_KV_PREFIX)
    snapshots = []
    for key in keys:
        raw = ctx.call("kv_get", key=key)
        if raw:
            snapshots.append(json.loads(raw.decode()))
    snapshots.sort(key=lambda s: s["time"])
    merged: dict[str, dict] = {}
    kinds: dict[str, str] = {}
    boundaries: dict[str, list] = {}
    helps: dict[str, str] = {}
    for snap in snapshots:
        for m in snap["metrics"]:
            name, kind = m["name"], m["kind"]
            kinds[name] = kind
            if m.get("description"):
                helps[name] = m["description"]
            if "boundaries" in m:
                boundaries[name] = m["boundaries"]
            out = merged.setdefault(name, {})
            for tagset, val in m["data"].items():
                if kind == "gauge":
                    out[tagset] = val
                elif kind == "counter":
                    out[tagset] = out.get(tagset, 0.0) + val
                else:  # histogram: elementwise sum
                    prev = out.get(tagset)
                    out[tagset] = (
                        [a + b for a, b in zip(prev, val)] if prev else list(val)
                    )
    return {
        "kinds": kinds, "metrics": merged, "boundaries": boundaries,
        "help": helps,
    }


def _escape_label(v) -> str:
    # exposition format: backslash, double-quote and newline are escaped
    # inside label values
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_num(v) -> str:
    # canonical sample values: integers bare, floats via repr (shortest
    # round-trippable form — Prometheus parses either)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def prometheus_text() -> str:
    """Render collect() in the Prometheus exposition format: ``# HELP`` /
    ``# TYPE`` per family, escaped label values, and histograms as
    CUMULATIVE ``_bucket{le="..."}`` series (ending at ``le="+Inf"`` ==
    ``_count``) plus ``_sum``/``_count`` — parseable by any exposition
    parser (tests re-parse the output to prove it)."""
    data = collect()
    lines = []
    for name, series in data.get("metrics", {}).items():
        kind = data["kinds"].get(name, "counter")
        prom_kind = {"gauge": "gauge", "histogram": "histogram"}.get(kind, "counter")
        help_text = data.get("help", {}).get(name, "")
        if help_text:
            esc = help_text.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP ray_tpu_{name} {esc}")
        lines.append(f"# TYPE ray_tpu_{name} {prom_kind}")
        bounds = data.get("boundaries", {}).get(name, [])
        for tagset, val in series.items():
            tags = json.loads(tagset) if tagset else {}

            def fmt(extra=None):
                merged_tags = dict(tags)
                if extra:
                    merged_tags.update(extra)
                if not merged_tags:
                    return ""
                return (
                    "{"
                    + ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in merged_tags.items()
                    )
                    + "}"
                )

            if isinstance(val, list):
                cum = 0
                for b, count in zip(bounds, val):
                    cum += count
                    lines.append(
                        f'ray_tpu_{name}_bucket{fmt({"le": _fmt_num(b)})} '
                        f"{_fmt_num(cum)}"
                    )
                lines.append(
                    f'ray_tpu_{name}_bucket{fmt({"le": "+Inf"})} {_fmt_num(val[-1])}'
                )
                lines.append(f"ray_tpu_{name}_sum{fmt()} {_fmt_num(val[-2])}")
                lines.append(f"ray_tpu_{name}_count{fmt()} {_fmt_num(val[-1])}")
            else:
                lines.append(f"ray_tpu_{name}{fmt()} {_fmt_num(val)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# core runtime metrics (reference: src/ray/stats/metric_defs.cc — tasks by
# state, actors, object store usage — exported by the C++ runtime; here a
# lightweight sampler thread reads the head's state API into gauges so
# Grafana boards generated by util.grafana have live core series)
# ---------------------------------------------------------------------------

_core_thread: Optional[threading.Thread] = None
_core_stop = threading.Event()


_core_gauges: Optional[dict] = None


def _get_core_gauges() -> dict:
    """The 8 core gauges, created ONCE per process: a start/stop/start cycle
    must reuse them, or each restart would append duplicates to _registry
    whose stale snapshots fight the live ones in collect()'s merge."""
    global _core_gauges
    if _core_gauges is None:
        _core_gauges = {
            "tasks": Gauge("core_tasks", "tasks by scheduler state", ("state",)),
            "actors": Gauge("core_actors", "actors by FSM state", ("state",)),
            "nodes": Gauge("core_nodes", "alive nodes"),
            "res_used": Gauge("core_resource_used", "used logical resources", ("resource",)),
            "res_total": Gauge("core_resource_total", "total logical resources", ("resource",)),
            "objects": Gauge("core_objects", "objects tracked by the head"),
            "object_bytes": Gauge("core_object_bytes", "bytes of tracked objects"),
            "spilled": Gauge("core_spilled_bytes", "bytes spilled to disk"),
        }
    return _core_gauges


def _set_tagged(gauge: "Gauge", tag_key: str, values: dict) -> None:
    """Set every current tagged value and ZERO previously-seen tags that
    vanished this sample — a state with no tasks reports 0, not its last
    nonzero value forever."""
    seen = getattr(gauge, "_core_seen", set())
    for tag, v in values.items():
        gauge.set(v, tags={tag_key: tag})
    for tag in seen - set(values):
        gauge.set(0, tags={tag_key: tag})
    gauge._core_seen = seen | set(values)


def start_core_metrics(interval_s: float = 5.0) -> None:
    """Start (idempotently) the core-series sampler in this process. The
    dashboard server calls this; drivers can too for headless scraping."""
    global _core_thread
    if _core_thread is not None and _core_thread.is_alive():
        return
    _core_stop.clear()
    g = _get_core_gauges()

    def _sample_once() -> None:
        import ray_tpu_torch
        from ray_tpu_torch.util import state as st

        summary = st.summary()
        _set_tagged(g["tasks"], "state", summary.get("tasks", {}).get("by_state") or {})
        _set_tagged(g["actors"], "state", summary.get("actors", {}).get("by_state") or {})
        g["nodes"].set(
            len([n for n in st.list_nodes() if n.get("Alive", n.get("alive", True))])
        )
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        _set_tagged(g["res_total"], "resource", total)
        _set_tagged(
            g["res_used"],
            "resource",
            {k: v - avail.get(k, 0.0) for k, v in total.items()},
        )
        objs = summary.get("objects", {})
        g["objects"].set(objs.get("total", 0))
        g["object_bytes"].set(objs.get("total_bytes", 0))
        g["spilled"].set(objs.get("spilled_bytes", 0))

    def _loop() -> None:
        while not _core_stop.wait(interval_s):
            try:
                _sample_once()
            except Exception:  # raylint: disable=RL007
                # head shutting down / not initialized: keep polling; the
                # sampler must never take the process down, and warning here
                # would fire on every clean driver shutdown
                pass

    try:
        _sample_once()
    except Exception:
        pass
    _core_thread = threading.Thread(
        target=_loop, name="core-metrics", daemon=True
    )
    _core_thread.start()


def stop_core_metrics() -> None:
    global _core_thread
    t = _core_thread
    _core_stop.set()
    _core_thread = None
    if t is not None:
        # join before a restart can clear the event, or the old sampler
        # (mid-sample when the flag flipped) keeps running alongside the new
        t.join(timeout=10.0)
