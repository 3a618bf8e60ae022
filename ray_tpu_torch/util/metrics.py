"""User-defined metrics: Counter / Gauge / Histogram (copy of
``ray_tpu/util/metrics.py``, the process-local part).

Each process records locally into a registry of tagged metrics.
``collect()`` merges this process's registry — what the reference's
``collect()`` merges across processes, with one process — and
``prometheus_text()`` renders it in the Prometheus exposition format for
scraping. A daemon sampler keeps a bounded time series per (metric,
tagset) (``get_local_series``). Publishing snapshots to a head, the
cluster-wide merge and the core runtime gauges wait for the runtime's port
(ROADMAP.md, queue A): no thread here reaches for a head.

Knobs (environment; the reference's names): ``RAY_TPU_METRICS_SERIES``
(``0`` disables the series), ``RAY_TPU_METRICS_SERIES_CAPACITY`` (samples
per ring, default 512), ``RAY_TPU_METRICS_SERIES_INTERVAL_S`` (sampling
cadence, default 1 s).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Optional, Sequence

_registry_lock = threading.Lock()
_registry: list["Metric"] = []
_sampler_started = False


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

    Hot-path architecture (as in the reference): increments
    land in **per-thread cells** — each emitting thread owns a private
    dict it alone mutates, registered once by an atomic ``list.append``.
    The emit path (``Counter.inc`` / ``Gauge.set`` /
    ``Histogram.observe``) therefore acquires NO shared lock, ever; the
    cells are merged only at snapshot time (the sampler's 1 Hz sample or
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
        _ensure_sampler()

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
        plain list.append — atomic under the GIL, no lock (the port's
        tests assert the emit path stays lock-free)."""
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
    into the published total only at snapshot time."""

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
        :func:`percentiles_from_buckets`)."""
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
    """Percentile snapshots from ``collect()``'s merged buckets (this
    process's registry): ``{metric_name: {tagset: {"p50": ..., "count":
    ...}}}`` (optionally one metric)."""
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
# The process samples its OWN registry on a fixed cadence into fixed-size
# rings (the ``metrics-sampler`` thread, every
# RAY_TPU_METRICS_SERIES_INTERVAL_S). Shipping the rings to a head and the
# cluster merge (``collect_series``) wait for the runtime's port
# (ROADMAP.md, queue A).
# ---------------------------------------------------------------------------

_series_lock = threading.Lock()
# name -> {"kind": str, "boundaries": list|None, "points": {tagset: deque}}
# deque entries: (sample_seq, ts, value) — value is a float for
# counters/gauges, the buckets+sum+count list for histograms
_series: dict[str, dict] = {}
_sample_seq = 0


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
    Called by the sampler thread on its cadence; tests call it directly
    for a deterministic sample."""
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


def _ensure_sampler() -> None:
    """Start (once) the daemon that samples the registry into the local
    series every ``RAY_TPU_METRICS_SERIES_INTERVAL_S`` (re-read each tick,
    so a live process can be retuned) — the reference flusher's sampling
    duty, without its shipping."""
    global _sampler_started
    with _registry_lock:
        if _sampler_started:
            return
        _sampler_started = True

    def loop():
        while True:
            time.sleep(_series_interval())
            if _series_enabled():
                sample_series_now()

    threading.Thread(target=loop, daemon=True, name="metrics-sampler").start()


def collect() -> dict:
    """This process's merged view: ``{"kinds", "metrics": {metric_name:
    {tagset: value-or-histogram}}, "boundaries", "help"}`` — the
    reference's ``collect()`` over one process's snapshot: counters and
    histograms of one name sum, gauges last-write-wins."""
    with _registry_lock:
        snaps = [m._snapshot() for m in _registry]
    merged = _merged_local_snaps(snaps)
    return {
        "kinds": {name: ent["kind"] for name, ent in merged.items()},
        "metrics": {name: ent["data"] for name, ent in merged.items()},
        "boundaries": {
            name: ent["boundaries"] for name, ent in merged.items() if ent["boundaries"] is not None
        },
        "help": {snap["name"]: snap["description"] for snap in snaps if snap["description"]},
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
    ``_count``) plus ``_sum``/``_count``. The ``ray_tpu_`` family prefix is
    the reference's, so dashboards read either package."""
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
