"""Device-step profiler: per-site wall time + runtime retrace detection
(copy of ``ray_tpu/util/device_prof.py``).

Every step function in the serving/training hot loop (decode / prefill /
verify / fork in ``llm.model_runner``, a train step wrapped by
``parallel.train_step.profile_step_fn``) is supposed to run ONE shape per
site after warm-up — the static-shape discipline the engine is built on,
and what raylint RL014 (retrace-storm) enforces statically. This module
is RL014's **runtime twin**: it measures the wall time of each call into a
per-site histogram and watches the callable's cache size, so a site that
runs a NEW shape after its warmup baseline emits a ``<family>.retrace``
flight-recorder event and bumps the ``device_retraces`` counter — which
the ``retrace-storm`` SLO rule (``util.slo``) turns into a firing alert.

What "cache size" means here is the one change from the reference. There,
``_cache_size()`` is a jitted function's count of compiled executables.
Eager PyTorch compiles nothing, so its counterpart is the number of
distinct shape keys a step function has run: the runner's step functions
expose that count as ``_cache_size()`` (``llm.model_runner``), and a new
shape is where an eager step pays its first-call costs (allocator growth,
library handle and workspace set-up, a kernel build when nothing warmed
it). A callable without ``_cache_size`` is timed and never fires.

Usage (one profiler per owner, so two engines in one process never
compare cache sizes of different step functions)::

    prof = JitProfiler(event="llm.retrace")
    t0 = time.perf_counter()
    out = step(...)
    prof.note("decode", step, time.perf_counter() - t0)

``note`` is an EMIT PATH under the zero-cost telemetry contract: a dict
probe, one lock-free histogram observe, and a cache-size read — no
shared locks. The retrace branch (event + counter) only runs when a site
actually met a new shape, which steady-state engines never do.

The first ``note`` per site sets the baseline — by construction that is
the warmup call (``LLMEngine.warmup`` / the first train step), so
legitimate first calls never count as retraces. A site whose shapes
genuinely vary (none should) fires exactly once per NEW shape: the
baseline advances to the observed cache size each time.
"""

from __future__ import annotations

import threading
from typing import Optional

#: raylint RL012 registry.  The retrace EVENT types are per-owner
#: (``JitProfiler(event="llm.retrace" | "train.retrace")``) — a dynamic
#: ``record(self.event, ...)`` site RL012 deliberately skips — and are
#: documented in OBSERVABILITY.md's event-family tables instead.
METRIC_NAMES = (
    "device_step_seconds",
    "device_retraces",
)

_METRICS = None
_METRICS_LOCK = threading.Lock()

#: boundaries spanning sub-ms steps through multi-second first calls
_STEP_BOUNDARIES = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _metrics() -> dict:
    global _METRICS
    if _METRICS is not None:
        return _METRICS
    with _METRICS_LOCK:
        if _METRICS is not None:
            return _METRICS
        from ray_tpu_torch.util.metrics import Counter, Histogram

        _METRICS = {
            "seconds": Histogram(
                "device_step_seconds",
                "wall time per step-function call (decode/prefill/"
                "verify/fork/train_step), including first-call costs",
                boundaries=_STEP_BOUNDARIES,
                tag_keys=("site",),
            ),
            "retraces": Counter(
                "device_retraces",
                "step sites that ran a new shape AFTER their warmup baseline — "
                "RL014's runtime twin; any nonzero rate trips the "
                "retrace-storm SLO rule",
                tag_keys=("site",),
            ),
        }
    return _METRICS


def _cache_size(fn) -> Optional[int]:
    """Distinct shape keys a step function has run (its ``_cache_size()``,
    module doc), or None when the object doesn't expose one (plain
    callables)."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


class JitProfiler:
    """Per-owner step profiler.  ``note`` is the hot path; everything
    else (``stats``) is query-side."""

    __slots__ = ("event", "_sites", "_m")

    def __init__(self, event: str = "llm.retrace"):
        #: flight-recorder event type emitted on a retrace (``llm.retrace``
        #: for the serving engine, ``train.retrace`` for the train step)
        self.event = event
        # site -> [baseline cache size (None until known), calls, retraces];
        # single-writer in practice (the engine step / train loop thread),
        # and a racy double-count would only over-report — never a lock
        self._sites: dict[str, list] = {}
        self._m = _metrics()

    def note(self, site: str, fn, dur_s: float) -> bool:
        """Record one call of step site ``site``; returns True when the
        call RETRACED (ran a new shape at) an already-baselined site."""
        self._m["seconds"].observe(dur_s, tags={"site": site})
        st = self._sites.get(site)
        size = _cache_size(fn)
        if st is None:
            # first call per site == the warmup call: baseline
            # here.  The zero-inc materializes the site's tagged series
            # BEFORE any retrace can happen — a window delta needs a
            # pre-storm sample to diff against, so without it the first
            # storm of a site would never trip the retrace-storm SLO
            self._sites[site] = [size, 1, 0]
            self._m["retraces"].inc(0.0, tags={"site": site})
            return False
        st[1] += 1
        if size is None or st[0] is None or size <= st[0]:
            if st[0] is None:
                st[0] = size
            return False
        # new shape after warmup: advance the baseline so each NEW shape
        # fires exactly once, then take the (cold) reporting path
        st[0] = size
        st[2] += 1
        self._m["retraces"].inc(tags={"site": site})
        from ray_tpu_torch._private import events as _events

        _events.record(
            self.event, site=site, cache_size=size,
            call_n=st[1], dur_s=round(dur_s, 6),
        )
        return True

    def stats(self) -> dict:
        """Per-site ``{"calls", "retraces", "cache_size"}`` (query side)."""
        return {
            site: {"cache_size": st[0], "calls": st[1], "retraces": st[2]}
            for site, st in self._sites.items()
        }

    @property
    def retraces(self) -> int:
        return sum(st[2] for st in self._sites.values())
