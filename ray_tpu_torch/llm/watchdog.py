"""Engine watchdog: stall detection, wedge-proof reaping, KV leak audit
(copy of ``ray_tpu/llm/watchdog.py``).

The step loop is the engine's single point of failure: a wedged step
(a device hang, a runaway kernel, a host sync that never returns)
freezes every stream at once while holding the engine lock — so nothing
that shares that lock can even *diagnose* the freeze.  The watchdog is a small
per-engine daemon thread built around that constraint:

* **stall detection** — the engine publishes a lock-free liveness beat
  (``LLMEngine._beat``: last completed step tick + pending work).  Work
  pending with no step progress for ``stall_deadline_s`` is a stall: one
  ``llm.watchdog.stall`` flight-recorder event per episode, the
  ``llm_watchdog_stalls`` counter, and the ``llm_watchdog_step_age_s``
  gauge (0 while idle) that the reference's ``engine-stall`` SLO rule
  pages on.
* **reaping** — cancelled and deadline-blown requests are reaped every
  tick.  With the engine lock (bounded acquire) this is the full
  scheduler reap, freeing slots and KV blocks even when no caller is
  driving ``step()``.  When the lock can't be had — the wedge case — the
  watchdog falls back to unblocking the CONSUMERS: it puts the ``done``
  sentinel on each doomed request's stream queue (thread-safe, lockless)
  and flags the request cancelled so the scheduler finishes it properly
  if the step loop ever revives.  A stream caller never hangs on a
  request the deadline already killed.
* **KV leak audit** — ``KVBlockPool.audit()`` checks the refcounted
  free-list ledger invariant (free + exclusively-owned +
  shared-with-refcount + cache-only still partition the usable blocks;
  no duplicate, out-of-range, or ref-inconsistent ids) under the pool
  lock alone, and ``PrefixCache.audit()`` cross-checks the radix tree
  against the pool's cache-held set (no dangling tree references after
  eviction, no retained block without a node); with the engine lock the
  watchdog also cross-checks that every block owner is a live
  slot-holding request.  A violation is a ``llm.watchdog.leak`` event +
  counter — leaked blocks are the silent capacity death of a
  long-running replica.

``EngineStalledError`` (raised by ``LLMEngine.stream_tokens`` on token
timeout) carries the same lock-free diagnosis so a caller's timeout names
the cause — wedged step vs saturated queue vs drained pool — instead of
a bare TimeoutError.

The watchdog thread touches no tensor and so never calls into CUDA: a
device wedge blocks the step thread in its host sync, never the watchdog.
That the step thread's wait releases the GIL is what lets this thread run
at all during such a wedge.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private.log_util import warn_throttled
from ray_tpu_torch.llm.scheduler import FINISH_CANCELLED, FINISH_DEADLINE

#: the watchdog's metric family (the reference's names)
METRIC_NAMES = (
    "llm_watchdog_step_age_s",
    "llm_watchdog_stalls",
    "llm_watchdog_reaped",
    "llm_watchdog_leaks",
    "llm_watchdog_audit_ok",
)

_WD_METRICS = None
_WD_LOCK = threading.Lock()


def _metrics() -> dict:
    global _WD_METRICS
    if _WD_METRICS is not None:
        return _WD_METRICS
    with _WD_LOCK:
        if _WD_METRICS is not None:
            return _WD_METRICS
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _WD_METRICS = {
            "step_age": Gauge(
                "llm_watchdog_step_age_s",
                "age of the last engine step while work is pending (0 = "
                "idle or healthy); the engine-stall SLO rule reads this",
            ),
            "stalls": Counter(
                "llm_watchdog_stalls", "stall episodes detected (wedged step loop)"
            ),
            "reaped": Counter(
                "llm_watchdog_reaped",
                "cancelled/deadline-blown requests reaped by the watchdog",
            ),
            "leaks": Counter(
                "llm_watchdog_leaks", "KV block-pool ledger audit failures"
            ),
            "audit_ok": Gauge(
                "llm_watchdog_audit_ok", "1 while the last KV-pool audit passed"
            ),
        }
    return _WD_METRICS


class EngineStalledError(TimeoutError):
    """``stream_tokens`` timed out, with the engine's stall diagnosis
    attached (gathered lock-free — valid even while the step loop is
    wedged holding the engine lock)."""

    def __init__(
        self,
        msg: str,
        *,
        last_step_age_s: float = 0.0,
        queue_depth: int = 0,
        kv_utilization: float = 0.0,
    ):
        self.last_step_age_s = last_step_age_s
        self.queue_depth = queue_depth
        self.kv_utilization = kv_utilization
        super().__init__(
            f"{msg} [last step {last_step_age_s:.1f}s ago, "
            f"queue_depth={queue_depth}, kv_utilization={kv_utilization:.2f}]"
        )

    def __reduce__(self):
        # rebuild through kwargs so the error pickles across process hops
        return (
            _rebuild_stalled,
            (
                self.args[0] if self.args else "",
                self.last_step_age_s,
                self.queue_depth,
                self.kv_utilization,
            ),
        )


def _rebuild_stalled(msg, age, depth, kv):
    err = EngineStalledError.__new__(EngineStalledError)
    TimeoutError.__init__(err, msg)
    err.last_step_age_s, err.queue_depth, err.kv_utilization = age, depth, kv
    return err


class EngineWatchdog:
    """One monitor thread per engine (``LLMEngine.start_watchdog``)."""

    def __init__(
        self,
        engine,
        stall_deadline_s: float = 30.0,
        interval_s: float = 1.0,
        lock_timeout_s: float = 0.1,
    ):
        self.engine = engine
        self.stall_deadline_s = stall_deadline_s
        self.interval_s = interval_s
        self.lock_timeout_s = lock_timeout_s
        self.stall_count = 0
        self.leak_count = 0
        self._stalled = False        # inside a stall episode (event fired)
        self._leaked = False         # inside a leak episode (event fired)
        self._unblocked: set[str] = set()  # emergency-reaped request ids
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EngineWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="llm-engine-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception as e:
                warn_throttled("llm watchdog: check", e)
            self._stop.wait(self.interval_s)

    # -- one tick (also the unit-test surface) -----------------------------

    def check_once(self) -> dict:
        """Run one watchdog pass; returns what it saw/did (golden-testable
        without a thread): ``{stalled, step_age_s, pending, reaped,
        unblocked, audit}``. Staleness comes from the engine's monotonic
        beat — tests pin time by setting ``engine._beat`` directly."""
        m = _metrics()
        age, pending = self.engine.progress()
        stalled = pending > 0 and age >= self.stall_deadline_s
        m["step_age"].set(age if pending > 0 else 0.0)
        if stalled and not self._stalled:
            # one event per episode, not per tick — the recorder ring is
            # shared and a day-long wedge must not wrap it
            self.stall_count += 1
            m["stalls"].inc()
            _events.record(
                "llm.watchdog.stall", source="watchdog",
                last_step_age_s=round(age, 3), queue_depth=pending,
                kv_utilization=round(self.engine.pool.utilization(), 4),
                deadline_s=self.stall_deadline_s,
            )
        self._stalled = stalled

        reaped = unblocked = 0
        audit: dict = {}
        got_lock = self.engine._lock.acquire(timeout=self.lock_timeout_s)
        if got_lock:
            try:
                reaped = self._reap_locked()
                audit = self._audit_locked()
            finally:
                self.engine._lock.release()
        else:
            # the wedge case: the step loop owns the lock and is not
            # moving — unblock doomed requests' CONSUMERS without touching
            # scheduler state (pool-only audit still runs: its lock is
            # never held across device calls, and the prefix-tree
            # cross-check needs only the cache + pool locks)
            unblocked = self._unblock_doomed()
            audit = self._check_audit(
                self.engine.pool.audit(), orphans=(),
                cache_audit=self._cache_audit(),
            )
        if reaped or unblocked:
            m["reaped"].inc(reaped + unblocked)
        return {
            "stalled": stalled,
            "step_age_s": age,
            "pending": pending,
            "reaped": reaped,
            "unblocked": unblocked,
            "audit": audit,
        }

    # -- internals ---------------------------------------------------------

    def _reap_locked(self) -> int:
        """Full reap under the engine lock: finish cancelled/deadline-blown
        requests through the scheduler (slots and blocks come back) even
        when nobody is driving ``step()``. The predicate lives in
        ``LLMEngine._reap`` — one copy, shared with the step loop."""
        eng = self.engine
        n = eng._reap()
        if n:
            eng._requests = {
                k: r for k, r in eng._requests.items() if not r.finished
            }
            _events.record("llm.watchdog.reap", n=n, mode="locked")
        return n

    def _unblock_doomed(self) -> int:
        """Lockless fallback: end the STREAMS of cancelled/deadline-blown
        requests so consumers stop waiting on a wedged engine. Scheduler
        state is deliberately untouched (no lock) — both conditions are
        permanent, so the engine's own ``_reap`` finishes these requests
        with the SAME reason if the step loop ever revives; flagging a
        deadline-blown request cancelled here would misreport its
        finish_reason there."""
        try:
            reqs = list(self.engine._requests.values())
        except RuntimeError:  # dict mutated mid-iteration: try next tick
            return 0
        now = time.time()
        n = 0
        for req in reqs:
            if req.finished or req.id in self._unblocked:
                continue
            if req.cancelled.is_set():
                reason = FINISH_CANCELLED
            elif req.deadline is not None and now >= req.deadline:
                reason = FINISH_DEADLINE
            else:
                continue
            req.stream.put(("done", reason))
            self._unblocked.add(req.id)
            n += 1
        if n:
            _events.record("llm.watchdog.reap", n=n, mode="emergency")
        return n

    def _cache_audit(self):
        """Prefix-tree ↔ pool cross-check (``PrefixCache.audit``): no
        dangling tree references after eviction, no cache-held pool block
        without a node.  None when the engine runs without a cache."""
        cache = getattr(self.engine, "prefix_cache", None)
        return cache.audit() if cache is not None else None

    def _audit_locked(self) -> dict:
        """Pool-ledger audit plus the owner cross-check that needs the
        engine lock: every block owner must be a request holding a slot
        (waiting/preempted requests own nothing)."""
        pool_audit = self.engine.pool.audit()
        slot_ids = {
            r.id for r in self.engine.scheduler.slots if r is not None
        }
        orphans = tuple(o for o in pool_audit["owners"] if o not in slot_ids)
        return self._check_audit(pool_audit, orphans, self._cache_audit())

    def _check_audit(
        self, pool_audit: dict, orphans: tuple, cache_audit=None
    ) -> dict:
        m = _metrics()
        cache_ok = cache_audit is None or cache_audit["ok"]
        ok = pool_audit["ok"] and not orphans and cache_ok
        result = dict(pool_audit, orphans=list(orphans), ok=ok)
        if cache_audit is not None:
            result["prefix_cache"] = cache_audit
        m["audit_ok"].set(1.0 if ok else 0.0)
        if not ok and not self._leaked:
            self.leak_count += 1
            m["leaks"].inc()
            _events.record(
                "llm.watchdog.leak",
                missing=pool_audit.get("missing", 0),
                duplicates=pool_audit.get("duplicates", False),
                out_of_range=pool_audit.get("out_of_range", 0),
                ref_errors=pool_audit.get("ref_errors", 0),
                orphans=list(orphans)[:8],
                cache_dangling=(
                    len(cache_audit["dangling"]) if cache_audit else 0
                ),
                cache_unindexed=(
                    len(cache_audit["unindexed"]) if cache_audit else 0
                ),
            )
        self._leaked = not ok
        return result
