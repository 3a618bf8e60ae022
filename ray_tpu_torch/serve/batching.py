"""@serve.batch — opportunistic request batching inside a replica (copy of
``ray_tpu/serve/batching.py``).

Reference: ``python/ray/serve/batching.py`` (_BatchQueue: requests enqueue,
a loop flushes up to max_batch_size after batch_wait_timeout_s). This is the
op that makes accelerator serving fast: N concurrent single requests
entering a replica's thread pool coalesce into ONE forward pass, so the
device sees a real batch dimension instead of N matmuls of batch 1.

Threaded implementation (replica concurrency is thread-based here, not
asyncio): callers enqueue (args, Future) and block on the Future; the first
waiter becomes the flusher — it waits until the batch fills or the timeout
lapses, calls the wrapped function ONCE with lists of arguments, and
distributes results/exceptions.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional


_CREATE_LOCK = threading.Lock()

#: batching metric family — RL012 cross-checks this registry against the
#: constructors in ``_metrics()`` and the observability docs
METRIC_NAMES = (
    "serve_batch_queue_depth",
    "serve_batch_last_flush_size",
)

_METRICS = None


def _metrics() -> dict:
    """Batching saturation gauges, created once per process (under
    _CREATE_LOCK: concurrent first submissions must not register duplicate
    global gauges, which would fight in metrics collect()). The same
    signal surface the LLM deployment exports: queue depth says the
    replica is admission-bound, flush size says how full the batches the
    device actually sees are — both tagged per batched function so replica
    autoscaling (and Grafana) can tell WHICH entry point saturates."""
    global _METRICS
    if _METRICS is None:
        with _CREATE_LOCK:
            if _METRICS is not None:
                return _METRICS
            from ray_tpu_torch.util.metrics import Gauge

            _METRICS = {
                "depth": Gauge(
                    "serve_batch_queue_depth",
                    "requests waiting in a @serve.batch queue",
                    ("fn", "model"),
                ),
                "flush": Gauge(
                    "serve_batch_last_flush_size",
                    "batch size of the most recent flush",
                    ("fn", "model"),
                ),
            }
    return _METRICS


class _BatchQueue:
    def __init__(
        self,
        fn: Callable,
        max_batch_size: int,
        batch_wait_timeout_s: float,
        name: str = "",
        model_id: str = "",
    ):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.name = name or getattr(fn, "__name__", "batch")
        # multiplexed deployments keep one queue PER model id — the gauge
        # series must keep them apart or one model's idle queue overwrites
        # another's backlog in the saturation signal
        self._tags = {"fn": self.name, "model": model_id}
        self.last_flush_size = 0
        self._lock = threading.Lock()
        self._queue: list[tuple[Any, Future]] = []
        self._flusher_active = False

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        flush_now = False
        with self._lock:
            self._queue.append((item, fut))
            depth = len(self._queue)
            if not self._flusher_active:
                self._flusher_active = True
                flush_now = True
        _metrics()["depth"].set(depth, tags=self._tags)
        if flush_now:
            threading.Thread(target=self._flush_loop, daemon=True).start()
        return fut

    def _flush_loop(self):
        while True:
            deadline = time.time() + self.timeout
            while time.time() < deadline:
                with self._lock:
                    if len(self._queue) >= self.max_batch_size:
                        break
                time.sleep(min(0.001, self.timeout / 10 or 0.001))
            with self._lock:
                batch = self._queue[: self.max_batch_size]
                self._queue = self._queue[self.max_batch_size :]
                if not batch:
                    self._flusher_active = False
                    _metrics()["depth"].set(0, tags=self._tags)
                    return
                depth = len(self._queue)
            self.last_flush_size = len(batch)
            _metrics()["flush"].set(len(batch), tags=self._tags)
            _metrics()["depth"].set(depth, tags=self._tags)
            items = [b[0] for b in batch]
            try:
                results = self.fn(items)
                if len(results) != len(items):
                    raise ValueError(
                        f"batched function returned {len(results)} results for "
                        f"{len(items)} inputs"
                    )
                for (_, fut), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as e:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


def batch(
    _fn: Optional[Callable] = None,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorate a method taking a LIST of requests (returning a list of
    results) so concurrent single-request callers are transparently batched.

    Usage::

        class Model:
            @serve.batch(max_batch_size=32, batch_wait_timeout_s=0.005)
            def predict(self, inputs: list) -> list: ...

        # callers invoke predict(single_input) and get a single result
    """

    def wrap(fn):
        # Queues hang off the INSTANCE (created lazily at first call) so the
        # decorated class stays cloudpickle-able — a closure-held lock or
        # queue dict would break shipping the deployment to replica actors.
        # One queue PER multiplexed model id: batches never mix models, and
        # the flusher thread re-enters the submitting request's model
        # context (threading.local does not cross into the flusher).
        attr = f"__serve_batch_queues_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, item):
            import ray_tpu_torch.serve.batching as _b
            from ray_tpu_torch.serve.multiplex import (
                _set_request_model_id,
                get_multiplexed_model_id,
            )

            model_id = get_multiplexed_model_id()
            queues = getattr(self, attr, None)
            if queues is None:
                with _b._CREATE_LOCK:
                    queues = getattr(self, attr, None)
                    if queues is None:
                        queues = {}
                        setattr(self, attr, queues)
            q = queues.get(model_id)
            if q is None:
                with _b._CREATE_LOCK:
                    q = queues.get(model_id)
                    if q is None:

                        def run(items, _mid=model_id):
                            _set_request_model_id(_mid)
                            try:
                                return fn(self, items)
                            finally:
                                _set_request_model_id(None)

                        q = _BatchQueue(
                            run, max_batch_size, batch_wait_timeout_s,
                            name=fn.__name__, model_id=model_id or "",
                        )
                        queues[model_id] = q
            return q.submit(item).result()

        wrapper._is_serve_batch = True  # noqa: SLF001
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
