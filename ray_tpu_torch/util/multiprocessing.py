"""``multiprocessing.Pool``-compatible API over cluster tasks.

Counterpart of the reference's ``ray.util.multiprocessing`` shim: the
stdlib Pool surface (apply/map/imap/starmap + async variants) where each
work item is a task, so a Pool transparently spans every host in the
cluster instead of one machine's fork pool.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Optional

import ray_tpu_torch


class AsyncResult:
    """Matches ``multiprocessing.pool.AsyncResult``."""

    def __init__(self, refs, single: bool, callback=None, error_callback=None):
        self._refs = refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None

    def _resolve(self, timeout=None):
        if self._done:
            return
        try:
            vals = ray_tpu_torch.get(self._refs, timeout=timeout)
            self._value = vals[0] if self._single else vals
            if self._callback is not None:
                self._callback(self._value)
        except ray_tpu_torch.exceptions.GetTimeoutError:
            # stdlib semantics: a timed-out get raises TimeoutError but does
            # NOT consume the result — a later get() can still succeed
            import multiprocessing

            raise multiprocessing.TimeoutError()
        except BaseException as e:  # noqa: BLE001 - stdlib Pool semantics
            self._error = e
            if self._error_callback is not None:
                self._error_callback(e)
        self._done = True

    def get(self, timeout=None):
        self._resolve(timeout)
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, timeout=None):
        ray_tpu_torch.wait(list(self._refs), num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(list(self._refs), num_returns=len(self._refs), timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self._done:
            raise ValueError("result is not ready")
        return self._error is None


class Pool:
    """Drop-in ``multiprocessing.Pool`` running on the cluster.

    ``processes`` only bounds in-flight concurrency (the cluster scheduler
    owns placement); ``initializer`` runs lazily inside each task via a
    per-process cache, mirroring Pool's per-worker initializer."""

    def __init__(
        self,
        processes: Optional[int] = None,
        initializer: Optional[Callable] = None,
        initargs: tuple = (),
    ):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._max_inflight = processes or int(
            ray_tpu_torch.cluster_resources().get("CPU", 4)
        )
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

        import uuid as _uuid

        init = initializer
        pool_id = _uuid.uuid4().hex  # initializer runs once per (pool, worker)

        @ray_tpu_torch.remote
        def _run(fn, args, kwargs, initargs):
            if init is not None:
                import ray_tpu_torch.util.multiprocessing as _m

                done = getattr(_m, "_pool_initialized_ids", None)
                if done is None:
                    done = _m._pool_initialized_ids = set()
                if pool_id not in done:
                    init(*initargs)
                    done.add(pool_id)
            return fn(*args, **(kwargs or {}))

        self._task = _run

    # -- core ---------------------------------------------------------------

    def _submit(self, fn, args=(), kwargs=None):
        if self._closed:
            raise ValueError("Pool not running")
        return self._task.remote(fn, tuple(args), dict(kwargs or {}), self._initargs)

    def _submit_many(self, fn, iterable_of_args):
        """Windowed submission: at most ``processes`` tasks in flight."""
        refs = []
        window: list = []
        for args in iterable_of_args:
            if len(window) >= self._max_inflight:
                _, window = ray_tpu_torch.wait(window, num_returns=1)
            r = self._submit(fn, args)
            window.append(r)
            refs.append(r)
        return refs

    # -- stdlib surface -----------------------------------------------------

    def apply(self, func, args=(), kwds=None):
        return ray_tpu_torch.get(self._submit(func, args, kwds))

    def apply_async(self, func, args=(), kwds=None, callback=None, error_callback=None):
        return AsyncResult(
            [self._submit(func, args, kwds)], True, callback, error_callback
        )

    def map(self, func, iterable, chunksize: Optional[int] = None):
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable, chunksize=None, callback=None, error_callback=None):
        refs = self._submit_many(func, ((x,) for x in iterable))
        return AsyncResult(refs, False, callback, error_callback)

    def starmap(self, func, iterable, chunksize: Optional[int] = None):
        return ray_tpu_torch.get(self._submit_many(func, iterable))

    def starmap_async(self, func, iterable, chunksize=None, callback=None, error_callback=None):
        return AsyncResult(self._submit_many(func, iterable), False, callback, error_callback)

    def imap(self, func, iterable, chunksize: Optional[int] = None):
        refs = self._submit_many(func, ((x,) for x in iterable))
        for r in refs:
            yield ray_tpu_torch.get(r)

    def imap_unordered(self, func, iterable, chunksize: Optional[int] = None):
        pending = self._submit_many(func, ((x,) for x in iterable))
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield ray_tpu_torch.get(done[0])

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
