"""Distributed FIFO queue backed by an actor.

Reference: ``python/ray/util/queue.py`` (Queue over a ``_QueueActor`` with
put/get/qsize/empty/full + *_nowait + batch variants). Any process holding
the Queue object (it pickles by actor handle) shares the same FIFO.
"""

from __future__ import annotations

import queue as _pyqueue
import time
from typing import Any, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: _pyqueue.Queue = _pyqueue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            self._q.put(item, block=timeout != 0, timeout=timeout or None)
            return True
        except _pyqueue.Full:
            return False

    def get(self, timeout: Optional[float] = None):
        try:
            return (True, self._q.get(block=timeout != 0, timeout=timeout or None))
        except _pyqueue.Empty:
            return (False, None)

    def put_batch(self, items: list, timeout: Optional[float] = None) -> bool:
        # atomic: reject the WHOLE batch if it can't fit (a partial insert
        # would duplicate items when the caller retries after Full)
        maxsize = self._q.maxsize
        if maxsize > 0 and self._q.qsize() + len(items) > maxsize:
            return False
        for item in items:
            self._q.put(item)
        return True

    def get_batch(self, max_items: int):
        out = []
        while len(out) < max_items:
            ok, item = self.get(timeout=0)
            if not ok:
                break
            out.append(item)
        return out


class Queue:
    """``Queue(maxsize=0)`` — 0 means unbounded.

    Blocking semantics run inside the actor (``max_concurrency`` keeps
    control calls live while a ``get`` blocks), so producers/consumers in
    different processes coordinate exactly like ``queue.Queue`` threads.
    """

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        cls = ray_tpu_torch.remote(_QueueActor)
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)
        self.actor = cls.options(**opts).remote(maxsize)
        self.maxsize = maxsize

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    # blocking semantics loop CLIENT-side over short actor-side waits — an
    # unbounded block inside the actor would pin one of its threads and can
    # wedge the pool (getters starving putters)
    _SLICE = 0.2

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        # ship the payload ONCE: retry slices re-send only a tiny ObjectRef,
        # not the item (a blocked 100MB put must not re-serialize per slice)
        ref = ray_tpu_torch.put(item)
        while True:
            slice_t = 0 if not block else self._SLICE
            if deadline is not None:
                slice_t = max(0, min(slice_t, deadline - time.monotonic()))
            ok = ray_tpu_torch.get(self.actor.put.remote(ref, slice_t))
            if ok:
                return
            if not block or (deadline is not None and time.monotonic() >= deadline):
                raise Full("ray_tpu_torch.util.queue.Queue is full")

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def put_nowait_batch(self, items: list):
        if not ray_tpu_torch.get(self.actor.put_batch.remote(list(items), 0)):
            raise Full("ray_tpu_torch.util.queue.Queue is full")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            slice_t = 0 if not block else self._SLICE
            if deadline is not None:
                slice_t = max(0, min(slice_t, deadline - time.monotonic()))
            ok, item = ray_tpu_torch.get(self.actor.get.remote(slice_t))
            if ok:
                return self._resolve(item)
            if not block or (deadline is not None and time.monotonic() >= deadline):
                raise Empty("ray_tpu_torch.util.queue.Queue is empty")

    @staticmethod
    def _resolve(item):
        from ray_tpu_torch._private.runtime import ObjectRef

        return ray_tpu_torch.get(item) if isinstance(item, ObjectRef) else item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, max_items: int) -> list:
        return [
            self._resolve(i)
            for i in ray_tpu_torch.get(self.actor.get_batch.remote(max_items))
        ]

    def shutdown(self):
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass
