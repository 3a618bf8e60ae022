"""ActorPool (reference: ``python/ray/util/actor_pool.py``): round-robin a
set of actors over a stream of work items with ordered or unordered results."""

from __future__ import annotations

from typing import Any, Callable, Iterable, TypeVar

import ray_tpu_torch

V = TypeVar("V")


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list = []

    def map(self, fn: Callable, values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[V]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable, value: V):
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def _return_actor(self, actor):
        self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout=None):
        if not self.has_next():
            raise StopIteration("No more results")
        future = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        value = ray_tpu_torch.get(future, timeout=timeout)
        _, actor = self._future_to_actor.pop(future)
        self._return_actor(actor)
        return value

    def get_next_unordered(self, timeout=None):
        if not self.has_next():
            raise StopIteration("No more results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        i, actor = self._future_to_actor.pop(future)
        del self._index_to_future[i]
        self._next_return_index = max(self._next_return_index, i + 1)
        value = ray_tpu_torch.get(future)
        self._return_actor(actor)
        return value

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def pop_idle(self):
        return self._idle.pop() if self.has_free() else None

    def push(self, actor):
        self._return_actor(actor)
