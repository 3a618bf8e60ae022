"""Staging buffer between the rollout plane and the async learner (copy of
``ray_tpu/rlhf/buffer.py``).

Not a classic replay buffer: trajectories are consumed (at most) once,
in arrival order, and the learner BLOCKS on ``take`` until a full batch
is staged — the asynchrony lives in the fact that rollout actors keep
generating (and the poller thread keeps staging) while the learner is
inside its update step. Bounded: when generation outruns learning the
OLDEST trajectories drop first (they would be the stalest — dropping
them is the cheap half of staleness control; the version gate in
``rlhf.algorithm`` handles what the cap lets through).

Thread-safe; owns no thread of its own.
"""

from __future__ import annotations

import threading
from typing import Optional


class TrajectoryBuffer:
    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._items: list[dict] = []
        self._cv = threading.Condition()
        self._dropped = 0
        self._added = 0

    def add(self, trajs: list[dict]) -> None:
        with self._cv:
            self._items.extend(trajs)
            self._added += len(trajs)
            if len(self._items) > self.capacity:
                overflow = len(self._items) - self.capacity
                del self._items[:overflow]  # oldest = stalest
                self._dropped += overflow
            self._cv.notify_all()

    def take(self, n: int, timeout: Optional[float] = None) -> list[dict]:
        """Block until ``n`` trajectories are staged (or ``timeout``
        elapses — then returns whatever is there, possibly [])."""
        deadline = None if timeout is None else (
            threading.TIMEOUT_MAX if timeout < 0 else timeout
        )
        with self._cv:
            if deadline is not None:
                self._cv.wait_for(lambda: len(self._items) >= n, timeout=deadline)
            else:
                self._cv.wait_for(lambda: len(self._items) >= n)
            got = self._items[:n]
            del self._items[:n]
            return got

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def stats(self) -> dict:
        with self._cv:
            return {
                "staged": len(self._items),
                "added": self._added,
                "dropped_overflow": self._dropped,
            }
