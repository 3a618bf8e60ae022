"""Replay buffers for off-policy algorithms (copy of
``ray_tpu/rl/replay_buffer.py``).

Reference: ``rllib/utils/replay_buffers/`` (ReplayBuffer,
PrioritizedEpisodeReplayBuffer). Columnar numpy ring buffers: sampling
returns a SampleBatch a learner copies to its device in one go. The same
seed draws the same indices, weights and priorities as the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO ring buffer over columnar storage."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._store: dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if not n:
            return
        if not self._store:
            for k, v in batch.items():
                self._store[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
        for k, v in batch.items():
            idx = (self._idx + np.arange(n)) % self.capacity
            self._store[k][idx] = v
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return SampleBatch({k: v[idx] for k, v in self._store.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (sum-tree-free O(n) variant — fine at
    the ≤1e6 sizes the learning tests use; reference uses a segment tree)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6, beta: float = 0.4, seed=None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        idx = (self._idx + np.arange(n)) % self.capacity
        super().add(batch)
        self._prio[idx] = self._max_prio

    def sample(self, batch_size: int) -> SampleBatch:
        p = self._prio[: self._size] ** self.alpha
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights /= weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._store.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray, prios: np.ndarray) -> None:
        prios = np.abs(prios) + 1e-6
        self._prio[idx] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))
