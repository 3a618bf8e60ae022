"""SampleBatch: columnar rollout storage + GAE (copy of
``ray_tpu/rl/sample_batch.py``).

Reference: ``rllib/policy/sample_batch.py`` (dict of stacked arrays with
OBS/ACTIONS/REWARDS/... keys, concat/slice/shuffle) and
``rllib/evaluation/postprocessing.py`` (compute_advantages, GAE). Kept as
plain numpy on the host; learners copy whole minibatches to their device.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
LOGP = "logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
NEXT_OBS = "next_obs"


class SampleBatch(dict):
    """dict[str, np.ndarray] with aligned first dimension."""

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat(batches: list["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b and b.count]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({k: np.concatenate([b[k] for b in batches]) for k in keys})

    def shuffle(self, rng: Optional[np.random.Generator] = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int, rng=None) -> Iterator["SampleBatch"]:
        b = self.shuffle(rng)
        n = b.count
        for s in range(0, n - size + 1, size):
            yield SampleBatch({k: v[s : s + size] for k, v in b.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})


def compute_gae(
    rewards: np.ndarray,
    values: np.ndarray,
    terminateds: np.ndarray,
    truncateds: np.ndarray,
    last_values: np.ndarray,
    gamma: float = 0.99,
    lam: float = 0.95,
    truncation_values: Optional[np.ndarray] = None,
):
    """Generalized advantage estimation over (T, N) rollout arrays.

    Matches the reference's GAE (``postprocessing.py compute_advantages``):
    at a TERMINATED step the bootstrap value is 0; at a TRUNCATED step the
    trajectory is cut but bootstrapped with the critic's value of the TRUE
    next state — pass ``truncation_values`` (T, N), the critic's value of
    each step's pre-reset final obs, to supply it (EnvRunner.sample does);
    without it the stored value of the reset obs is the fallback
    approximation.
    Returns (advantages, value_targets), both (T, N) float32.
    """
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_values = np.concatenate([values[1:], last_values[None]], axis=0)
    for t in range(T - 1, -1, -1):
        nv = next_values[t]
        if truncation_values is not None:
            nv = np.where(truncateds[t], truncation_values[t], nv)
        nv = np.where(terminateds[t], 0.0, nv)
        delta = rewards[t] + gamma * nv - values[t]
        # Cut the GAE recursion at ANY episode boundary (term or trunc).
        boundary = terminateds[t] | truncateds[t]
        last_gae = delta + gamma * lam * np.where(boundary, 0.0, last_gae)
        adv[t] = last_gae
    targets = adv + values
    return adv.astype(np.float32), targets.astype(np.float32)
