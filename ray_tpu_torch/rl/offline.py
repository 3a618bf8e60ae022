"""Offline RL data: recorded experience in, SampleBatches out (copy of
``ray_tpu/rl/offline.py``).

Counterpart of the reference's offline stack (``rllib/offline/`` —
JsonReader/JsonWriter experience files, ``input_``/``output`` config keys,
DatasetReader over ray.data). Transitions are columnar numpy arrays
(obs/actions/rewards/next_obs/terminateds) stored as one ``.npz`` per shard
— the mmap-friendly, device-batchable layout — with a JSONL import path for
interoperability. JSONL columns stay float64 here; the learner casts them
to float32 on their way to its device, as ``jnp.asarray`` does.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable, Optional

import numpy as np

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.sample_batch import SampleBatch

_COLUMNS = (sb.OBS, sb.ACTIONS, sb.REWARDS, sb.NEXT_OBS, sb.TERMINATEDS)


class OfflineDataset:
    """An in-memory columnar transition store with uniform sampling."""

    def __init__(self, columns: dict, seed: Optional[int] = None):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        n = len(self.columns[sb.OBS])
        for k, v in self.columns.items():
            assert len(v) == n, f"column {k} length {len(v)} != {n}"
        self.count = n
        self._rng = np.random.default_rng(seed)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_batches(cls, batches: Iterable[SampleBatch], seed=None) -> "OfflineDataset":
        batches = list(batches)
        cols = {
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in batches[0]
            if k in _COLUMNS
        }
        return cls(cols, seed=seed)

    @classmethod
    def from_npz(cls, path_or_glob: str, seed=None) -> "OfflineDataset":
        paths = sorted(glob.glob(path_or_glob)) or [path_or_glob]
        parts = [np.load(p) for p in paths]
        cols = {
            k: np.concatenate([p[k] for p in parts]) for k in parts[0].files
        }
        return cls(cols, seed=seed)

    @classmethod
    def resolve(cls, data, seed=None) -> "OfflineDataset":
        """Accept a dataset, an .npz path/glob, or a .jsonl path (the
        algorithms' ``offline_data`` config key)."""
        if isinstance(data, cls):
            return data
        if isinstance(data, str):
            if data.endswith((".jsonl", ".json")):
                return cls.from_jsonl(data, seed=seed)
            return cls.from_npz(data, seed=seed)
        raise ValueError(
            "offline_data is required: pass an OfflineDataset or a path to "
            f".npz/.jsonl experience (got {data!r})"
        )

    @classmethod
    def from_jsonl(cls, path: str, seed=None) -> "OfflineDataset":
        """One JSON object per line with transition fields (reference:
        JsonReader's episode rows)."""
        cols: dict[str, list] = {k: [] for k in _COLUMNS}
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                for k in _COLUMNS:
                    if k in row:
                        cols[k].append(row[k])
        return cls({k: v for k, v in cols.items() if v}, seed=seed)

    # -- io ------------------------------------------------------------------

    def save_npz(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        np.savez_compressed(path, **self.columns)
        return path

    # -- access --------------------------------------------------------------

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self.count, size=batch_size)
        return SampleBatch({k: v[idx] for k, v in self.columns.items()})

    def __len__(self) -> int:
        return self.count


def record_experience(
    env_name: str,
    n_steps: int,
    policy=None,
    seed: int = 0,
) -> OfflineDataset:
    """Roll a (scripted or random) policy in ``env_name`` and return the
    transitions — the reference's ``output`` experience-writing config, as a
    function. ``policy(obs) -> action`` defaults to uniform-random."""
    from ray_tpu_torch.rl.env import SyncVectorEnv, make_env

    env = make_env(env_name)
    rng = np.random.default_rng(seed)
    cols: dict[str, list] = {k: [] for k in _COLUMNS}
    obs, _ = env.reset(seed=seed)
    for _ in range(n_steps):
        if policy is None:
            act = env.action_space.sample(rng)
        else:
            act = policy(obs)
        nxt, rew, term, trunc, _ = env.step(act)
        # raw appends only — the float32 conversion happens ONCE on the
        # whole column below, not per step inside the rollout loop
        cols[sb.OBS].append(obs)
        cols[sb.ACTIONS].append(act)
        cols[sb.REWARDS].append(rew)
        cols[sb.NEXT_OBS].append(nxt)  # envs return fresh arrays per step
        cols[sb.TERMINATEDS].append(bool(term))
        if term or trunc:
            obs, _ = env.reset()
        else:
            obs = nxt
    return OfflineDataset({
        k: np.asarray(v, np.float32) if k in (sb.OBS, sb.NEXT_OBS, sb.REWARDS)
        else np.asarray(v)
        for k, v in cols.items()
    })
