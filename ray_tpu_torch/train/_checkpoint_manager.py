"""Checkpoint persistence + keep-N bookkeeping (copy of
``ray_tpu/train/_checkpoint_manager.py``).

Reference: ``python/ray/train/_internal/storage.py`` (StorageContext) +
checkpoint manager semantics of ``CheckpointConfig`` (``air/config.py:427``).
Workers report checkpoints as local dirs; the manager commits them under
``<storage>/<experiment>/<trial>/checkpoint_NNNNN`` and prunes by score/age.
With a :class:`~ray_tpu_torch.train._storage.StorageContext` the commit target is
the (possibly cloud) filesystem — local reported dirs are uploaded and the
returned handles are remote, so a dead head loses nothing.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._config import CheckpointConfig
from ray_tpu_torch.train._storage import StorageContext


class CheckpointManager:
    def __init__(
        self,
        trial_dir: str,
        config: Optional[CheckpointConfig] = None,
        storage: Optional[StorageContext] = None,
    ):
        self.trial_dir = trial_dir
        self.config = config or CheckpointConfig()
        self.storage = storage
        # (score, idx, name) — name is a local path without storage, else the
        # checkpoint's rel name under the trial's storage root
        self.committed: list[tuple[Optional[float], int, str]] = []
        self.index = 0
        if storage is None:
            os.makedirs(trial_dir, exist_ok=True)

    def _checkpoint_for(self, name: str) -> Checkpoint:
        if self.storage is None:
            return Checkpoint(name)
        if self.storage.custom_fs:
            return Checkpoint(
                self.storage._rel_to_fs_path(name), filesystem=self.storage.fs
            )
        return Checkpoint(self.storage.uri_for(name))

    def commit(self, reported: Checkpoint, metrics: dict) -> Checkpoint:
        name = f"checkpoint_{self.index:06d}"
        idx = self.index
        self.index += 1
        if self.storage is not None:
            # fresh-destination invariant (matches the local rmtree branch):
            # a re-run reusing the experiment name must not merge new files
            # into a previous run's checkpoint_NNNNNN
            self.storage.delete(name)
            with reported.as_directory() as local:
                self.storage.persist_dir(local, name)
            ckpt = self._checkpoint_for(name)
        else:
            dest = os.path.join(self.trial_dir, name)
            if os.path.abspath(reported.path) != dest:
                if os.path.exists(dest):
                    shutil.rmtree(dest)
                shutil.copytree(reported.path, dest)
            name = dest
            ckpt = Checkpoint(dest)
        ckpt.update_metadata({"metrics": _json_safe(metrics), "index": idx})
        score = None
        attr = self.config.checkpoint_score_attribute
        if attr is not None and attr in metrics:
            try:
                score = float(metrics[attr])
            except (TypeError, ValueError):
                score = None
        self.committed.append((score, idx, name))
        self._prune()
        return ckpt

    def _delete(self, name: str) -> None:
        if self.storage is not None:
            self.storage.delete(name)
        elif os.path.exists(name):
            shutil.rmtree(name, ignore_errors=True)

    def _prune(self):
        keep = self.config.num_to_keep
        if keep is None or len(self.committed) <= keep:
            return
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            victims = self.committed[: len(self.committed) - keep]  # oldest first
            self.committed = self.committed[len(self.committed) - keep:]
        else:
            # rank best-first; unscored checkpoints always rank weakest
            sign = 1.0 if self.config.checkpoint_score_order == "max" else -1.0
            ranked = sorted(
                self.committed,
                key=lambda t: (t[0] is not None, sign * t[0] if t[0] is not None else 0.0),
                reverse=True,
            )
            self.committed = ranked[:keep]
            victims = ranked[keep:]
        keep_names = {p for _, _, p in self.committed}
        for _, _, name in victims:
            if name not in keep_names:
                self._delete(name)

    def latest(self) -> Optional[Checkpoint]:
        if not self.committed:
            return None
        _, _, name = max(self.committed, key=lambda t: t[1])
        return self._checkpoint_for(name)

    def best(self) -> Optional[Checkpoint]:
        scored = [t for t in self.committed if t[0] is not None]
        if not scored:
            return self.latest()
        pick = max if self.config.checkpoint_score_order == "max" else min
        return self._checkpoint_for(pick(scored, key=lambda t: t[0])[2])


def json_safe(obj):
    """Recursively replace non-JSON-serializable values with their repr."""
    import json

    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): json_safe(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [json_safe(v) for v in obj]
        return repr(obj)


_json_safe = json_safe  # internal alias
