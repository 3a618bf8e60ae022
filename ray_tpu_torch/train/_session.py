"""Per-worker training session (copy of ``ray_tpu/train/_session.py``).

Reference: ``python/ray/train/_internal/session.py`` — the user's
``train_loop_per_worker`` runs on a side thread inside each train worker;
``report(metrics, checkpoint)`` (:394, public :654) hands results to the
trainer, ``get_checkpoint`` (:741) exposes the restore point,
``get_dataset_shard`` (:1047) the per-worker data iterator.

The session queue is bounded at 1: ``report`` blocks until the trainer has
consumed the previous result, keeping all workers in lockstep the way the
reference's backend executor does.
"""

from __future__ import annotations

import dataclasses
import inspect
import queue
import threading
from typing import Any, Callable, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint


@dataclasses.dataclass
class TrainContext:
    world_size: int
    world_rank: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str = "train"
    trial_name: str = "trial"
    trial_id: str = "0"

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id


class _TrainSession:
    def __init__(
        self,
        train_fn: Callable,
        config: Optional[dict],
        context: TrainContext,
        checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[dict] = None,
    ):
        self.train_fn = train_fn
        self.config = config or {}
        self.context = context
        self.checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.out: "queue.Queue" = queue.Queue(maxsize=1)
        self.ack_event = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.finished = False

    def start(self):
        self.thread = threading.Thread(target=self._run, name="train-loop", daemon=True)
        self.thread.start()

    def _run(self):
        global _session
        _session = self
        try:
            sig = inspect.signature(self.train_fn)
            if len(sig.parameters) >= 1:
                ret = self.train_fn(self.config)
            else:
                ret = self.train_fn()
            self.out.put(("done", ret, None))
        except BaseException as e:  # noqa: BLE001 — crosses to the trainer
            import traceback

            self.out.put(("error", e, traceback.format_exc()))
        finally:
            _session = None

    def report(self, metrics: dict, checkpoint: Optional[Checkpoint] = None):
        """Blocks until the trainer has consumed AND committed this result
        (ack roundtrip) — a crash after report() can never lose a reported
        checkpoint, matching the reference's synchronous checkpoint upload."""
        self.ack_event.clear()
        self.out.put(("result", metrics, checkpoint))
        self.ack_event.wait()

    def next(self, timeout: Optional[float] = None):
        """Called by the worker actor: next event or None on timeout."""
        try:
            return self.out.get(timeout=timeout)
        except queue.Empty:
            return None


_session: Optional[_TrainSession] = None


def _get_session(ok_if_missing: bool = False) -> Optional[_TrainSession]:
    if _session is None and not ok_if_missing:
        raise RuntimeError(
            "No train session active. ray_tpu_torch.train.report()/get_context() "
            "must be called inside train_loop_per_worker."
        )
    return _session


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optional checkpoint) to the trainer
    (reference ``session.py:654``)."""
    _get_session().report(dict(metrics), checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """Latest committed checkpoint to resume from (reference
    ``session.py:741``)."""
    s = _get_session(ok_if_missing=True)
    return s.checkpoint if s else None


def get_context() -> TrainContext:
    s = _get_session(ok_if_missing=True)
    if s is None:
        return TrainContext(1, 0, 0, 1, 0)
    return s.context


def get_dataset_shard(dataset_name: str = "train"):
    """Per-worker shard of a dataset passed to the trainer (reference
    ``session.py:1047`` backed by Ray Data streaming_split)."""
    s = _get_session()
    shard = s.dataset_shards.get(dataset_name)
    if shard is None:
        raise KeyError(
            f"No dataset shard named {dataset_name!r}; pass datasets={{...}} to the trainer"
        )
    return shard
