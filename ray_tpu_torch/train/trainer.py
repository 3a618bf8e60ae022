"""Trainers: TorchTrainer / DataParallelTrainer (copy of
``ray_tpu/train/trainer.py``; its ``JaxTrainer`` is ``TorchTrainer`` here).

Reference shape: ``python/ray/train/data_parallel_trainer.py:432``
(``training_loop`` drives BackendExecutor + forwards ``session.report``
results) and ``base_trainer.py:581`` (``fit``). Failure semantics follow
``FailureConfig(max_failures)``: on a worker failure the whole group is torn
down and relaunched from the latest committed checkpoint (a lost worker
breaks the group's process group, so the group restarts as a whole).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._backend_executor import (
    BackendExecutor,
    TorchBackend,
    TrainingWorkerError,
)
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._checkpoint_manager import CheckpointManager
from ray_tpu_torch.train._config import (
    CheckpointConfig,
    FailureConfig,
    TorchConfig,
    RunConfig,
    ScalingConfig,
)


@dataclasses.dataclass
class Result:
    """Reference: ``ray.air.Result``."""

    metrics: Optional[dict]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None

    @property
    def best_checkpoints(self):
        return [(self.checkpoint, self.metrics)] if self.checkpoint else []


class DataParallelTrainer:
    """Runs ``train_loop_per_worker`` on N workers (hosts) in lockstep."""

    _backend_cls = TorchBackend

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict] = None,
        backend_config: Optional[TorchConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[dict] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.backend_config = backend_config
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}

    # ------------------------------------------------------------------ fit

    def fit(self) -> Result:
        from ray_tpu_torch.train import _storage as storage_mod
        from ray_tpu_torch.train._storage import StorageContext

        run_name = self.run_config.name or f"{type(self).__name__}_{int(time.time())}"
        storage_path = self.run_config.resolved_storage_path()
        storage_fs = self.run_config.storage_filesystem
        # URI / custom-fs storage persists through pyarrow.fs (reference:
        # StorageContext, train/_internal/storage.py); plain local paths keep
        # the direct-directory layout
        use_storage = storage_fs is not None or storage_mod.is_uri(storage_path)
        if use_storage:
            storage = StorageContext(
                storage_path, run_name, "trial_0", storage_filesystem=storage_fs
            )
            trial_dir = os.path.join(
                os.path.expanduser("~/ray_tpu_results"), "_staging", run_name, "trial_0"
            )
            result_path = storage.uri_for("")
        else:
            storage = None
            exp_dir = os.path.join(storage_path, run_name)
            trial_dir = os.path.join(exp_dir, "trial_0")
            result_path = trial_dir
        os.makedirs(trial_dir, exist_ok=True)
        failure = self.run_config.failure_config or FailureConfig()
        ckpt_cfg = self.run_config.checkpoint_config or CheckpointConfig()
        manager = CheckpointManager(trial_dir, ckpt_cfg, storage=storage)

        failures_left = failure.max_failures
        start_ckpt = self.resume_from_checkpoint
        last_metrics: Optional[dict] = None
        history: list = []
        error: Optional[BaseException] = None

        while True:
            executor = BackendExecutor(
                self.scaling_config,
                self._backend_cls(self.backend_config),
                experiment_name=run_name,
            )
            try:
                executor.start()
                executor.start_training(
                    self.train_loop_per_worker,
                    self.train_loop_config,
                    manager.latest() or start_ckpt,
                    self._dataset_splitter(),
                )
                # history is shared so results committed before a mid-run
                # worker failure survive the restart
                last_metrics = self._result_loop(executor, manager, history)
                error = None
                break
            except TrainingWorkerError as e:
                history_error = e
                if failures_left == 0:
                    error = e
                    break
                if failures_left > 0:
                    failures_left -= 1
                if self.run_config.verbose:
                    print(
                        f"[ray_tpu_torch.train] worker failure ({history_error}); restarting "
                        f"group from {manager.latest()} "
                        f"({failures_left if failures_left >= 0 else 'inf'} retries left)"
                    )
            finally:
                executor.shutdown()

        result = Result(
            metrics=last_metrics,
            checkpoint=manager.best(),
            path=result_path,
            error=error,
            metrics_history=history,
        )
        if error is not None and not isinstance(error, TrainingWorkerError):
            raise error
        return result

    def _result_loop(self, executor: BackendExecutor, manager: CheckpointManager, history: list):
        """Consume lockstep events until every worker's loop returns."""
        last_metrics = None
        done = [False] * self.scaling_config.num_workers
        rank0 = executor.wg.ranks.index(0)  # worker index holding world rank 0
        while not all(done):
            events = executor.next_results(done_mask=done)
            report_metrics = None
            report_ckpt = None
            for i, ev in enumerate(events):
                if ev is None:
                    continue
                kind = ev[0]
                if kind == "done":
                    done[i] = True
                elif kind == "result":
                    _, metrics, ckpt = ev
                    if i == rank0 or report_metrics is None:
                        report_metrics = metrics
                    if ckpt is not None and (i == rank0 or report_ckpt is None):
                        report_ckpt = ckpt  # rank-0's checkpoint wins
            if report_metrics is not None:
                committed = None
                if report_ckpt is not None:
                    committed = manager.commit(report_ckpt, report_metrics)
                last_metrics = report_metrics
                history.append({"metrics": report_metrics, "checkpoint": committed})
            # ack unblocks the workers' report() only after the commit above
            import ray_tpu_torch

            acks = [
                executor.wg.workers[i].ack_result.remote()
                for i, ev in enumerate(events)
                if ev is not None and ev[0] == "result"
            ]
            if acks:
                try:
                    ray_tpu_torch.get(acks)
                except Exception as e:
                    from ray_tpu_torch.train._backend_executor import TrainingWorkerError

                    raise TrainingWorkerError(-1, e, None) from e
        return last_metrics

    def _dataset_splitter(self) -> Optional[Callable[[int, int], dict]]:
        if not self.datasets:
            return None
        datasets = self.datasets
        # a Dataset is split once per world size, not once per rank: each
        # ``split`` executes the plan, and two executions of an unseeded
        # shuffle would hand the ranks overlapping shares
        splits: dict = {}

        def split(rank: int, world: int) -> dict:
            shards = {}
            for name, ds in datasets.items():
                if hasattr(ds, "streaming_split_shard"):
                    shards[name] = ds.streaming_split_shard(rank, world)
                elif hasattr(ds, "split"):
                    if (name, world) not in splits:
                        splits[(name, world)] = ds.split(world)
                    shards[name] = splits[(name, world)][rank]
                else:
                    shards[name] = _IterShard(ds, rank, world)
            return shards

        return split

    def as_trainable(self):
        """Adapter so a trainer runs as a Tune trainable (reference:
        ``ray_tpu/train/trainer.py:221``; BaseTrainer.fit wraps itself in a
        1-trial Tune run, ``base_trainer.py:581-645``; we invert — Tune wraps
        the trainer). The trial's config is merged over
        ``train_loop_config``, the trainer runs inside the trial, and its
        final metrics are the trial's one report. The trial takes no GPU of
        its own: the trainer's workers hold theirs."""
        trainer = self

        def trainable(config):
            from ray_tpu_torch import tune

            merged = dict(trainer.train_loop_config or {})
            merged.update(config or {})
            t = type(trainer)(
                trainer.train_loop_per_worker,
                train_loop_config=merged,
                scaling_config=trainer.scaling_config,
                run_config=trainer.run_config,
                datasets=trainer.datasets,
                backend_config=trainer.backend_config,
            )
            result = t.fit()
            if result.metrics:
                tune.report(result.metrics)

        return trainable


class _IterShard:
    """Round-robin shard over a plain iterable (lists, generators-factories)."""

    def __init__(self, data, rank: int, world: int):
        self.data = data
        self.rank = rank
        self.world = world

    def __iter__(self):
        for i, item in enumerate(self.data):
            if i % self.world == self.rank:
                yield item

    def iter_batches(self, batch_size: int = 32):
        batch = []
        for item in self:
            batch.append(item)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


class TorchTrainer(DataParallelTrainer):
    """The flagship trainer (the reference's ``JaxTrainer``): each worker
    runs ``train_loop_per_worker``; with ``ScalingConfig(use_gpu=True)`` each
    holds one card. The train loop typically:

        init_fn, step_fn = build_train_step(loss, adamw(lr))
        state = init_fn(model)                       # on the worker's card
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = train.load_state(ckpt, state)    # resume
        for batch in train.get_dataset_shard("train"):
            state, loss = step_fn(state, batch.cuda())
            train.report({"loss": loss.item()},
                         checkpoint=train.save_state(state, tempfile.mkdtemp()))

    With ``TorchConfig(init_distributed=True)`` and several workers, the
    loop runs inside one ``torch.distributed`` process group.
    """

