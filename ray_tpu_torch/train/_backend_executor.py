"""BackendExecutor: drives a worker group through one training run (copy
of ``ray_tpu/train/_backend_executor.py``).

Reference: ``python/ray/train/_internal/backend_executor.py`` — ``start``
:124 (spawn group, backend.on_start), ``start_training`` :438,
``get_with_failure_handling`` :640. The reference's ``JaxBackend`` joins its
hosts with ``jax.distributed.initialize``; ``TorchBackend`` here does what
the upstream trainer's ``_setup_torch_process_group`` does
(``train/torch/config.py:47-91``): every worker learns rank 0's address and
a free port through ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``/
``LOCAL_RANK`` and, when asked, joins ``torch.distributed``'s default
process group.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.train._config import ScalingConfig, TorchConfig
from ray_tpu_torch.train._session import TrainContext
from ray_tpu_torch.train._worker_group import WorkerGroup


class TrainingWorkerError(RuntimeError):
    def __init__(self, rank: int, cause: BaseException, tb: Optional[str]):
        super().__init__(f"worker rank={rank} failed: {cause}")
        self.rank = rank
        self.cause = cause
        self.tb = tb


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class TorchBackend:
    """Process-group bring-up across the workers."""

    def __init__(self, config: Optional[TorchConfig] = None):
        self.config = config or TorchConfig()

    def _joins(self, wg: WorkerGroup) -> bool:
        return self.config.init_distributed and wg.num_workers > 1

    def on_start(self, wg: WorkerGroup) -> None:
        # rank 0 hosts the rendezvous (the reference broadcasts its
        # coordinator address the same way)
        rank0 = wg.ranks.index(0)
        addr = wg.infos[rank0]["ip"]
        port = wg.execute_single(rank0, _free_port)
        envs = []
        for i in range(wg.num_workers):
            envs.append({
                "RAY_TRAIN_COORDINATOR_ADDRESS": f"{addr}:{port}",
                "RAY_TRAIN_NUM_PROCESSES": str(wg.num_workers),
                "RAY_TRAIN_PROCESS_ID": str(wg.ranks[i]),
                "MASTER_ADDR": addr,
                "MASTER_PORT": str(port),
                "RANK": str(wg.ranks[i]),
                "WORLD_SIZE": str(wg.num_workers),
                "LOCAL_RANK": str(wg.local_ranks[i]),
            })
        wg.set_env(envs)
        if self._joins(wg):
            use_gpu = wg.resources_per_worker.get("GPU", 0) > 0
            wg.execute(_torch_distributed_init, self.config.backend_name(use_gpu),
                       self.config.timeout_s)

    def on_shutdown(self, wg: WorkerGroup) -> None:
        if self._joins(wg):
            try:
                wg.execute(_torch_distributed_shutdown)
            except Exception:
                pass


def _torch_distributed_init(backend: str, timeout_s: float) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _torch_distributed_shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class BackendExecutor:
    def __init__(
        self,
        scaling: ScalingConfig,
        backend: Optional[TorchBackend] = None,
        experiment_name: str = "train",
        trial_name: str = "trial",
    ):
        self.scaling = scaling
        self.backend = backend or TorchBackend()
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.wg: Optional[WorkerGroup] = None

    def start(self) -> None:
        self.wg = WorkerGroup(
            self.scaling.num_workers,
            self.scaling.worker_resources(),
            self.scaling.placement_strategy,
        )
        self.backend.on_start(self.wg)

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[dict],
        checkpoint,
        dataset_splitter: Optional[Callable[[int, int], dict]] = None,
    ) -> None:
        assert self.wg is not None
        calls = []
        for i, w in enumerate(self.wg.workers):
            ctx: TrainContext = self.wg.context_for(i, self.experiment_name, self.trial_name)
            shards = dataset_splitter(ctx.world_rank, ctx.world_size) if dataset_splitter else None
            calls.append(w.start_training.remote(train_fn, config, ctx, checkpoint, shards))
        try:
            ray_tpu_torch.get(calls)
        except Exception as e:
            # a worker can die before even acking start (instant user crash)
            raise TrainingWorkerError(-1, e, None) from e

    def next_results(self, done_mask=None, timeout_per_wait: float = 10.0, deadline_s: float = 3600.0):
        """One event from every not-yet-done worker (lockstep; reference
        ``get_with_failure_handling``). Long-lived ``next_result`` futures
        are consumed in completion order via ``ray_tpu_torch.wait`` — one
        in-flight call per worker instead of a 1 Hz poll per worker.
        Returns list of events (None for workers already done); raises
        TrainingWorkerError on worker failure, TimeoutError past
        ``deadline_s`` (guards against unequal report counts across
        workers deadlocking the loop)."""
        import time as _time

        assert self.wg is not None
        events: list = [None] * len(self.wg.workers)
        pending = {
            i for i in range(len(self.wg.workers)) if not (done_mask and done_mask[i])
        }
        futures: dict = {}  # future -> worker index
        deadline = _time.monotonic() + deadline_s
        while pending:
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"train workers {sorted(pending)} produced no result for "
                    f"{deadline_s}s — check that every worker calls "
                    f"ray_tpu_torch.train.report() the same number of times"
                )
            inflight = set(futures.values())
            for i in sorted(pending - inflight):
                futures[self.wg.workers[i].next_result.remote(timeout_per_wait)] = i
            ready, _ = ray_tpu_torch.wait(list(futures), num_returns=1, timeout=5.0)
            if not ready:
                continue
            fut = ready[0]
            i = futures.pop(fut)
            try:
                ev = ray_tpu_torch.get(fut)
            except Exception as e:  # actor died
                raise TrainingWorkerError(self.wg.ranks[i], e, None) from e
            if ev is None:
                continue  # worker had nothing within timeout_per_wait; re-arm
            if ev[0] == "error":
                raise TrainingWorkerError(self.wg.ranks[i], ev[1], ev[2])
            events[i] = ev
            pending.discard(i)
        return events

    def shutdown(self):
        if self.wg is not None:
            try:
                self.backend.on_shutdown(self.wg)
            finally:
                self.wg.shutdown()
                self.wg = None
