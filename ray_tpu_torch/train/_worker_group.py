"""WorkerGroup: the N train-worker actors (copy of
``ray_tpu/train/_worker_group.py``).

Reference: ``python/ray/train/_internal/worker_group.py:102`` (actor group)
+ ``backend_executor.py:358`` (rank/world-size env). A train worker is one
process, placed in a placement group bundle of its resources. The runtime
counts ``GPU`` but gives no task or actor a card index of its own, so a
worker holding ``GPU`` is bound here: before it touches CUDA, its
``CUDA_VISIBLE_DEVICES`` is narrowed to its share of the node's cards, by
its local rank (``bind_cards``). A train loop that calls
``device.resolve_device()`` then lands on that card, and no two workers of
the group on one node share one. Ranks are process ranks.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.train._session import TrainContext, _TrainSession


class RayTrainWorker:
    """Actor body. Holds the running train session for this worker."""

    def __init__(self):
        self.session: Optional[_TrainSession] = None

    def node_info(self) -> dict:
        import ray_tpu_torch as rt

        ctx = rt.get_runtime_context()
        try:
            ip = socket.gethostbyname(socket.gethostname())
        except OSError:
            ip = "127.0.0.1"
        return {
            "node_id": ctx.get_node_id(),
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "ip": ip,
        }

    def set_env(self, env: dict[str, str]) -> None:
        os.environ.update(env)

    def bind_cards(self, local_rank: int, gpus: float) -> Optional[str]:
        """Narrow ``CUDA_VISIBLE_DEVICES`` to this worker's share of the
        node's cards, by local rank (``accelerators.gpu.bind_cards``)."""
        from ray_tpu_torch.accelerators import gpu

        return gpu.bind_cards(local_rank, gpus, "train worker")

    def execute(self, fn: Callable, *args, **kwargs) -> Any:
        """Run an arbitrary function in the worker process (reference:
        WorkerGroup.execute)."""
        return fn(*args, **kwargs)

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[dict],
        context: TrainContext,
        checkpoint,
        dataset_shards: Optional[dict],
    ) -> bool:
        assert self.session is None or self.session.finished, "training already running"
        self.session = _TrainSession(train_fn, config, context, checkpoint, dataset_shards)
        self.session.start()
        return True

    def next_result(self, timeout: float = 1.0):
        """One session event or None: ('result', metrics, ckpt) |
        ('done', ret, None) | ('error', exc, tb)."""
        if self.session is None:
            return ("error", RuntimeError("no session"), None)
        ev = self.session.next(timeout=timeout)
        if ev is not None and ev[0] in ("done", "error"):
            self.session.finished = True
        return ev

    def ack_result(self) -> bool:
        """The trainer committed the last reported result; unblock report()."""
        if self.session is not None:
            self.session.ack_event.set()
        return True

    def shutdown(self) -> bool:
        return True


class WorkerGroup:
    """Spawns and addresses the worker actors."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: dict[str, float],
        placement_strategy: str = "PACK",
    ):
        from ray_tpu_torch.util.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        if resources_per_worker.get("GPU", 0) > 0 and not ray_tpu_torch.cluster_resources().get("GPU"):
            # as the runtime refuses a GPU task or actor: at once, never on the CPU
            raise RuntimeError(
                f"train workers require {dict(resources_per_worker)}, but no node of this "
                "cluster has a GPU (GPU: 0)"
            )
        self.pg = placement_group([dict(resources_per_worker)] * num_workers, strategy=placement_strategy)
        self.pg.wait(timeout_seconds=60.0)
        cls = ray_tpu_torch.remote(num_cpus=0, max_restarts=0)(RayTrainWorker)
        self.workers = [
            cls.options(
                resources={k: v for k, v in resources_per_worker.items()},
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    self.pg, placement_group_bundle_index=i
                ),
            ).remote()
            for i in range(num_workers)
        ]
        infos = ray_tpu_torch.get([w.node_info.remote() for w in self.workers])
        # Host ranks: stable sort by (node, pid); local ranks count within node.
        order = sorted(range(num_workers), key=lambda i: (infos[i]["node_id"], infos[i]["pid"]))
        self.ranks = [0] * num_workers
        for rank, idx in enumerate(order):
            self.ranks[idx] = rank
        self.infos = infos
        self.local_ranks = [0] * num_workers
        self.node_ranks = [0] * num_workers
        per_node: dict[str, int] = {}
        node_idx: dict[str, int] = {}
        for rank, idx in enumerate(order):
            nid = infos[idx]["node_id"]
            if nid not in node_idx:
                node_idx[nid] = len(node_idx)
            self.local_ranks[idx] = per_node.get(nid, 0)
            per_node[nid] = per_node.get(nid, 0) + 1
            self.node_ranks[idx] = node_idx[nid]
        self.local_world_sizes = [per_node[infos[i]["node_id"]] for i in range(num_workers)]
        gpus = float(resources_per_worker.get("GPU", 0))
        if gpus > 0:
            ray_tpu_torch.get(
                [w.bind_cards.remote(self.local_ranks[i], gpus) for i, w in enumerate(self.workers)]
            )

    def context_for(self, i: int, experiment: str = "train", trial: str = "trial") -> TrainContext:
        return TrainContext(
            world_size=self.num_workers,
            world_rank=self.ranks[i],
            local_rank=self.local_ranks[i],
            local_world_size=self.local_world_sizes[i],
            node_rank=self.node_ranks[i],
            experiment_name=experiment,
            trial_name=trial,
        )

    def execute(self, fn: Callable, *args, **kwargs) -> list:
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs) for w in self.workers])

    def execute_single(self, i: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(self.workers[i].execute.remote(fn, *args, **kwargs))

    def set_env(self, envs: "list[dict[str, str]]") -> None:
        ray_tpu_torch.get([w.set_env.remote(e) for w, e in zip(self.workers, envs)])

    def shutdown(self):
        from ray_tpu_torch._private.log_util import warn_throttled

        try:
            ray_tpu_torch.get([w.shutdown.remote() for w in self.workers], timeout=5.0)
        except Exception:
            pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception as e:
                # best-effort teardown, but not silent: a kill that fails for
                # any reason other than "already dead" means leaked workers
                warn_throttled("train worker group teardown", e)
        from ray_tpu_torch.util.placement_group import remove_placement_group

        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
