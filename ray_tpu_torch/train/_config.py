"""Run/scaling/failure/checkpoint configs (copy of
``ray_tpu/train/_config.py``).

Counterparts of the reference's ``python/ray/air/config.py``:
``ScalingConfig`` :101, ``FailureConfig`` :377, ``CheckpointConfig`` :427,
``RunConfig`` :576. A worker here is one process; with ``use_gpu`` it holds
one card (``{"GPU": 1.0}``). ``JaxConfig`` becomes ``TorchConfig``: the
backend that ``torch.distributed`` joins the workers with.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many train workers and what each one holds. ``use_gpu`` gives
    each worker one ``GPU``; the reference's ``use_tpu`` has no counterpart
    here and passing it raises."""

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None  # advisory label

    def worker_resources(self) -> dict[str, float]:
        if self.resources_per_worker is not None:
            res = dict(self.resources_per_worker)
            res.setdefault("CPU", 1.0)
            return res
        res = {"CPU": 1.0}
        if self.use_gpu:
            res["GPU"] = 1.0
        return res

    @property
    def total_resources(self) -> dict[str, float]:
        per = self.worker_resources()
        return {k: v * self.num_workers for k, v in per.items()}


@dataclasses.dataclass
class FailureConfig:
    """Trial-level retry budget (reference ``air/config.py:377``).

    ``max_failures=-1`` retries forever; 0 disables retries."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-N checkpointing policy (reference ``air/config.py:427``)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclasses.dataclass
class RunConfig:
    """Where results live + failure/checkpoint policy
    (reference ``air/config.py:576``)."""

    name: Optional[str] = None
    #: local path OR pyarrow.fs URI (``s3://…``, ``gs://…``, ``file:///…``);
    #: a URI needs pyarrow (``_storage``)
    storage_path: Optional[str] = None
    #: custom ``pyarrow.fs.FileSystem``; when set, ``storage_path`` is a
    #: path INSIDE this filesystem
    storage_filesystem: Optional[object] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    verbose: int = 1
    log_to_file: bool = False

    def resolved_storage_path(self) -> str:
        if self.storage_filesystem is not None:
            # fs-internal path (may legitimately be "" = the fs root)
            return str(self.storage_path or "")
        base = self.storage_path or os.environ.get(
            "RAY_TPU_STORAGE_PATH", os.path.expanduser("~/ray_tpu_results")
        )
        from ray_tpu_torch.train._storage import is_uri

        if is_uri(base):
            return str(base)  # URI: never abspath
        return os.path.abspath(os.path.expanduser(base))


@dataclasses.dataclass
class TorchConfig:
    """Backend config for the workers' process group (the reference's
    ``JaxConfig``; the upstream trainer's ``train/torch/config.py:47-91``).

    With ``init_distributed`` and more than one worker, every worker calls
    ``torch.distributed.init_process_group(backend)`` against rank 0's
    address. ``backend=None`` picks ``"nccl"`` when the workers hold a GPU
    and ``"gloo"`` otherwise."""

    backend: Optional[str] = None
    init_distributed: bool = False
    timeout_s: float = 1800.0

    def backend_name(self, use_gpu: bool = False) -> str:
        if self.backend is not None:
            return self.backend
        return "nccl" if use_gpu else "gloo"
