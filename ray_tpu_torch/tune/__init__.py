"""ray_tpu_torch.tune — hyperparameter search over trial actors (copy of
``ray_tpu/tune/``, over the port's runtime and ``train``).

Reference surface (``python/ray/tune/``): ``Tuner.fit`` (``tuner.py:347``) /
``tune.run`` (``tune.py:233``) driving a controller event loop
(``execution/tune_controller.py``); search spaces; schedulers (ASHA, PBT,
median-stopping); per-trial checkpointing; experiment state snapshots.

``tune.report`` / ``tune.get_checkpoint`` are the same session functions as
``ray_tpu_torch.train`` — a trainable is a train loop with one implicit worker.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train._config import CheckpointConfig, FailureConfig, RunConfig
from ray_tpu_torch.train._session import get_checkpoint, get_context, report  # noqa: F401
from ray_tpu_torch.train.trainer import Result
from ray_tpu_torch.tune.controller import ERROR, TERMINATED, TuneController
from ray_tpu_torch.tune.registry import register_trainable, resolve_trainable  # noqa: F401
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.searcher import (  # noqa: F401
    ConcurrencyLimiter,
    RandomSearcher,
    Searcher,
    TPESearcher,
)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.pb2 import PB2  # noqa: F401

# OptunaSearcher lives in ray_tpu_torch.tune.optuna_adapter; not imported eagerly
# here so `import ray_tpu_torch.tune` never requires optuna.


@dataclasses.dataclass
class TuneConfig:
    """Reference: ``tune/tune_config.py``."""

    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 8
    scheduler: Any = None
    search_alg: Any = None
    seed: Optional[int] = None


class ResultGrid:
    """Reference: ``tune/result_grid.py``."""

    def __init__(self, results: list[Result], metric=None, mode="min"):
        self._results = results
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("pass metric= (or set TuneConfig.metric)")
        scored = [r for r in self._results if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        pick = min if mode == "min" else max
        return pick(scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self._results if r.metrics])


class Tuner:
    """Reference: ``tune/tuner.py:347``."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[dict] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        if isinstance(trainable, str):  # "PPO" etc. (reference: tune registry)
            from ray_tpu_torch.tune.registry import resolve_trainable

            trainable = resolve_trainable(trainable)
        resources = getattr(trainable, "_tune_resources", None)
        if hasattr(trainable, "as_trainable"):  # a Trainer instance
            trainable = trainable.as_trainable()
            if resources is not None:  # carry with_resources() across the wrap
                trainable._tune_resources = resources
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.train import _storage as storage_mod
        from ray_tpu_torch.train._storage import StorageContext

        cfg = self.tune_config
        name = self.run_config.name or f"tune_{int(time.time())}"
        storage_path = self.run_config.resolved_storage_path()
        storage_fs = self.run_config.storage_filesystem
        if storage_fs is not None or storage_mod.is_uri(storage_path):
            # cloud/URI persistence via pyarrow.fs: trial dirs stay local
            # staging, checkpoints + experiment state ride the StorageContext
            storage = StorageContext(storage_path, name, storage_filesystem=storage_fs)
            exp_dir = os.path.join(
                os.path.expanduser("~/ray_tpu_results"), "_staging", name
            )
        else:
            storage = None
            exp_dir = os.path.join(storage_path, name)
        searcher = None
        configs: list[dict] = []
        if cfg.search_alg is not None and hasattr(cfg.search_alg, "suggest"):
            # sequential Searcher plugin (reference: search_alg=OptunaSearch())
            searcher = cfg.search_alg
            searcher.set_search_properties(cfg.metric, cfg.mode, self.param_space)
        else:
            gen = cfg.search_alg or BasicVariantGenerator(seed=cfg.seed)
            configs = gen.generate(self.param_space, num_samples=cfg.num_samples)
        resources = getattr(self.trainable, "_tune_resources", None)
        controller = TuneController(
            self.trainable,
            configs,
            exp_dir,
            scheduler=cfg.scheduler,
            metric=cfg.metric,
            mode=cfg.mode,
            max_concurrent=cfg.max_concurrent_trials,
            resources_per_trial=resources,
            failure_config=self.run_config.failure_config,
            checkpoint_config=self.run_config.checkpoint_config,
            verbose=self.run_config.verbose > 1,
            searcher=searcher,
            num_samples=cfg.num_samples,
            storage=storage,
        )
        trials = controller.run()
        results = []
        for t in trials:
            # with cloud storage, point users at the durable location — the
            # staging dir is throwaway and dies with the head
            t_storage = t.ckpt_manager.storage
            results.append(
                Result(
                    metrics=t.last_result,
                    checkpoint=t.ckpt_manager.best(),
                    path=t_storage.uri_for("") if t_storage is not None else t.dir,
                    error=t.error,
                    metrics_history=t.results,
                )
            )
        return ResultGrid(results, metric=cfg.metric, mode=cfg.mode)


def with_resources(trainable: Callable, resources: dict[str, float]) -> Callable:
    """Attach per-trial resources (reference ``tune.with_resources``)."""
    trainable._tune_resources = dict(resources)
    return trainable


def run(
    trainable: Callable,
    *,
    config: Optional[dict] = None,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "min",
    scheduler=None,
    storage_path: Optional[str] = None,
    name: Optional[str] = None,
    max_concurrent_trials: int = 8,
    verbose: int = 1,
) -> ResultGrid:
    """Classic ``tune.run`` API (reference ``tune/tune.py:233``)."""
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            max_concurrent_trials=max_concurrent_trials,
        ),
        run_config=RunConfig(name=name, storage_path=storage_path, verbose=verbose),
    )
    return tuner.fit()
