"""Optuna adapter for the Searcher plugin API (copy of
``ray_tpu/tune/optuna_adapter.py``).

Reference: ``python/ray/tune/search/optuna/optuna_search.py`` — the reference
drives Optuna through its ask/tell interface (``OptunaSearch.suggest`` ->
``study.ask``, ``on_trial_complete`` -> ``study.tell``), translating Tune
sample domains into Optuna distributions. Same shape here, against our
``ray_tpu_torch.tune.search`` domains.

Optuna is an optional dependency: importing this module is safe without it;
constructing ``OptunaSearcher`` raises ImportError with install guidance.
Only final values reach Optuna (``on_trial_complete`` -> ``study.tell``);
Optuna pruners are not wired — our schedulers own early stopping, matching
the division of labor in the reference.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from ray_tpu_torch.tune.search import (
    Categorical,
    Domain,
    Float,
    GridSearch,
    Integer,
    Quantized,
    _set_path,
    _walk,
)
from ray_tpu_torch.tune.searcher import Searcher


def _optuna():
    try:
        import optuna
    except ImportError as e:  # pragma: no cover - exercised only without optuna
        raise ImportError(
            "OptunaSearcher requires `optuna`. It is not bundled with ray_tpu; "
            "install it in the driver environment (pip install optuna)."
        ) from e
    return optuna


class OptunaSearcher(Searcher):
    """Sequential searcher backed by an Optuna study (TPE by default).

    ``sampler`` accepts any ``optuna.samplers.BaseSampler``; ``seed`` seeds
    the default TPESampler. Nested search-space paths are flattened to
    ``a/b/c`` parameter names for Optuna and unflattened on the way out.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        sampler: Any = None,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self._optuna = _optuna()
        self._sampler = sampler
        self._seed = seed
        self._study = None
        self._trials: dict[str, Any] = {}  # our trial_id -> optuna trial
        self._rng = random.Random(seed)

    def _ensure_study(self):
        if self._study is None:
            opt = self._optuna
            sampler = self._sampler or opt.samplers.TPESampler(seed=self._seed)
            direction = "maximize" if self.resolved_mode == "max" else "minimize"
            opt.logging.set_verbosity(opt.logging.WARNING)
            self._study = opt.create_study(direction=direction, sampler=sampler)
        return self._study

    # -- domain translation -------------------------------------------------

    def _distributions(self):
        """(flat-name -> optuna distribution, passthrough leaves)."""
        opt = self._optuna
        dists: dict[str, Any] = {}
        passthrough: list[tuple[tuple, Any]] = []
        for path, v in _walk(self._space or {}):
            name = "/".join(path)
            if isinstance(v, Float):
                dists[name] = opt.distributions.FloatDistribution(v.lower, v.upper, log=v.log)
            elif isinstance(v, Quantized) and isinstance(v.inner, Float) and not v.inner.log:
                # optuna forbids log=True together with step; log-quantized
                # domains fall through to passthrough sampling below
                dists[name] = opt.distributions.FloatDistribution(
                    v.inner.lower, v.inner.upper, step=v.q
                )
            elif isinstance(v, Integer):
                # our Integer samples randrange(lower, upper) — exclusive upper;
                # optuna's IntDistribution is inclusive
                dists[name] = opt.distributions.IntDistribution(v.lower, v.upper - 1)
            elif isinstance(v, Categorical):
                dists[name] = opt.distributions.CategoricalDistribution(v.categories)
            elif isinstance(v, GridSearch) or (isinstance(v, dict) and "grid_search" in v):
                raise ValueError("grid_search is not supported by OptunaSearcher")
            else:
                # constants, sample_from, and any Domain optuna can't model
                # (sampled from our own prior, outside the study)
                passthrough.append((path, v))
        return dists, passthrough

    # -- Searcher interface --------------------------------------------------

    def suggest(self, trial_id: str):
        if self._space is None:
            raise RuntimeError("set_search_properties was never called")
        study = self._ensure_study()
        dists, passthrough = self._distributions()
        ot = study.ask(dists)
        self._trials[trial_id] = ot
        cfg: dict = {}
        for name, val in ot.params.items():
            _set_path(cfg, tuple(name.split("/")), val)
        for path, v in passthrough:
            _set_path(cfg, path, v.sample(self._rng) if isinstance(v, Domain) else v)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        opt = self._optuna
        study = self._ensure_study()
        if error or not result or self.metric not in result:
            study.tell(ot, state=opt.trial.TrialState.FAIL)
        else:
            study.tell(ot, float(result[self.metric]))
