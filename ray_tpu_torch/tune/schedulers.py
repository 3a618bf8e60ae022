"""Trial schedulers: FIFO, ASHA (async successive halving), Median stopping,
and Population Based Training (copy of ``ray_tpu/tune/schedulers.py``, with
the same draws from ``random``, so a seed gives the reference's decisions).

Reference: ``python/ray/tune/schedulers/`` — ``AsyncHyperBandScheduler``
(``async_hyperband.py``), ``MedianStoppingRule``, ``PopulationBasedTraining``
(``pbt.py:221``, ``_exploit`` :865). Decisions are made per reported result:
CONTINUE / STOP / and for PBT, EXPLOIT (clone a better trial's checkpoint +
perturbed config).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_result(self, trial, result: dict) -> str:
        return CONTINUE

    def choose_exploit_source(self, trial, trials):
        return None


class AsyncHyperBandScheduler:
    """ASHA: at rungs t = grace_period * reduction_factor^k, stop trials whose
    metric falls below the top-1/reduction_factor quantile of completed rung
    records."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        max_t: int = 100,
        reduction_factor: float = 4.0,
    ):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self.grace_period, self.max_t, self.rf = grace_period, max_t, reduction_factor
        # rung value -> list of recorded metric values
        self.rungs: dict[int, list[float]] = {}
        r = grace_period
        while r < max_t:
            self.rungs[int(r)] = []
            r *= reduction_factor

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for rung in sorted(self.rungs, reverse=True):
            if t < rung:
                continue
            recorded = self.rungs[rung]
            if rung not in getattr(trial, "_rungs_hit", set()):
                trial._rungs_hit = getattr(trial, "_rungs_hit", set()) | {rung}
                recorded.append(float(v))
            if len(recorded) >= self.rf:
                cutoff = self._cutoff(recorded)
                if cutoff is not None and self._worse(float(v), cutoff):
                    decision = STOP
            break
        return decision

    def _cutoff(self, recorded: list[float]) -> Optional[float]:
        if not recorded:
            return None
        srt = sorted(recorded, reverse=(self.mode == "max"))
        k = max(1, int(len(srt) / self.rf))
        return srt[k - 1]

    def _worse(self, v: float, cutoff: float) -> bool:
        return v > cutoff if self.mode == "min" else v < cutoff

    def choose_exploit_source(self, trial, trials):
        return None


# ASHA is the common alias
ASHAScheduler = AsyncHyperBandScheduler


class MedianStoppingRule:
    """Stop a trial whose best metric is worse than the median of other
    trials' running averages at the same time step."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.histories: dict[Any, list[float]] = {}

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        v = result.get(self.metric)
        if v is None:
            return CONTINUE
        self.histories.setdefault(trial.id, []).append(float(v))
        if t < self.grace_period or len(self.histories) < self.min_samples:
            return CONTINUE
        means = [
            sum(h) / len(h) for tid, h in self.histories.items() if tid != trial.id and h
        ]
        if len(means) < self.min_samples - 1:
            return CONTINUE
        med = sorted(means)[len(means) // 2]
        mine = self.histories[trial.id]
        best = min(mine) if self.mode == "min" else max(mine)
        if (self.mode == "min" and best > med) or (self.mode == "max" and best < med):
            return STOP
        return CONTINUE

    def choose_exploit_source(self, trial, trials):
        return None


class PopulationBasedTraining:
    """PBT (reference ``schedulers/pbt.py:221``): every
    ``perturbation_interval`` steps, bottom-quantile trials clone a top-
    quantile trial's checkpoint and continue with a perturbed config.

    With ``synch=True`` (reference ``pbt.py`` ``synch``) a trial that reaches
    a perturbation point waits there, its report unacknowledged, until every
    running trial has reached it; the controller then decides for each of
    them on the scores of that point. Asynchronous PBT decides at once, on
    whatever the other trials reported last, so whether it exploits depends
    on which trial reports first."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 2,
        hyperparam_mutations: Optional[dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
        synch: bool = False,
    ):
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self.interval = perturbation_interval
        self.synch = synch
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self.last_perturb: dict[Any, int] = {}
        self.latest: dict[Any, float] = {}

    def on_result(self, trial, result: dict) -> str:
        v = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if v is not None:
            self.latest[trial.id] = float(v)
        last = self.last_perturb.get(trial.id, 0)
        if t - last >= self.interval:
            self.last_perturb[trial.id] = t
            return EXPLOIT
        return CONTINUE

    def choose_exploit_source(self, trial, trials):
        """If ``trial`` is in the bottom quantile, pick a top-quantile donor;
        else None (keep going)."""
        scored = [(tid, s) for tid, s in self.latest.items()]
        if len(scored) < 2:
            return None
        reverse = self.mode == "max"
        ranked = sorted(scored, key=lambda kv: kv[1], reverse=reverse)
        n = len(ranked)
        k = max(1, int(math.ceil(n * self.quantile)))
        top = [tid for tid, _ in ranked[:k]]
        bottom = {tid for tid, _ in ranked[-k:]}
        if trial.id not in bottom or trial.id in top:
            return None
        donor_id = self.rng.choice(top)
        if donor_id == trial.id:
            return None
        for t in trials:
            if t.id == donor_id:
                return t
        return None

    def perturb_config(self, config: dict) -> dict:
        """Explore step: multiply floats by 0.8/1.2 or resample
        (reference pbt.py explore)."""
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if self.rng.random() < self.resample_p:
                out[key] = self._resample(spec)
            else:
                cur = out[key]
                if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                    factor = self.rng.choice([0.8, 1.2])
                    out[key] = type(cur)(cur * factor) if isinstance(cur, float) else max(1, int(cur * factor))
                else:
                    out[key] = self._resample(spec)
        return out

    def _resample(self, spec):
        from ray_tpu_torch.tune.search import Domain

        if isinstance(spec, Domain):
            return spec.sample(self.rng)
        if callable(spec):
            return spec()
        if isinstance(spec, (list, tuple)):
            return self.rng.choice(list(spec))
        return spec
