"""PB2: Population Based Bandits — PBT with a GP-UCB explore step (copy of
``ray_tpu/tune/pb2.py``).

Reference: ``python/ray/tune/schedulers/pb2.py`` (+ ``pb2_utils.py``) — the
reference fits a time-varying GP to (hyperparams -> reward delta) data and
selects the exploit target's new config by maximizing UCB, instead of PBT's
random 0.8x/1.2x multiply (Parker-Holder et al. 2020, "Provably Efficient
Online Hyperparameter Optimization with Population-Based Bandits").

Departure from the reference: the reference wraps GPy; here the GP is exact
and hand-rolled on numpy (RBF kernel, median-heuristic lengthscale,
standardized targets). Population sizes make N = trials x intervals tiny
(tens), so the O(N^3) solve is microseconds and needs no dependency. The
time-varying kernel is approximated by exponentially down-weighting old
observations in the noise term rather than the reference's full TV kernel —
same effect (stale windows count less) with a fraction of the machinery.

Data model: one observation per (trial, perturbation window) — x = the
hyperparameters the trial ran with during the window (normalized to [0,1]
within ``hyperparam_bounds``), y = the improvement in ``metric`` across the
window (sign-adjusted so larger is always better). ``perturb_config`` then
maximizes UCB over candidates drawn in bounds.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

_MIN_OBS_FOR_GP = 4  # below this, fall back to PBT-style random perturbation


class PB2(PopulationBasedTraining):
    """Drop-in PBT replacement: same exploit policy, bandit-driven explore.

    ``hyperparam_bounds`` maps config key -> (lower, upper); only these keys
    are optimized (others ride along unchanged). Keys whose bounds span
    >= 2 decades with a positive lower bound are modeled in log space —
    matching how learning rates are actually tuned.
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 2,
        hyperparam_bounds: Optional[dict[str, tuple[float, float]]] = None,
        quantile_fraction: float = 0.25,
        ucb_kappa: float = 1.5,
        n_candidates: int = 64,
        forget: float = 0.9,
        seed: Optional[int] = None,
    ):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds={key: (lo, hi)}")
        super().__init__(
            metric=metric,
            mode=mode,
            time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},
            quantile_fraction=quantile_fraction,
            seed=seed,
        )
        self.bounds = {k: (float(lo), float(hi)) for k, (lo, hi) in hyperparam_bounds.items()}
        self.keys = sorted(self.bounds)
        self._log_key = {
            k: (lo > 0 and hi / lo >= 100.0) for k, (lo, hi) in self.bounds.items()
        }
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self.forget = forget
        # (x in [0,1]^d, improvement, age counter at insert)
        self._X: list[list[float]] = []
        self._y: list[float] = []
        self._epoch = 0  # bumps every recorded window; drives forgetting
        self._ages: list[int] = []
        # per-trial open window: (t_start, metric_start, x vector)
        self._window: dict[Any, tuple[float, float, list[float]]] = {}

    # -- normalization -----------------------------------------------------

    def _encode(self, config: dict) -> list[float]:
        x = []
        for k in self.keys:
            lo, hi = self.bounds[k]
            v = float(config.get(k, lo))
            if self._log_key[k]:
                lo_t, hi_t, v_t = math.log(lo), math.log(hi), math.log(max(v, 1e-300))
            else:
                lo_t, hi_t, v_t = lo, hi, v
            x.append(min(1.0, max(0.0, (v_t - lo_t) / max(hi_t - lo_t, 1e-12))))
        return x

    def _decode(self, x: list[float]) -> dict:
        out = {}
        for k, u in zip(self.keys, x):
            lo, hi = self.bounds[k]
            if self._log_key[k]:
                v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
            else:
                v = lo + u * (hi - lo)
            out[k] = v
        return out

    # -- observation collection --------------------------------------------

    def on_result(self, trial, result: dict) -> str:
        decision = super().on_result(trial, result)
        v = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if v is not None:
            score = float(v) if self.mode == "max" else -float(v)  # larger = better
            win = self._window.get(trial.id)
            exploiting = decision not in (None, "CONTINUE")
            if win is None:
                self._window[trial.id] = (t, score, self._encode(trial.config))
            else:
                t0, s0, x0 = win
                # close the window at a full interval OR at an exploit
                # boundary (PBT fires EXPLOIT every `interval` steps, which
                # is one report EARLIER than t - t0 >= interval can trigger
                # for a window opened the report after the last exploit —
                # without this clause the GP never receives data)
                if (exploiting or t - t0 >= self.interval) and t > t0:
                    self._X.append(x0)
                    self._y.append((score - s0) / (t - t0))  # improvement rate
                    self._ages.append(self._epoch)
                    self._epoch += 1
                    self._window[trial.id] = (t, score, self._encode(trial.config))
            if exploiting:
                # an EXPLOIT may clone another trial's state+config; an open
                # window would straddle the clone and poison the GP data —
                # drop it and let the next report open a fresh one
                self._window.pop(trial.id, None)
        return decision

    # -- explore step -------------------------------------------------------

    def perturb_config(self, config: dict) -> dict:
        import numpy as np  # deferred: `import ray_tpu_torch.tune` must not need numpy

        out = dict(config)
        if len(self._y) < _MIN_OBS_FOR_GP:
            # PBT-style fallback: gaussian jitter in normalized space
            out.update(self._decode([
                min(1.0, max(0.0, u + self.rng.gauss(0.0, 0.2)))
                for u in self._encode(out)
            ]))
            return out
        X = np.asarray(self._X, dtype=np.float64)
        y = np.asarray(self._y, dtype=np.float64)
        ages = np.asarray(self._ages, dtype=np.float64)
        # standardize targets; exponential forgetting inflates old-sample noise
        y_mu, y_sd = float(y.mean()), float(y.std()) or 1.0
        ys = (y - y_mu) / y_sd
        staleness = (self._epoch - 1) - ages
        noise = 1e-2 / np.maximum(self.forget ** staleness, 1e-3)

        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        med = float(np.median(d2[d2 > 0])) if (d2 > 0).any() else 1.0
        ls2 = max(med, 1e-6)
        K = np.exp(-0.5 * d2 / ls2) + np.diag(noise)
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            L = np.linalg.cholesky(K + 1e-6 * np.eye(len(K)))
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, ys))

        cur = np.asarray(self._encode(out), dtype=np.float64)
        cands = [cur]
        for _ in range(self.n_candidates):
            if self.rng.random() < 0.5:  # local jitter around current
                c = np.clip(cur + np.array([self.rng.gauss(0, 0.15) for _ in self.keys]), 0, 1)
            else:  # global draw
                c = np.array([self.rng.random() for _ in self.keys])
            cands.append(c)
        C = np.stack(cands)
        kx = np.exp(-0.5 * ((C[:, None, :] - X[None, :, :]) ** 2).sum(-1) / ls2)
        mean = kx @ alpha
        v = np.linalg.solve(L, kx.T)
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        ucb = mean + self.kappa * np.sqrt(var)
        best = C[int(np.argmax(ucb))]
        out.update(self._decode([float(u) for u in best]))
        return out
