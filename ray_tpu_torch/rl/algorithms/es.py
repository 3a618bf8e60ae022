"""ES — evolution strategies (ARS variant): gradient-free policy search
(port of ``ray_tpu/rl/algorithms/es.py``).

Reference: ``rllib/algorithms/es/`` (Salimans et al. 2017 OpenAI-ES) and
``rllib/algorithms/ars/`` (Mania et al. 2018 Augmented Random Search).
Implemented as the ARS formulation — antithetic (+/-sigma) perturbation
pairs, top-fraction direction selection, reward-std step normalization —
which subsumes plain ES at ``top_frac=1.0``.

There is no backward pass: the "training" is episode evaluations, fanned
over env-runner ACTORS as perturbed-weight rollouts (each direction is two
independent ``eval_return`` calls; the only synchronization is the
rank-and-update reduction at the end of the iteration, on the driver).

The search vector ``theta`` (float64, on the host) is the runner module's
parameters flattened in ``jax.flatten_util.ravel_pytree``'s order of the
reference's tree (``learner.ravel_names``: dict keys sorted, each layer's
``"b"`` before its ``"w"``), so the same ``default_rng`` seed perturbs the
same weights as the reference; it unravels to float32.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.learner import host_weights, ravel_names


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        #: antithetic direction pairs per iteration (2x this many evals)
        self.num_rollouts = 8
        #: perturbation scale in parameter space
        self.sigma = 0.05
        #: step size
        self.lr = 0.02
        #: fraction of directions (ranked by max(R+, R-)) used in the update
        self.top_frac = 0.5
        #: complete episodes averaged per perturbation evaluation
        self.episodes_per_eval = 1
        #: env-step bound per evaluation (non-terminating policy guard)
        self.eval_max_steps = 2000

    algo_class = None  # set below


class Raveled:
    """Flat float64 vector ↔ ``{name: float32 array}`` over fixed names and
    shapes, in the reference's ``ravel_pytree`` order."""

    def __init__(self, weights: dict):
        self.names = ravel_names(weights)
        self.shapes = [np.shape(weights[n]) for n in self.names]
        self.sizes = [int(np.prod(s)) for s in self.shapes]

    def ravel(self, weights: dict) -> np.ndarray:
        return np.concatenate(
            [np.asarray(weights[n], np.float64).reshape(-1) for n in self.names]
        )

    def unravel(self, flat: np.ndarray) -> dict:
        flat = flat.astype(np.float32)
        out, off = {}, 0
        for name, shape, size in zip(self.names, self.shapes, self.sizes):
            out[name] = flat[off:off + size].reshape(shape)
            off += size
        return out


class ES(Algorithm):
    @classmethod
    def get_default_config(cls) -> "ESConfig":
        return ESConfig()

    def _setup(self):
        # the search space is the runner module's full parameter tree
        # flattened (the unused value head rides along — its perturbations
        # never influence action selection, so they are return-neutral)
        params = self.foreach_runner("get_weights")[0]
        self._raveled = Raveled(params)
        self._theta = self._raveled.ravel(params)
        self._np_rng = np.random.default_rng(self.config.seed or 0)

    def get_weights(self):
        return self._raveled.unravel(self._theta)

    def set_weights(self, params) -> None:
        self._theta = self._raveled.ravel(host_weights(params))
        self.sync_weights(self.get_weights())

    def _eval(self, flat: np.ndarray, runner_idx: int, futures: list) -> None:
        cfg: ESConfig = self.config
        params = self._raveled.unravel(flat)
        if self._local_runner is not None:
            futures.append(
                self._local_runner.eval_return(
                    params, cfg.episodes_per_eval, cfg.eval_max_steps
                )
            )
        else:
            actor = self._runner_actors[runner_idx % len(self._runner_actors)]
            futures.append(
                actor.eval_return.remote(
                    params, cfg.episodes_per_eval, cfg.eval_max_steps
                )
            )

    def training_step(self) -> dict:
        cfg: ESConfig = self.config
        dim = self._theta.size
        deltas = self._np_rng.standard_normal((cfg.num_rollouts, dim))
        futures: list = []
        for i, delta in enumerate(deltas):
            self._eval(self._theta + cfg.sigma * delta, 2 * i, futures)
            self._eval(self._theta - cfg.sigma * delta, 2 * i + 1, futures)
        if self._local_runner is None:
            results = ray_tpu_torch.get(futures, timeout=600)
        else:
            results = futures
        r_pos = np.array([results[2 * i]["return_mean"] for i in range(cfg.num_rollouts)])
        r_neg = np.array([results[2 * i + 1]["return_mean"] for i in range(cfg.num_rollouts)])
        steps = int(sum(r["steps"] for r in results))
        self._timesteps_total += steps
        self._theta, stats = self._update(r_pos, r_neg, deltas)

        # central-policy evaluation doubles as the weight sync (runners end
        # the iteration holding the updated central weights)
        central: list = []
        for idx in range(max(1, len(self._runner_actors))):
            self._eval(self._theta, idx, central)
        if self._local_runner is None:
            evals = ray_tpu_torch.get(central, timeout=600)
        else:
            evals = central
        rets = [e["return_mean"] for e in evals if e["episodes"]]
        if rets:
            self._episode_return_mean = float(np.mean(rets))
        self._timesteps_total += int(sum(e["steps"] for e in evals))
        return stats | {"episode_return_central": self._episode_return_mean}

    def _update(self, r_pos: np.ndarray, r_neg: np.ndarray, deltas: np.ndarray):
        """ARS update: rank directions by their best side, keep the top
        fraction, normalize the step by the kept returns' std. Returns the
        new theta and the update's stats."""
        cfg: ESConfig = self.config
        k = max(1, int(round(cfg.top_frac * cfg.num_rollouts)))
        order = np.argsort(np.maximum(r_pos, r_neg))[::-1][:k]
        kept = np.concatenate([r_pos[order], r_neg[order]])
        r_std = float(kept.std()) or 1.0
        grad = ((r_pos[order] - r_neg[order])[:, None] * deltas[order]).sum(0)
        step = cfg.lr / (k * r_std) * grad
        return self._theta + step, {
            "es_reward_pos_mean": float(r_pos.mean()),
            "es_reward_neg_mean": float(r_neg.mean()),
            "es_reward_std": r_std,
            "es_update_norm": float(np.linalg.norm(step)),
        }


ESConfig.algo_class = ES
register_algorithm("ES", ES)
register_algorithm("ARS", ES)  # same machinery; ARS is the formulation used
