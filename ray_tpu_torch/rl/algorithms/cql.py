"""CQL — conservative Q-learning for offline continuous control (port of
``ray_tpu/rl/algorithms/cql.py``).

Reference: ``rllib/algorithms/cql/`` (SAC objectives + a conservative
penalty that pushes down Q-values of out-of-distribution actions so the
offline policy cannot exploit extrapolation error). Reuses the port's SAC
module and loss (``sac.py``): one module, one Adam step; the CQL
regularizer adds a logsumexp over sampled random + policy actions minus the
dataset Q, weighted by ``cql_alpha``. Its draws (``"cql_random"``, uniform
over the action box, and ``"cql_policy"``, standard normal, each (n, B,
act_dim)) are seeded from (1, step), the reference's ``PRNGKey(1)``.
"""

from __future__ import annotations

from functools import partial

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.algorithms.sac import SACLoss, _polyak, _sac_module, target_entropy_of
from ray_tpu_torch.rl.learner import LearnerGroup, UpdateDraws
from ray_tpu_torch.rl.offline import OfflineDataset


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_batch_size = 256
        self.updates_per_iter = 200
        self.tau = 0.005
        self.target_entropy = "auto"
        self.cql_alpha = 1.0          # conservative penalty weight
        self.cql_n_actions = 4        # sampled actions per state for logsumexp
        self.offline_data = None      # OfflineDataset | .npz/.jsonl path
        self.evaluation_steps = 0

    algo_class = None  # set below


class CQLLoss(SACLoss):
    """SAC's objective plus the conservative penalty (``cql_loss``)."""

    def __init__(self, gamma: float, target_entropy: float, cql_alpha: float, n_actions: int):
        super().__init__(gamma, target_entropy)
        self.cql_alpha = cql_alpha
        self.n_actions = n_actions

    def loss(self, params, batch: dict, step: int):
        import torch

        total, metrics = super().loss(params, batch, step)
        obs = batch[sb.OBS]
        act = batch[sb.ACTIONS]
        B, n = obs.shape[0], self.n_actions
        draws = UpdateDraws(1, step, batch)

        # OOD action set: uniform-random + current-policy samples per state
        low, high = params.bounds(obs.device)
        # the draws' rows are dim 1: a data-parallel rank keeps its own
        rand_a = draws.uniform("cql_random", (n, B, params.act_dim), low, high, row_dim=1)
        with torch.no_grad():
            pol_a, _ = params.sample_action_logp(
                obs.expand((n,) + obs.shape),
                draws.normal("cql_policy", (n, B, params.act_dim), obs.device, row_dim=1),
            )
        cand = torch.cat([rand_a, pol_a], dim=0)        # (2n, B, act)
        obs_rep = obs.expand((2 * n,) + obs.shape)
        q1_ood, q2_ood = params.q_values(
            obs_rep.reshape(-1, obs.shape[-1]), cand.reshape(-1, params.act_dim)
        )
        q1_ood = q1_ood.reshape(2 * n, B)
        q2_ood = q2_ood.reshape(2 * n, B)
        q1_data, q2_data = params.q_values(obs, act)

        # logsumexp over candidate actions ≈ max Q on OOD actions
        gap1 = torch.mean(torch.logsumexp(q1_ood, dim=0) - q1_data)
        gap2 = torch.mean(torch.logsumexp(q2_ood, dim=0) - q2_data)
        penalty = self.cql_alpha * (gap1 + gap2)
        metrics = dict(metrics)
        metrics["cql_penalty"] = penalty
        return total + penalty, metrics


def cql_loss(gamma: float, target_entropy: float, cql_alpha: float, n_actions: int) -> CQLLoss:
    return CQLLoss(gamma, target_entropy, cql_alpha, n_actions)


class CQL(Algorithm):
    @classmethod
    def get_default_config(cls) -> "CQLConfig":
        return CQLConfig()

    def _module_cls(self):
        from ray_tpu_torch.rl.rl_module import SACModule

        return SACModule

    def _setup(self):
        cfg: CQLConfig = self.config
        self.dataset: OfflineDataset = OfflineDataset.resolve(
            cfg.offline_data, seed=cfg.seed
        )
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_sac_module, obs_space, act_space, tuple(cfg.hidden)),
                loss_fn=cql_loss(cfg.gamma, target_entropy_of(cfg, act_space), cfg.cql_alpha,
                                 cfg.cql_n_actions),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                seed=cfg.seed or 0,
                device=cfg.device,
            ),
            remote=cfg.remote_learner,
        )

    def get_weights(self):
        return self.learner_group.get_weights()

    def set_weights(self, params):
        self.learner_group.set_weights(params)
        self.sync_weights(params)

    def training_step(self) -> dict:
        cfg: CQLConfig = self.config
        metrics: dict = {}
        polyak = _polyak(cfg.tau)
        for _ in range(cfg.updates_per_iter):
            metrics = self.learner_group.update(self.dataset.sample(cfg.train_batch_size))
            self.learner_group.apply(polyak)
        out = {f"learner/{k}": v for k, v in metrics.items()}
        if cfg.evaluation_steps > 0:
            self.sync_weights(self.learner_group.weights_view())
            n_runners = max(1, len(self._runner_actors) or 1)
            per = max(1, cfg.evaluation_steps // n_runners)
            for b in self.foreach_runner("sample_transitions", per):
                self._timesteps_total += b.count
        else:
            self._timesteps_total += cfg.updates_per_iter * cfg.train_batch_size
        return out


CQLConfig.algo_class = CQL
register_algorithm("CQL", CQL)
