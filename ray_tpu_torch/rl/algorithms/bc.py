"""BC — behavior cloning from offline experience (port of
``ray_tpu/rl/algorithms/bc.py``).

Reference: ``rllib/algorithms/bc/`` (MARWIL with beta=0: pure supervised
action imitation from an offline dataset). The update is one
max-likelihood step over columnar minibatches on the learner's device — no
env stepping in the training path; env runners exist only to evaluate the
cloned policy.
"""

from __future__ import annotations

from functools import partial

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.algorithms.ppo import _actor_critic
from ray_tpu_torch.rl.learner import LearnerGroup
from ray_tpu_torch.rl.offline import OfflineDataset


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iter = 100
        #: OfflineDataset | path (.npz / .jsonl) — the training experience
        self.offline_data = None
        #: env steps rolled per iteration to measure the cloned policy
        self.evaluation_steps = 0

    algo_class = None  # set below


def bc_loss(module, params, batch):
    """Negative log-likelihood of dataset actions (+ tiny value-head decay
    so the unused critic cannot drift to inf under weight sharing)."""
    import torch

    actions = batch[sb.ACTIONS]
    if params.discrete:
        actions = actions.long()
    logp, entropy, value = params.logp_entropy_value(batch[sb.OBS], actions)
    nll = -torch.mean(logp)
    return nll + 1e-6 * torch.mean(value**2), {
        "nll": nll,
        "entropy": torch.mean(entropy),
    }


class BC(Algorithm):
    @classmethod
    def get_default_config(cls) -> "BCConfig":
        return BCConfig()

    def _setup(self):
        cfg: BCConfig = self.config
        self.dataset: OfflineDataset = OfflineDataset.resolve(
            cfg.offline_data, seed=cfg.seed
        )
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_actor_critic, obs_space, act_space, tuple(cfg.hidden)),
                loss_fn=bc_loss,
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
        cfg: BCConfig = self.config
        metrics: dict = {}
        for _ in range(cfg.updates_per_iter):
            metrics = self.learner_group.update(self.dataset.sample(cfg.train_batch_size))
        out = {f"learner/{k}": v for k, v in metrics.items()}
        if cfg.evaluation_steps > 0:
            self.sync_weights(self.learner_group.weights_view())
            n_runners = max(1, len(self._runner_actors) or 1)
            n_envs = max(1, cfg.num_envs_per_env_runner)
            per = max(1, cfg.evaluation_steps // (n_runners * n_envs))
            for b in self.foreach_runner("sample_transitions", per):
                self._timesteps_total += b.count
        else:
            self._timesteps_total += cfg.updates_per_iter * cfg.train_batch_size
        return out


BCConfig.algo_class = BC
register_algorithm("BC", BC)
