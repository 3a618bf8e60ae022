"""PPO — clipped-surrogate policy optimization (port of
``ray_tpu/rl/algorithms/ppo.py``).

Reference: ``rllib/algorithms/ppo/ppo.py:405`` (training_step: sample via
WorkerSet → learner_group.update → sync_weights) and
``ppo_torch_learner`` loss. The loss works on tensors inside the Learner;
minibatch epochs run back-to-back device steps. torch is imported where
the loss runs, not at module import.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.learner import LearnerGroup
from ray_tpu_torch.rl.sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.lambda_ = 0.95
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 8

    algo_class = None  # set below


def ppo_loss(clip_param: float, vf_clip: float, vf_coeff: float, ent_coeff: float):
    def loss_fn(module, params, batch):
        import torch

        # ``params`` is the initialized ActorCriticModule (rl_module doc)
        logp, entropy, values = params.logp_entropy_value(batch[sb.OBS], batch[sb.ACTIONS])
        adv = batch[sb.ADVANTAGES]
        ratio = torch.exp(logp - batch[sb.LOGP])
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv
        )
        pi_loss = -torch.mean(surr)
        vf_err = torch.clamp((values - batch[sb.VALUE_TARGETS]) ** 2, 0.0, vf_clip**2)
        vf_loss = torch.mean(vf_err)
        ent = torch.mean(entropy)
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * ent
        kl = torch.mean(batch[sb.LOGP] - logp)
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": ent,
            "kl": kl,
        }

    return loss_fn


class PPO(Algorithm):
    @classmethod
    def get_default_config(cls) -> "PPOConfig":
        return PPOConfig()

    def _setup(self):
        cfg: PPOConfig = self.config
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_actor_critic, obs_space, act_space, tuple(cfg.hidden)),
                loss_fn=ppo_loss(
                    cfg.clip_param, cfg.vf_clip_param, cfg.vf_loss_coeff, cfg.entropy_coeff
                ),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                seed=cfg.seed or 0,
                device=cfg.device,
            ),
            remote=cfg.remote_learner,
        )
        self.sync_weights(self.learner_group.weights_view())
        self._mb_rng = np.random.default_rng(cfg.seed)

    def get_weights(self):
        return self.learner_group.get_weights()

    def set_weights(self, params):
        self.learner_group.set_weights(params)
        self.sync_weights(params)

    def training_step(self) -> dict:
        cfg: PPOConfig = self.config
        # 1) parallel sampling until train_batch_size steps are gathered
        batches: list[SampleBatch] = []
        gathered = 0
        while gathered < cfg.train_batch_size:
            out = self.foreach_runner("sample")
            batches.extend(out)
            gathered += sum(b.count for b in out)
        batch = SampleBatch.concat(batches)
        self._timesteps_total += batch.count
        # 2) advantage normalization (reference: standardize_fields=["advantages"])
        adv = batch[sb.ADVANTAGES]
        batch[sb.ADVANTAGES] = (adv - adv.mean()) / max(adv.std(), 1e-6)
        # 3) minibatch SGD epochs
        metrics: dict = {}
        mb = min(cfg.minibatch_size, batch.count)
        for _ in range(cfg.num_epochs):
            for minibatch in batch.minibatches(mb, self._mb_rng):
                metrics = self.learner_group.update(minibatch)
        # 4) broadcast new weights to runners
        self.sync_weights(self.learner_group.weights_view())
        return {f"learner/{k}": v for k, v in metrics.items()} | {
            "num_env_steps_sampled": batch.count
        }


def _actor_critic(obs_space, act_space, hidden: tuple):
    """The learner's ``module_factory`` (with ``partial``): imports the torch
    module where the learner runs."""
    from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec

    return ActorCriticModule(RLModuleSpec(obs_space, act_space, hidden=hidden))


PPOConfig.algo_class = PPO
register_algorithm("PPO", PPO)
