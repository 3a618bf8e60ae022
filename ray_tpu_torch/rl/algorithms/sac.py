"""SAC — soft actor-critic for continuous control (port of
``ray_tpu/rl/algorithms/sac.py``).

Reference: ``rllib/algorithms/sac/sac.py`` (off-policy replay + twin-Q +
squashed-gaussian policy + learned entropy temperature). Policy, twin Q,
target Q and log-alpha are ONE module (``rl_module.SACModule``) updated by
one Adam step: the three SAC objectives compose into a single loss, with
detached parameters where the reference stops gradients, so the Learner's
machinery is reused unchanged. Target networks update by Polyak averaging
after each step, in place on the learner's device.

The loss's gaussian noise comes from ``UpdateDraws`` (seeded from (0,
step), the reference's ``fold_in(PRNGKey(0), step)``), or from the batch's
``"draw/next"``/``"draw/pi"`` when given. torch is imported where the loss
and the update run, not at module import.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.learner import CountingLoss, LearnerGroup, UpdateDraws
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.buffer_size = 100_000
        self.learning_starts = 1500
        self.sample_steps_per_iter = 400
        self.updates_per_iter = 200
        self.train_batch_size = 256
        self.tau = 0.005                  # polyak target update rate
        self.initial_alpha = 0.1
        self.target_entropy = "auto"      # -act_dim

    algo_class = None  # set below


class SACLoss(CountingLoss):
    """The SAC objective (``sac_loss``); draws ``"next"`` and ``"pi"``, each
    (B, act_dim) standard normal."""

    def __init__(self, gamma: float, target_entropy: float):
        self.gamma = gamma
        self.target_entropy = target_entropy

    def loss(self, params, batch: dict, step: int):
        import torch

        obs, act = batch[sb.OBS], batch[sb.ACTIONS]
        next_obs = batch[sb.NEXT_OBS]
        rew = batch[sb.REWARDS]
        done = batch[sb.TERMINATEDS].float()
        draws = UpdateDraws(0, step, batch)
        shape = (obs.shape[0], params.act_dim)
        alpha = torch.exp(params.log_alpha)

        # -- critic target (no gradients) ---------------------------------
        with torch.no_grad():
            next_a, next_logp = params.sample_action_logp(
                next_obs, draws.normal("next", shape, obs.device)
            )
            tq1, tq2 = params.q_values(next_obs, next_a, target=True)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target = rew + self.gamma * (1.0 - done) * target_v
        q1, q2 = params.q_values(obs, act)
        q_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

        # -- actor (Q params frozen) --------------------------------------
        pi_a, pi_logp = params.sample_action_logp(obs, draws.normal("pi", shape, obs.device))
        fq1, fq2 = params.q_values(obs, pi_a, frozen_params=True)
        pi_loss = torch.mean(alpha.detach() * pi_logp - torch.minimum(fq1, fq2))

        # -- temperature ---------------------------------------------------
        alpha_loss = -torch.mean(params.log_alpha * (pi_logp + self.target_entropy).detach())

        total = q_loss + pi_loss + alpha_loss
        return total, {
            "q_loss": q_loss,
            "pi_loss": pi_loss,
            "alpha": alpha,
            "entropy": -torch.mean(pi_logp),
        }


def sac_loss(gamma: float, target_entropy: float) -> SACLoss:
    return SACLoss(gamma, target_entropy)


def polyak_update(learner, tau: float, pairs: tuple) -> bool:
    """``target = (1 - tau) * target + tau * source`` for each (source,
    target) pair of the learner's module that exists, in place on its device
    (no host round trip)."""
    import torch

    module = learner.params
    targets, sources = [], []
    for src, dst in pairs:
        if getattr(module, dst, None) is not None:
            targets += list(getattr(module, dst).parameters())
            sources += list(getattr(module, src).parameters())
    with torch.no_grad():
        torch._foreach_mul_(targets, 1.0 - tau)
        torch._foreach_add_(targets, sources, alpha=tau)
    return True


def _polyak(tau: float):
    """The Polyak update of SAC's twin Q targets, a function of the learner
    that pickles (``LearnerGroup.apply`` ships it to a remote learner)."""
    return partial(polyak_update, tau=tau, pairs=(("q1", "target_q1"), ("q2", "target_q2")))


def _sac_module(obs_space, act_space, hidden: tuple):
    """The learner's ``module_factory`` (with ``partial``)."""
    from ray_tpu_torch.rl.rl_module import RLModuleSpec, SACModule

    return SACModule(RLModuleSpec(obs_space, act_space, hidden=hidden))


def target_entropy_of(cfg, act_space) -> float:
    return (
        -float(np.prod(act_space.shape))
        if cfg.target_entropy == "auto"
        else float(cfg.target_entropy)
    )


class SAC(Algorithm):
    @classmethod
    def get_default_config(cls) -> "SACConfig":
        return SACConfig()

    def _module_cls(self):
        from ray_tpu_torch.rl.rl_module import SACModule

        return SACModule

    def _setup(self):
        cfg: SACConfig = self.config
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_sac_module, obs_space, act_space, tuple(cfg.hidden)),
                loss_fn=sac_loss(cfg.gamma, target_entropy_of(cfg, act_space)),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                seed=cfg.seed or 0,
                device=cfg.device,
            ),
            remote=cfg.remote_learner,
        )
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self.sync_weights(self.learner_group.weights_view())

    def get_weights(self):
        return self.learner_group.get_weights()

    def set_weights(self, params):
        self.learner_group.set_weights(params)
        self.sync_weights(params)

    def training_step(self) -> dict:
        cfg: SACConfig = self.config
        n_runners = max(1, len(self._runner_actors) or 1)
        n_envs = max(1, cfg.num_envs_per_env_runner)
        vec_steps = max(1, cfg.sample_steps_per_iter // (n_runners * n_envs))
        for b in self.foreach_runner("sample_transitions", vec_steps):
            self.buffer.add(b)
            self._timesteps_total += b.count
        metrics: dict = {}
        if len(self.buffer) >= cfg.learning_starts:
            polyak = _polyak(cfg.tau)
            for _ in range(cfg.updates_per_iter):
                # the loss counts its calls: the reference's batch["step"]
                batch = self.buffer.sample(cfg.train_batch_size)
                metrics = self.learner_group.update(batch)
                self.learner_group.apply(polyak)
            self.sync_weights(self.learner_group.weights_view())
        return {f"learner/{k}": v for k, v in metrics.items()} | {
            "buffer_size": len(self.buffer)
        }


SACConfig.algo_class = SAC
register_algorithm("SAC", SAC)


def __getattr__(name):
    if name == "SACModule":  # a torch module: loaded on first use
        from ray_tpu_torch.rl.rl_module import SACModule

        return SACModule
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
