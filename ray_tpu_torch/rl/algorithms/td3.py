"""TD3 — twin-delayed deep deterministic policy gradient (port of
``ray_tpu/rl/algorithms/td3.py``).

Reference: ``rllib/algorithms/td3/`` (DDPG + twin Q + target policy
smoothing + delayed policy updates). Same one-module/one-step shape as the
port's SAC: the critic and (gated) actor objectives compose into one loss
over ``rl_module.TD3Module``, with detached parameters where the reference
stops gradients. The policy delay multiplies the actor loss by ``step %
d == 0``: on the other steps the actor's gradient is zero and Adam still
moves it through its moments, as optax's does. Target networks
Polyak-update after each step, in place on the learner's device. The
smoothing noise (``"target"``, (B, act_dim) standard normal) is seeded from
(0, step), the reference's ``fold_in(PRNGKey(0), step)``.
"""

from __future__ import annotations

from functools import partial

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.algorithms.sac import polyak_update
from ray_tpu_torch.rl.learner import CountingLoss, LearnerGroup, UpdateDraws
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size = 100_000
        self.learning_starts = 1500
        self.sample_steps_per_iter = 400
        self.updates_per_iter = 200
        self.train_batch_size = 256
        self.tau = 0.005
        self.exploration_noise = 0.1      # env-side action noise
        self.target_noise = 0.2           # target policy smoothing
        self.target_noise_clip = 0.5
        self.policy_delay = 2             # actor updates every d critic steps
        self.twin_q = True                # False = classic DDPG single critic

    algo_class = None  # set below


class TD3Loss(CountingLoss):
    """The TD3 objective (``td3_loss``)."""

    def __init__(self, gamma: float, target_noise: float, noise_clip: float, policy_delay: int):
        self.gamma = gamma
        self.target_noise = target_noise
        self.noise_clip = noise_clip
        self.policy_delay = policy_delay

    def loss(self, params, batch: dict, step: int):
        import torch

        obs, act = batch[sb.OBS], batch[sb.ACTIONS]
        rew = batch[sb.REWARDS]
        done = batch[sb.TERMINATEDS].float()
        next_obs = batch[sb.NEXT_OBS]
        draws = UpdateDraws(0, step, batch)

        # -- critic: clipped double-Q target with smoothed target action ---
        with torch.no_grad():
            next_a = params.policy(next_obs, target=True)
            eps = draws.normal("target", tuple(next_a.shape), obs.device)
            smooth = torch.clamp(self.target_noise * eps, -self.noise_clip, self.noise_clip)
            low, high = params.bounds(obs.device)
            next_a = torch.clamp(next_a + smooth, low, high)
            tq1, tq2 = params.q_values(next_obs, next_a, target=True)
            target = rew + self.gamma * (1.0 - done) * torch.minimum(tq1, tq2)
        q1, q2 = params.q_values(obs, act)
        q_loss = torch.mean((q1 - target) ** 2)
        if params.twin_q:
            q_loss = q_loss + torch.mean((q2 - target) ** 2)

        # -- actor, gated by the policy delay (Q frozen) -------------------
        pi_a = params.policy(obs)
        fq1, _ = params.q_values(obs, pi_a, frozen_params=True)
        do_pi = float(step % self.policy_delay == 0)
        pi_loss = -do_pi * torch.mean(fq1)

        return q_loss + pi_loss, {
            "q_loss": q_loss,
            "pi_loss": pi_loss,
            "q_mean": torch.mean(q1),
        }


def td3_loss(gamma: float, target_noise: float, noise_clip: float, policy_delay: int) -> TD3Loss:
    return TD3Loss(gamma, target_noise, noise_clip, policy_delay)


def _polyak_all(tau: float):
    """Polyak of every target (the pickling function ``LearnerGroup.apply``
    runs); DDPG's module has no ``target_q2``."""
    return partial(polyak_update, tau=tau,
                   pairs=(("pi", "target_pi"), ("q1", "target_q1"), ("q2", "target_q2")))


def _td3_module(obs_space, act_space, hidden: tuple, exploration_noise: float, twin_q: bool):
    """The learner's ``module_factory`` (with ``partial``)."""
    from ray_tpu_torch.rl.rl_module import RLModuleSpec, TD3Module

    return TD3Module(RLModuleSpec(obs_space, act_space, hidden=hidden), exploration_noise,
                     twin_q=twin_q)


class TD3(Algorithm):
    @classmethod
    def get_default_config(cls) -> "TD3Config":
        return TD3Config()

    def _module_cls(self):
        from ray_tpu_torch.rl.rl_module import TD3Module

        cfg = self.config
        return partial(TD3Module, exploration_noise=cfg.exploration_noise, twin_q=cfg.twin_q)

    def _setup(self):
        cfg: TD3Config = self.config
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_td3_module, obs_space, act_space, tuple(cfg.hidden),
                                       cfg.exploration_noise, cfg.twin_q),
                loss_fn=td3_loss(
                    cfg.gamma, cfg.target_noise, cfg.target_noise_clip, cfg.policy_delay
                ),
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
        cfg: TD3Config = self.config
        n_runners = max(1, len(self._runner_actors) or 1)
        n_envs = max(1, cfg.num_envs_per_env_runner)
        vec_steps = max(1, cfg.sample_steps_per_iter // (n_runners * n_envs))
        for b in self.foreach_runner("sample_transitions", vec_steps):
            self.buffer.add(b)
            self._timesteps_total += b.count
        metrics: dict = {}
        if len(self.buffer) >= cfg.learning_starts:
            polyak = _polyak_all(cfg.tau)
            for _ in range(cfg.updates_per_iter):
                # the loss counts its calls: the reference's batch["step"]
                metrics = self.learner_group.update(self.buffer.sample(cfg.train_batch_size))
                self.learner_group.apply(polyak)
            self.sync_weights(self.learner_group.weights_view())
        return {f"learner/{k}": v for k, v in metrics.items()} | {
            "buffer_size": len(self.buffer)
        }


TD3Config.algo_class = TD3
register_algorithm("TD3", TD3)


def __getattr__(name):
    if name == "TD3Module":  # a torch module: loaded on first use
        from ray_tpu_torch.rl.rl_module import TD3Module

        return TD3Module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
