"""IMPALA — async off-policy actor-critic with V-trace correction (port of
``ray_tpu/rl/algorithms/impala.py``).

Reference: ``rllib/algorithms/impala/impala.py`` (async sample collection
from env-runner actors, V-trace-corrected learner updates, periodic weight
broadcast). Runners stream time-major ``(N, T)`` sequence batches as
futures; the driver consumes whichever future lands first
(``ray_tpu_torch.wait``), updates the learner (V-trace's backward
recursion is a loop over T on the learner's device tensors), pushes fresh
weights to that runner only, and immediately resubmits its next rollout —
sampling never blocks on learning and vice versa.
"""

from __future__ import annotations

from functools import partial

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.algorithms.ppo import _actor_critic
from ray_tpu_torch.rl.learner import LearnerGroup, host_weights
from ray_tpu_torch.rl.sample_batch import SampleBatch


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rollout_fragment_length = 50
        self.train_batch_size = 500     # env steps consumed per training_step
        self.broadcast_interval = 1     # updates between weight pushes to a runner

    algo_class = None  # set below


def vtrace(behavior_logp, target_logp, rewards, dones, values, bootstrap,
           gamma: float, rho_bar: float, c_bar: float):
    """V-trace targets + policy-gradient advantages over (N, T) sequences.

    Espeholt et al. 2018 eqs. (1)-(2); the backward recursion is a loop over
    T on the inputs' device (the reference's reversed ``lax.scan``). All
    inputs (N, T) except ``bootstrap`` (N,). Returns (vs, pg_adv), both (N,
    T) and detached.
    """
    import torch

    with torch.no_grad():
        rhos = torch.exp(target_logp - behavior_logp)
        clipped_rhos = torch.clamp(rhos, max=rho_bar)
        cs = torch.clamp(rhos, max=c_bar)
        discounts = gamma * (1.0 - dones.float())
        next_values = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
        deltas = clipped_rhos * (rewards + discounts * next_values - values)
        acc = torch.zeros_like(bootstrap)
        out = []
        for t in range(rewards.shape[1] - 1, -1, -1):
            acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
            out.append(acc)
        vs = values + torch.stack(out[::-1], dim=1)
        vs_next = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
        pg_adv = clipped_rhos * (rewards + discounts * vs_next - values)
    return vs, pg_adv


def impala_loss(gamma: float, rho_bar: float, c_bar: float,
                vf_coeff: float, ent_coeff: float):
    def loss_fn(module, params, batch):
        import torch

        # (N, T, obs) / (N, T) sequence batch from sample_sequences.
        logp, entropy, values = params.logp_entropy_value(batch[sb.OBS], batch[sb.ACTIONS])
        vs, pg_adv = vtrace(
            batch[sb.LOGP], logp.detach(), batch[sb.REWARDS], batch[sb.TERMINATEDS],
            values.detach(), batch["bootstrap_value"], gamma, rho_bar, c_bar,
        )
        pi_loss = -torch.mean(logp * pg_adv)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        ent = torch.mean(entropy)
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}

    return loss_fn


class IMPALA(Algorithm):
    @classmethod
    def get_default_config(cls) -> "IMPALAConfig":
        return IMPALAConfig()

    def _make_loss(self, cfg):
        """Loss builder — APPO subclasses swap in the clipped surrogate."""
        return impala_loss(
            cfg.gamma, cfg.vtrace_clip_rho_threshold,
            cfg.vtrace_clip_c_threshold, cfg.vf_loss_coeff,
            cfg.entropy_coeff,
        )

    def _setup(self):
        cfg: IMPALAConfig = self.config
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_actor_critic, obs_space, act_space, tuple(cfg.hidden)),
                loss_fn=self._make_loss(cfg),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                seed=cfg.seed or 0,
                device=cfg.device,
            ),
            remote=cfg.remote_learner,
        )
        self.sync_weights(self.learner_group.weights_view())
        # one in-flight (future, actor) per runner slot (async pipeline);
        # the actor is recorded so a future from a since-replaced actor is
        # never mistaken for a failure of the current one
        self._inflight: dict[int, tuple] = {}
        self._updates_since_broadcast: dict[int, int] = {}

    def get_weights(self):
        return self.learner_group.get_weights()

    def set_weights(self, params):
        self.learner_group.set_weights(params)
        self.sync_weights(params)

    # -- async sampling loop ------------------------------------------------

    def _submit(self, i: int):
        cfg: IMPALAConfig = self.config
        actor = self._runner_actors[i]
        self._inflight[i] = (
            actor.sample_sequences.remote(cfg.rollout_fragment_length, cfg.gamma),
            actor,
        )

    def restart_runner(self, index: int) -> None:
        super().restart_runner(index)
        self._inflight.pop(index, None)  # stale future from the dead actor

    def training_step(self) -> dict:
        cfg: IMPALAConfig = self.config
        metrics: dict = {}
        if self._local_runner is not None:
            # local mode: synchronous fallback, still V-trace-corrected
            steps = 0
            while steps < cfg.train_batch_size:
                batch = self._local_runner.sample_sequences(
                    cfg.rollout_fragment_length, cfg.gamma
                )
                steps += int(batch[sb.REWARDS].size)
                metrics = self.learner_group.update(batch)
                self._local_runner.set_weights(self.learner_group.weights_view())
            self._timesteps_total += steps
            return {f"learner/{k}": v for k, v in metrics.items()}

        for i in range(len(self._runner_actors)):
            if self._inflight.get(i) is None:
                self._submit(i)
        steps = 0
        while steps < cfg.train_batch_size:
            fut_to_idx = {f: i for i, (f, _) in self._inflight.items()}
            ready, _ = ray_tpu_torch.wait(list(fut_to_idx), num_returns=1)
            i = fut_to_idx[ready[0]]
            try:
                batch: SampleBatch = ray_tpu_torch.get(ready[0])
            except RayActorError:
                if not cfg.restart_failed_env_runners:
                    raise
                # only replace the runner if the failed future belongs to the
                # CURRENT actor — it may already have been restarted (e.g. by
                # a foreach_runner round between training_steps)
                if self._inflight[i][1] is self._runner_actors[i]:
                    self.restart_runner(i)
                else:
                    self._inflight.pop(i, None)
                self._submit(i)
                continue
            steps += int(batch[sb.REWARDS].size)
            metrics = self.learner_group.update(batch)
            # push fresh weights to the runner we just drained (stale-ness is
            # what V-trace corrects for; broadcast_interval throttles traffic)
            n = self._updates_since_broadcast.get(i, 0) + 1
            if n >= cfg.broadcast_interval:
                self._runner_actors[i].set_weights.remote(
                    host_weights(self.learner_group.weights_view())
                )
                n = 0
            self._updates_since_broadcast[i] = n
            self._submit(i)
        self._timesteps_total += steps
        return {f"learner/{k}": v for k, v in metrics.items()} | {
            "num_env_steps_sampled": steps
        }


IMPALAConfig.algo_class = IMPALA
register_algorithm("IMPALA", IMPALA)
