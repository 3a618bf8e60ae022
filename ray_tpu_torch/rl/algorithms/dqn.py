"""DQN — double-DQN with (optionally prioritized) replay (port of
``ray_tpu/rl/algorithms/dqn.py``).

Reference: ``rllib/algorithms/dqn/dqn.py`` (training_step: sample →
replay-buffer add → N learner updates → periodic target sync → ε decay).
The Q-network and its target are one ``QModule`` on the learner's device;
the target sync copies in place there. torch is imported where the loss
and the sync run, not at module import.
"""

from __future__ import annotations

from functools import partial

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.learner import LearnerGroup
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.buffer_size = 50_000
        self.prioritized_replay = False
        self.learning_starts = 1000
        self.target_update_freq = 500    # in sampled env steps
        self.sample_steps_per_iter = 512
        self.updates_per_iter = 32
        self.train_batch_size = 64
        self.double_q = True
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 10_000

    algo_class = None  # set below


def dqn_loss(gamma: float, double_q: bool):
    def loss_fn(module, params, batch):
        import torch

        q_all = params.q_values(batch[sb.OBS])
        q = q_all.gather(-1, batch[sb.ACTIONS].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_target = params.q_values(batch[sb.NEXT_OBS], target=True)
            online = params.q_values(batch[sb.NEXT_OBS]) if double_q else q_next_target
            best = torch.argmax(online, dim=-1)
            q_next = q_next_target.gather(-1, best[:, None])[:, 0]
        target = batch[sb.REWARDS] + gamma * (1.0 - batch[sb.TERMINATEDS].float()) * q_next
        td = q - target
        weights = batch.get("weights")
        per_sample = huber(td)
        loss = torch.mean(per_sample * weights) if weights is not None else torch.mean(per_sample)
        # Per-sample |td| flows back as an aux array so prioritized replay
        # can set PER-SAMPLE priorities (reference: dqn updates priorities
        # with each sample's TD error, not a batch statistic).
        return loss, {
            "td_error_mean": torch.mean(torch.abs(td)),
            "q_mean": torch.mean(q),
            "td_abs": torch.abs(td),
        }

    return loss_fn


def huber(x, delta: float = 1.0):
    import torch

    absx = torch.abs(x)
    return torch.where(absx <= delta, 0.5 * x * x, delta * (absx - 0.5 * delta))


def _sync_target(learner) -> bool:
    """Copy the online Q-network into the target, in place on the learner's
    device (no host round trip)."""
    learner.params.target_q.load_state_dict(learner.params.q.state_dict())  # copies in place
    return True


def _q_module(obs_space, act_space, hidden: tuple):
    """The learner's ``module_factory`` (with ``partial``)."""
    from ray_tpu_torch.rl.rl_module import QModule, RLModuleSpec

    return QModule(RLModuleSpec(obs_space, act_space, hidden=hidden))


class DQN(Algorithm):
    @classmethod
    def get_default_config(cls) -> "DQNConfig":
        return DQNConfig()

    def _module_cls(self):
        from ray_tpu_torch.rl.rl_module import QModule

        return QModule

    def _setup(self):
        cfg: DQNConfig = self.config
        obs_space, act_space = self.foreach_runner("get_spaces")[0]
        self.learner_group = LearnerGroup(
            dict(
                module_factory=partial(_q_module, obs_space, act_space, tuple(cfg.hidden)),
                loss_fn=dqn_loss(cfg.gamma, cfg.double_q),
                lr=cfg.lr,
                grad_clip=cfg.grad_clip,
                seed=cfg.seed or 0,
                device=cfg.device,
            ),
            remote=cfg.remote_learner,
        )
        self.buffer = (
            PrioritizedReplayBuffer(cfg.buffer_size, seed=cfg.seed)
            if cfg.prioritized_replay
            else ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        )
        self._steps_since_target_sync = 0
        self.sync_weights(self.learner_group.weights_view())
        self._update_epsilon()

    def _update_epsilon(self):
        cfg: DQNConfig = self.config
        frac = min(1.0, self._timesteps_total / max(cfg.epsilon_decay_steps, 1))
        eps = cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)
        self.foreach_runner("set_epsilon", float(eps))
        self._epsilon = eps

    def get_weights(self):
        return self.learner_group.get_weights()

    def set_weights(self, params):
        self.learner_group.set_weights(params)
        self.sync_weights(params)

    def training_step(self) -> dict:
        cfg: DQNConfig = self.config
        # 1) sample transitions from all runners. sample_steps_per_iter counts
        # TOTAL env steps per iteration (across runners AND their vector
        # slots), so epsilon decay / replay-ratio tuning is independent of the
        # runner topology.
        n_runners = max(1, len(self._runner_actors) or 1)
        n_envs = max(1, self.config.num_envs_per_env_runner)
        vec_steps = max(1, cfg.sample_steps_per_iter // (n_runners * n_envs))
        outs = self.foreach_runner("sample_transitions", vec_steps)
        for b in outs:
            self.buffer.add(b)
            self._timesteps_total += b.count
            self._steps_since_target_sync += b.count
        metrics: dict = {}
        # 2) learn
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                metrics = self.learner_group.update(batch)
                td_abs = metrics.pop("td_abs", None)
                if cfg.prioritized_replay and "batch_indexes" in batch and td_abs is not None:
                    # td_abs is already host numpy: Learner.update makes one
                    # transfer of the scalar metrics and one of this array
                    self.buffer.update_priorities(batch["batch_indexes"], td_abs)
            # 3) periodic target network sync + weight broadcast
            if self._steps_since_target_sync >= cfg.target_update_freq:
                self.learner_group.apply(_sync_target)
                self._steps_since_target_sync = 0
            self.sync_weights(self.learner_group.weights_view())
        self._update_epsilon()
        return {f"learner/{k}": v for k, v in metrics.items()} | {
            "epsilon": self._epsilon,
            "buffer_size": len(self.buffer),
        }


DQNConfig.algo_class = DQN
register_algorithm("DQN", DQN)
