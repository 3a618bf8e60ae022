"""The ported algorithms (port of ``ray_tpu/rl/algorithms/__init__.py``):
PPO. DQN, IMPALA, SAC, BC, CQL, TD3, DDPG, APPO, ES and Dreamer are not
ported yet (ROADMAP.md, queue A9.2)."""

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig  # noqa: F401
