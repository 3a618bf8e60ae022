"""DDPG — deep deterministic policy gradient (port of
``ray_tpu/rl/algorithms/ddpg.py``).

Reference: ``rllib/algorithms/ddpg/`` (Lillicrap et al.; rllib implements
it as the TD3 machinery with the three TD3 tricks switched off). Same
here: DDPG is the TD3 one-module step with a single critic
(``twin_q=False``), no target-policy smoothing (``target_noise=0``) and
an actor update every critic step (``policy_delay=1``). Everything else —
deterministic tanh policy, Polyak targets, replay, exploration noise —
is shared with :mod:`ray_tpu_torch.rl.algorithms.td3`.
"""

from __future__ import annotations

from ray_tpu_torch.rl.algorithm import register_algorithm
from ray_tpu_torch.rl.algorithms.td3 import TD3, TD3Config


class DDPGConfig(TD3Config):
    def __init__(self):
        super().__init__()
        self.twin_q = False        # single critic
        self.target_noise = 0.0    # no target policy smoothing by default;
        # the clip stays at TD3's 0.5 so re-enabling target_noise behaves
        # (a 0.0 clip would silently annihilate it)
        self.policy_delay = 1      # actor updates every step

    algo_class = None  # set below


class DDPG(TD3):
    @classmethod
    def get_default_config(cls) -> "DDPGConfig":
        return DDPGConfig()


DDPGConfig.algo_class = DDPG
register_algorithm("DDPG", DDPG)
