"""The ported algorithms (port of ``ray_tpu/rl/algorithms/__init__.py``):
each module registers its algorithm with ``rl.algorithm`` on import. None
of them imports torch at module import."""

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.bc import BC, BCConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.td3 import TD3, TD3Config  # noqa: F401
from ray_tpu_torch.rl.algorithms.ddpg import DDPG, DDPGConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.es import ES, ESConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.dreamer import Dreamer, DreamerConfig  # noqa: F401
