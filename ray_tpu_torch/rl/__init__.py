"""ray_tpu_torch.rl: reinforcement learning on the port's task/actor runtime
(port of ``ray_tpu/rl/__init__.py``).

Reference: ``rllib/`` — Algorithm/AlgorithmConfig driver, EnvRunner sampling
actors, Learner/LearnerGroup updates, replay buffers, spaces, env registry.
Policies and learners are ``nn.Module``s on their ``device`` (the card
unless the caller asks for the CPU); envs, connectors, replay buffers,
offline data and sample batches are numpy.

Every module and algorithm of the reference is ported: PPO, DQN, IMPALA,
APPO, SAC, CQL, TD3, DDPG, BC, ES (also registered as ARS) and Dreamer, the
replay buffers, multi-agent envs and offline data.

Importing this package loads no torch: the torch modules (``rl_module``'s)
load on first use of their names, so the runtime's control plane and forked
workers can import it.
"""

from ray_tpu_torch.rl.algorithm import (  # noqa: F401
    Algorithm,
    AlgorithmConfig,
    get_algorithm_class,
    register_algorithm,
)
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.es import ES, ESConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rl.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentVectorEnv,
)
from ray_tpu_torch.rl.env import (  # noqa: F401
    CartPoleEnv,
    Env,
    GridWorldEnv,
    PendulumEnv,
    SyncVectorEnv,
    make_env,
    register_env,
)
from ray_tpu_torch.rl.env_runner import EnvRunner  # noqa: F401
from ray_tpu_torch.rl.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer  # noqa: F401
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae  # noqa: F401
from ray_tpu_torch.rl import spaces  # noqa: F401
from ray_tpu_torch.rl.algorithms.bc import BC, BCConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.td3 import TD3, TD3Config  # noqa: F401
from ray_tpu_torch.rl.algorithms.ddpg import DDPG, DDPGConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rl.algorithms.dreamer import Dreamer, DreamerConfig  # noqa: F401

_LAZY = {name: "ray_tpu_torch.rl.rl_module"
         for name in ("ActorCriticModule", "QModule", "RLModuleSpec")}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'ray_tpu_torch.rl' has no attribute {name!r}")
