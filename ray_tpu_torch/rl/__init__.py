"""ray_tpu_torch.rl: reinforcement learning on the port's task/actor runtime
(port of ``ray_tpu/rl/__init__.py``).

Reference: ``rllib/`` — Algorithm/AlgorithmConfig driver, EnvRunner sampling
actors, Learner/LearnerGroup updates, spaces, env registry. Policies and
learners are ``nn.Module``s on their ``device`` (the card unless the caller
asks for the CPU); envs, connectors and sample batches are numpy.

Ported: the core (spaces, sample batches and GAE, envs, connectors, RL
modules, env runners, learners, the algorithm driver) and PPO. The replay
buffers, multi-agent envs, offline data and the other algorithms (DQN,
SAC, TD3, DDPG, CQL, BC, IMPALA, APPO, ES, Dreamer) are not ported yet
(ROADMAP.md, queue A9.2): their names raise ``NotImplementedError``.

Importing this package loads no torch: the names of ``rl_module`` load on
first use, so the runtime's control plane and forked workers can import it.
"""

from ray_tpu_torch.rl.algorithm import (  # noqa: F401
    Algorithm,
    AlgorithmConfig,
    get_algorithm_class,
    register_algorithm,
)
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig  # noqa: F401
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
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae  # noqa: F401
from ray_tpu_torch.rl import spaces  # noqa: F401

_LAZY = {name: "ray_tpu_torch.rl.rl_module"
         for name in ("ActorCriticModule", "QModule", "RLModuleSpec")}

#: names ``ray_tpu.rl`` exports whose modules are not ported yet
_NOT_PORTED = frozenset({
    "DQN", "DQNConfig", "IMPALA", "IMPALAConfig", "ES", "ESConfig", "SAC", "SACConfig",
    "ReplayBuffer", "PrioritizedReplayBuffer", "MultiAgentEnv", "MultiAgentVectorEnv",
})


def __getattr__(name):
    import importlib

    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.rl.{name} is not ported yet (ROADMAP.md, queue A9.2): the port "
            "has PPO and the rl core"
        )
    raise AttributeError(f"module 'ray_tpu_torch.rl' has no attribute {name!r}")
