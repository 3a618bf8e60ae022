"""Trainable registry: resolve string names passed to Tuner/tune.run (copy
of ``ray_tpu/tune/registry.py``).

Reference: ``python/ray/tune/registry.py`` (``register_trainable``, RLlib
algorithms resolvable by name, e.g. ``tune.run("PPO")``). Every name in
``RL_ALGORITHMS`` resolves to its algorithm's ``as_trainable``. ``rl`` is
imported on first use, and loads no torch.
"""

from __future__ import annotations

from typing import Callable, Union

_TRAINABLES: dict[str, Callable] = {}

#: the algorithms ``ray_tpu.rl`` registers (``register_algorithm`` in
#: ``ray_tpu/rl/algorithms/``)
RL_ALGORITHMS = frozenset(
    {"APPO", "ARS", "BC", "CQL", "DDPG", "DQN", "Dreamer", "ES", "IMPALA", "PPO", "SAC", "TD3"}
)


def register_trainable(name: str, trainable: Callable) -> None:
    _TRAINABLES[name] = trainable


def resolve_trainable(trainable: Union[str, Callable]) -> Callable:
    if not isinstance(trainable, str):
        return trainable
    if trainable in _TRAINABLES:
        return _TRAINABLES[trainable]
    # RL algorithms are resolvable by name, reference-style.
    from ray_tpu_torch.rl import get_algorithm_class

    try:
        cls = get_algorithm_class(trainable)
    except KeyError:
        pass
    else:
        return cls.as_trainable(cls.get_default_config())
    raise KeyError(
        f"Unknown trainable {trainable!r}; registered: {sorted(_TRAINABLES)} "
        "plus RL algorithm names"
    )
