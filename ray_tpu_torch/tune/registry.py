"""Trainable registry: resolve string names passed to Tuner/tune.run (copy
of ``ray_tpu/tune/registry.py``).

Reference: ``python/ray/tune/registry.py`` (``register_trainable``, RLlib
algorithms resolvable by name, e.g. ``tune.run("PPO")``). The port has no
``rl`` package yet (ROADMAP.md, queue A9), so a name the reference resolves
as an RL algorithm raises ``NotImplementedError``; the port keeps its own
copy of those names.
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
    if trainable in RL_ALGORITHMS:
        raise NotImplementedError(
            f"trainable {trainable!r} is an RL algorithm, and rl/ is not ported yet "
            "(ROADMAP.md, queue A9)"
        )
    raise KeyError(
        f"Unknown trainable {trainable!r}; registered: {sorted(_TRAINABLES)} "
        "plus RL algorithm names"
    )
