"""Trainable registry: resolve string names passed to Tuner/tune.run (copy
of ``ray_tpu/tune/registry.py``).

Reference: ``python/ray/tune/registry.py`` (``register_trainable``, RLlib
algorithms resolvable by name, e.g. ``tune.run("PPO")``). A name the port's
``rl`` registers (PPO) resolves to its ``as_trainable``; the other names
the reference resolves as RL algorithms raise ``NotImplementedError``
(ROADMAP.md, queue A9.2). ``rl`` is imported on first use, and loads no
torch.
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
        if trainable in RL_ALGORITHMS:
            raise NotImplementedError(
                f"trainable {trainable!r} is an RL algorithm the port has not ported yet "
                "(ROADMAP.md, queue A9.2)"
            ) from None
    else:
        return cls.as_trainable(cls.get_default_config())
    raise KeyError(
        f"Unknown trainable {trainable!r}; registered: {sorted(_TRAINABLES)} "
        "plus RL algorithm names"
    )
