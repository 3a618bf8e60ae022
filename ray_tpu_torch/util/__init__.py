"""Utility APIs of the port (copy of ``ray_tpu/util/__init__.py``):
placement groups and scheduling strategies, and the observability modules
``metrics``, ``tracing``, ``phases``, ``waterfall``, ``slo`` and ``state``.
``actor_pool``, ``queue``, ``multiprocessing``, ``pubsub``,
``check_serialize``, ``grafana``, ``otlp`` and ``device_prof`` are still
to port (ROADMAP.md, queue A)."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

#: the reference's ``util`` modules not ported yet: reaching one raises
#: instead of quietly finding nothing
_NOT_PORTED = (
    "actor_pool", "queue", "multiprocessing", "pubsub", "check_serialize",
    "grafana", "otlp", "device_prof",
)


def __getattr__(name):
    import importlib

    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.util.{name} is not ported yet (ROADMAP.md, queue A5)"
        )
    for mod in ("metrics", "state"):
        m = importlib.import_module(f"ray_tpu_torch.util.{mod}")
        if hasattr(m, name):
            return getattr(m, name)
        if mod == name:
            return m
    raise AttributeError(name)
