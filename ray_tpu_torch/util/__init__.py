"""Utility APIs of the port (copy of ``ray_tpu/util/__init__.py``):
placement groups and scheduling strategies; ``actor_pool``, ``queue``,
``multiprocessing`` (a ``Pool`` over actors), ``pubsub`` and
``check_serialize`` on the runtime; and the observability modules
``metrics``, ``tracing``, ``phases``, ``waterfall``, ``slo``, ``state``,
``grafana``, ``otlp`` and ``device_prof``. ``ActorPool`` and ``Queue``
resolve here, as the reference's names do."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)


def __getattr__(name):
    import importlib

    for mod in ("actor_pool", "queue", "metrics", "state"):
        try:
            m = importlib.import_module(f"ray_tpu_torch.util.{mod}")
        except ImportError:
            continue
        if hasattr(m, name):
            return getattr(m, name)
        if mod == name:
            return m
    raise AttributeError(name)
