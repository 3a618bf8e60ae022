"""Resolution of ``@remote(...)`` / ``.options(...)`` keyword options.

Counterpart of the reference's ``python/ray/_private/ray_option_utils.py``:
one table of valid options shared by tasks and actors, resource keywords
folded into a resource dict, scheduling strategies validated. TPU chips are
first-class (``num_tpus`` → ``"TPU"`` resource), GPUs kept for logical-
resource parity in tests.
"""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

_COMMON = {
    "num_cpus", "num_gpus", "num_tpus", "memory", "resources", "name",
    "scheduling_strategy", "max_retries", "runtime_env", "num_returns",
    "placement_group", "placement_group_bundle_index",
    "placement_group_capture_child_tasks", "_metadata", "label_selector",
}
_ACTOR_ONLY = {"max_restarts", "max_task_retries", "max_concurrency", "concurrency_groups", "lifetime", "namespace", "get_if_exists"}


def validate(options: dict[str, Any], is_actor: bool) -> None:
    allowed = _COMMON | (_ACTOR_ONLY if is_actor else set())
    for k in options:
        if k not in allowed:
            raise ValueError(f"Invalid option {k!r} for {'actor' if is_actor else 'task'}")
    st = options.get("scheduling_strategy")
    pg = options.get("placement_group")
    if options.get("label_selector") and (
        st not in (None, "DEFAULT") or (pg is not None and pg != "default")
    ):
        # fail fast: to_strategy can honor only one placement policy, and
        # silently dropping the label constraint would mis-place the task
        raise ValueError(
            "label_selector cannot be combined with another placement policy "
            f"(scheduling_strategy={st!r}, placement_group={pg!r}); use "
            "NodeLabelSchedulingStrategy(hard=...) instead"
        )


def to_resources(options: dict[str, Any], is_actor: bool) -> dict[str, float]:
    res = dict(options.get("resources") or {})
    for key, rname in (("num_cpus", "CPU"), ("num_gpus", "GPU"), ("num_tpus", "TPU")):
        v = options.get(key)
        if v is not None:
            if v < 0:
                raise ValueError(f"{key} must be >= 0")
            res[rname] = float(v)
    if options.get("memory") is not None:
        res["memory"] = float(options["memory"])
    if "CPU" not in res:
        # Reference defaults: tasks take 1 CPU; actors take 0 for their
        # lifetime (they can oversubscribe — actor.py docstring in reference).
        res["CPU"] = 0.0 if is_actor else 1.0
    return res


def to_strategy(options: dict[str, Any]) -> Optional[tuple]:
    pg = options.get("placement_group")
    if pg is not None and pg != "default":
        return (
            "pg",
            pg.id if hasattr(pg, "id") else pg,
            options.get("placement_group_bundle_index", -1),
            options.get("placement_group_capture_child_tasks", False),
        )
    strategy = options.get("scheduling_strategy")
    if strategy is None or strategy == "DEFAULT":
        sel = options.get("label_selector")
        if sel:
            # label_selector = hard label requirements without a full
            # strategy object (reference: label_selector task option)
            return ("labels", tuple(sorted(sel.items())), ())
        return None
    if strategy == "SPREAD":
        return ("spread",)
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        return ("pg", pg.id, strategy.placement_group_bundle_index if strategy.placement_group_bundle_index is not None else -1, strategy.placement_group_capture_child_tasks)
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return ("node", strategy.node_id, strategy.soft)
    from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy

    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return (
            "labels",
            tuple(sorted(strategy.hard.items())),
            tuple(sorted(strategy.soft.items())),
        )
    raise ValueError(f"Unknown scheduling strategy: {strategy!r}")
