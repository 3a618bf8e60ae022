"""Scheduling strategies (reference: ``python/ray/util/scheduling_strategies.py:15-135``).

``"DEFAULT"`` — hybrid pack/spread; ``"SPREAD"`` — least-utilized node;
``PlacementGroupSchedulingStrategy`` — run inside a reserved bundle;
``NodeAffinitySchedulingStrategy`` — pin to a node (hard or soft).
On TPU pods, placement groups are the slice-aware primitive: a STRICT_PACK
group over a slice's hosts keeps a mesh's participants inside one ICI domain.
"""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: Optional[int] = None,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    """Label-based node selection (reference node-label policy); hard
    requirements only in this round."""

    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}
