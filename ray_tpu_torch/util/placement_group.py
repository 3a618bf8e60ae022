"""Placement groups (reference: ``python/ray/util/placement_group.py:146`` +
GCS placement group manager / bundle scheduling policies).

On TPU pods these are the slice primitive: ``placement_group([{"TPU": 4}] *
n_hosts, strategy="STRICT_SPREAD")`` reserves one bundle per host of a slice,
and STRICT_PACK keeps a whole group inside one ICI domain.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.runtime import ObjectRef, get_ctx

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: bytes, bundles: list[dict]):
        self.id = pg_id
        self.bundle_specs = bundles

    def ready(self) -> ObjectRef:
        """An ObjectRef that resolves when all bundles are reserved
        (reference: ``PlacementGroup.ready()``)."""
        import threading

        from ray_tpu_torch._private import serialization as ser
        from ray_tpu_torch._private.ids import ObjectID

        ctx = get_ctx()
        pg_id = self.id
        obj_id = ObjectID.for_put().binary()
        ctx.call("add_ref", obj_id=obj_id)

        def fill():
            ctx.call("pg_ready", pg_id=pg_id, timeout=None)
            sv = ser.serialize(True)
            if hasattr(ctx, "head"):
                ctx.head.put_at(obj_id, sv)
            else:
                ctx.call("put", obj_id=obj_id, small=sv.to_bytes(), shm=None)

        threading.Thread(target=fill, daemon=True).start()
        return ObjectRef(obj_id, owned=True)

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        return get_ctx().call("pg_ready", pg_id=self.id, timeout=timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: list[dict],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy!r}; must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError("each bundle must be a non-empty resource dict")
        if any(v < 0 for v in b.values()):
            raise ValueError("bundle resources must be >= 0")
    pg_id = get_ctx().call("create_pg", bundles=bundles, strategy=strategy, name=name)
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    get_ctx().call("remove_pg", pg_id=pg.id)


def placement_group_table() -> list[dict]:
    # summary via nodes(); detailed table in the state API
    return []
