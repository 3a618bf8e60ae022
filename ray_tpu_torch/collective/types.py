"""Collective types: reduce ops and group metadata (copy of
``ray_tpu/collective/types.py``).

Reference: ``python/ray/util/collective/types.py`` (ReduceOp enum, options
dataclasses). A ReduceOp maps to the numpy ufunc the host backend combines
with.
"""

from __future__ import annotations

import dataclasses
import enum


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"

    def combine(self, a, b):
        import numpy as np

        if self is ReduceOp.SUM:
            return np.add(a, b)
        if self is ReduceOp.PRODUCT:
            return np.multiply(a, b)
        if self is ReduceOp.MIN:
            return np.minimum(a, b)
        return np.maximum(a, b)


@dataclasses.dataclass
class GroupInfo:
    group_name: str
    world_size: int
    rank: int
    backend: str
