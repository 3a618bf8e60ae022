"""Logical plan: lazy operator DAG + fusion rules (copy of
``ray_tpu/data/plan.py``; a map asks for cards with ``num_gpus``).

Reference: ``python/ray/data/_internal/logical/`` (operators + optimizer
rules) and ``planner/``. The plan here is a linear chain per dataset (unions
and zips hold child plans), optimized by fusing adjacent one-to-one ops into
a single ``MapChain`` so one remote task applies the whole fused transform
per block — the same task-fusion rule the reference's
``OperatorFusionRule`` implements.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

from ray_tpu_torch.data.datasource import Datasource


@dataclass
class LogicalOp:
    name: str = field(default="", init=False)

    def is_one_to_one(self) -> bool:
        return False


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1

    def __post_init__(self):
        self.name = f"Read{self.datasource.name}"


@dataclass
class InputData(LogicalOp):
    """Already-materialized (block_ref, metadata) bundles (e.g. materialize())."""

    bundles: list

    def __post_init__(self):
        self.name = "InputData"


@dataclass
class AbstractMap(LogicalOp):
    fn: Any
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = field(default_factory=dict)
    compute: Optional[Any] = None  # None => tasks; ActorPoolStrategy => actors
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    concurrency: Optional[Any] = None

    def is_one_to_one(self) -> bool:
        return True

    def uses_actors(self) -> bool:
        return isinstance(self.fn, type) or self.compute is not None


@dataclass
class MapBatches(AbstractMap):
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    zero_copy_batch: bool = False

    def __post_init__(self):
        self.name = f"MapBatches({_fn_name(self.fn)})"


@dataclass
class MapRows(AbstractMap):
    def __post_init__(self):
        self.name = f"Map({_fn_name(self.fn)})"


@dataclass
class FlatMap(AbstractMap):
    def __post_init__(self):
        self.name = f"FlatMap({_fn_name(self.fn)})"


@dataclass
class Filter(AbstractMap):
    def __post_init__(self):
        self.name = f"Filter({_fn_name(self.fn)})"


@dataclass
class Project(AbstractMap):
    """select_columns / drop_columns / rename / add_column."""

    def __post_init__(self):
        self.name = "Project"


@dataclass
class Limit(LogicalOp):
    limit: int = 0

    def __post_init__(self):
        self.name = f"Limit({self.limit})"


@dataclass
class AllToAll(LogicalOp):
    """Barrier ops: repartition / random_shuffle / sort / aggregate."""

    kind: str = ""
    options: dict = field(default_factory=dict)

    def __post_init__(self):
        self.name = self.kind.capitalize() or "AllToAll"


@dataclass
class Union(LogicalOp):
    others: list = field(default_factory=list)  # list[LogicalPlan]

    def __post_init__(self):
        self.name = "Union"


@dataclass
class Zip(LogicalOp):
    other: Any = None  # LogicalPlan

    def __post_init__(self):
        self.name = "Zip"


@dataclass
class MapChain(LogicalOp):
    """Fused chain of one-to-one ops, executed inside a single task."""

    ops: list = field(default_factory=list)

    def __post_init__(self):
        self.name = "->".join(op.name for op in self.ops) or "MapChain"

    def is_one_to_one(self) -> bool:
        return True


def _fn_name(fn) -> str:
    return getattr(fn, "__name__", type(fn).__name__)


class LogicalPlan:
    """A chain of logical ops rooted at a Read/InputData."""

    def __init__(self, ops: Optional[list[LogicalOp]] = None):
        self.ops: list[LogicalOp] = ops or []

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def copy(self) -> "LogicalPlan":
        return LogicalPlan(list(self.ops))

    def optimized(self) -> "LogicalPlan":
        """Fuse adjacent one-to-one task-compute ops into MapChains."""
        out: list[LogicalOp] = []
        for op in self.ops:
            fusible = (
                isinstance(op, AbstractMap)
                and not op.uses_actors()
                and op.num_cpus is None
                and op.num_gpus is None
            )
            if (
                fusible
                and out
                and isinstance(out[-1], MapChain)
            ):
                prev = out[-1]
                out[-1] = MapChain(ops=prev.ops + [op])
            elif fusible:
                out.append(MapChain(ops=[op]))
            else:
                out.append(copy.copy(op))
        return LogicalPlan(out)

    def __repr__(self):
        return " -> ".join(op.name for op in self.ops)
