"""DataContext: per-driver execution knobs (copy of ``ray_tpu/data/context.py``).

Reference: ``python/ray/data/context.py`` (DataContext singleton with
target block sizes, op resource limits). Kept deliberately small; every
field is read by the streaming executor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataContext:
    # Re-chunk map outputs toward this size (reference default 128 MiB).
    target_max_block_size: int = 128 * 1024 * 1024
    # Max rows per block regardless of bytes (keeps batches bounded).
    target_max_rows_per_block: int = 1_000_000
    # Per-operator concurrent-task cap (reference derives from cluster size).
    max_tasks_per_op: int = 8
    # Global backpressure: pause dispatch when un-consumed downstream output
    # exceeds this many bytes (reference: StreamingExecutor resource budget).
    max_buffered_bytes: int = 2 * 1024 * 1024 * 1024
    # Default parallelism for reads when not specified (-1 = auto).
    read_parallelism: int = -1
    # Min blocks auto parallelism aims for.
    min_parallelism: int = 8
    # Shuffle partitions cap.
    max_shuffle_partitions: int = 64
    # Seed for shuffles when unset.
    shuffle_seed: Optional[int] = None
    # Actor-pool map: max in-flight bundles per actor.
    max_tasks_in_flight_per_actor: int = 2
    enable_operator_fusion: bool = True

    _current: "DataContext" = None  # class-level singleton, set below

    @staticmethod
    def get_current() -> "DataContext":
        if DataContext._current is None:
            DataContext._current = DataContext()
        return DataContext._current
