"""Aggregation functions for groupby/global aggregation (copy of
``ray_tpu/data/aggregate.py``).

Reference: ``python/ray/data/aggregate.py`` (AggregateFn; Count/Sum/Min/Max/
Mean/Std/AbsMax). Each agg is a (partial, merge, finalize) triple applied to
numpy column batches — map-side partials keep the exchange small.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


class AggregateFn:
    name: str = "agg"

    def partial(self, batch: dict) -> Any:
        raise NotImplementedError

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def finalize(self, state: Any) -> Any:
        return state


class Count(AggregateFn):
    def __init__(self):
        self.name = "count()"

    def partial(self, batch):
        return len(next(iter(batch.values()))) if batch else 0

    def merge(self, a, b):
        return a + b


class _ColumnAgg(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"{type(self).__name__.lower()}({on})"


class Sum(_ColumnAgg):
    def partial(self, batch):
        return np.asarray(batch[self.on]).sum()

    def merge(self, a, b):
        return a + b

    def finalize(self, state):
        return state.item() if hasattr(state, "item") else state


class Min(_ColumnAgg):
    def partial(self, batch):
        return np.asarray(batch[self.on]).min()

    def merge(self, a, b):
        return min(a, b)

    def finalize(self, state):
        return state.item() if hasattr(state, "item") else state


class Max(_ColumnAgg):
    def partial(self, batch):
        return np.asarray(batch[self.on]).max()

    def merge(self, a, b):
        return max(a, b)

    def finalize(self, state):
        return state.item() if hasattr(state, "item") else state


class Mean(_ColumnAgg):
    def partial(self, batch):
        v = np.asarray(batch[self.on])
        return (v.sum(), len(v))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, state):
        s, n = state
        out = s / n if n else float("nan")
        return out.item() if hasattr(out, "item") else out


class Std(_ColumnAgg):
    """Parallel Welford merge (matches the reference's chunked Std)."""

    def __init__(self, on: str, ddof: int = 1):
        super().__init__(on)
        self.ddof = ddof
        self.name = f"std({on})"

    def partial(self, batch):
        v = np.asarray(batch[self.on], dtype=np.float64)
        n = len(v)
        mean = v.mean() if n else 0.0
        m2 = ((v - mean) ** 2).sum() if n else 0.0
        return (n, mean, m2)

    def merge(self, a, b):
        na, ma, m2a = a
        nb, mb, m2b = b
        n = na + nb
        if n == 0:
            return (0, 0.0, 0.0)
        delta = mb - ma
        mean = ma + delta * nb / n
        m2 = m2a + m2b + delta * delta * na * nb / n
        return (n, mean, m2)

    def finalize(self, state):
        n, _, m2 = state
        if n - self.ddof <= 0:
            return float("nan")
        return float(np.sqrt(m2 / (n - self.ddof)))


class AbsMax(_ColumnAgg):
    def partial(self, batch):
        v = np.asarray(batch[self.on])
        return np.abs(v).max() if len(v) else 0

    def merge(self, a, b):
        return max(a, b)

    def finalize(self, state):
        return state.item() if hasattr(state, "item") else state
