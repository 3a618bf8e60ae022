"""Search spaces + variant generation (copy of ``ray_tpu/tune/search.py``:
the same draws from ``random``, so a seed gives the reference's variants).

Reference: ``python/ray/tune/search/`` — sample domains
(``tune/search/sample.py``), ``BasicVariantGenerator``
(``search/basic_variant.py``) expanding ``grid_search`` specs and sampling
stochastic domains, with ``num_samples`` repetitions.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        import math

        if self.log:
            return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


class Quantized(Domain):
    def __init__(self, inner: Domain, q: float):
        self.inner, self.q = inner, q

    def sample(self, rng):
        return round(self.inner.sample(rng) / self.q) * self.q


def quniform(lower: float, upper: float, q: float) -> Quantized:
    return Quantized(Float(lower, upper), q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def choice(categories) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values) -> dict:
    return {"grid_search": list(values)}


def _walk(space: dict, prefix=()):
    """Yield (path, value) leaves of a nested param space."""
    for k, v in space.items():
        path = prefix + (k,)
        if isinstance(v, dict) and "grid_search" not in v:
            yield from _walk(v, path)
        else:
            yield path, v


def _set_path(d: dict, path: tuple, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


class BasicVariantGenerator:
    """Grid × random expansion (reference ``search/basic_variant.py``)."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)

    def generate(self, space: dict, num_samples: int = 1) -> list[dict]:
        leaves = list(_walk(space or {}))
        grid_leaves = []
        grid_values = []
        for path, v in leaves:
            if isinstance(v, dict) and "grid_search" in v:
                grid_leaves.append(path)
                grid_values.append(v["grid_search"])
            elif isinstance(v, GridSearch):
                grid_leaves.append(path)
                grid_values.append(v.values)
        configs = []
        grid_combos = list(itertools.product(*grid_values)) if grid_values else [()]
        for _ in range(num_samples):
            for combo in grid_combos:
                cfg: dict = {}
                for path, v in leaves:
                    if isinstance(v, Domain):
                        _set_path(cfg, path, v.sample(self.rng))
                    elif isinstance(v, GridSearch) or (isinstance(v, dict) and "grid_search" in v):
                        pass  # filled from the grid combo below
                    else:
                        _set_path(cfg, path, v)
                for path, val in zip(grid_leaves, combo):
                    _set_path(cfg, path, val)
                configs.append(cfg)
        return configs
