"""Observation/action spaces (gymnasium-compatible subset; copy of
``ray_tpu/rl/spaces.py``).

The reference consumes gymnasium spaces throughout RLlib; this image ships
no gym, so the rl package defines the two spaces its algorithms need with the
same attribute surface (``shape``, ``dtype``, ``n``, ``low``, ``high``,
``sample``, ``contains``) so user envs written against gymnasium drop in.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Space:
    shape: tuple
    dtype: np.dtype

    def sample(self, rng: Optional[np.random.Generator] = None):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(0, self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"

    def __eq__(self, other):
        return isinstance(other, Discrete) and other.n == self.n


class Box(Space):
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        lo = np.where(np.isfinite(self.low), self.low, -1.0)
        hi = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(lo, hi, size=self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= self.low - 1e-6)) and bool(
            np.all(x <= self.high + 1e-6)
        )

    def __repr__(self):
        return f"Box{self.shape}"

    def __eq__(self, other):
        return (
            isinstance(other, Box)
            and other.shape == self.shape
            and np.allclose(other.low, self.low)
            and np.allclose(other.high, self.high)
        )
