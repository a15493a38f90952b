"""Observation/action space descriptions for the compat adapter (old Gym Box/
Discrete semantics, spaceship_env.py:102-111,183-208); a copy of
space_gym_tpu/compat/spaces.py."""
from __future__ import annotations

import numpy as np


class Box:
    def __init__(self, low, high, dtype=np.float32):
        dtype = np.dtype(dtype)
        self.low = np.asarray(low).astype(dtype)
        self.high = np.asarray(high).astype(dtype)
        self.shape = self.low.shape
        self.dtype = dtype

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool(np.all(x >= self.low))
            and bool(np.all(x <= self.high))
        )

    def sample(self, rng=None):
        rng = rng or np.random
        low = np.where(np.isfinite(self.low), self.low, -1e3)
        high = np.where(np.isfinite(self.high), self.high, 1e3)
        return rng.uniform(low, high).astype(self.dtype)

    def __repr__(self):
        return f"Box{self.shape}"


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def contains(self, x) -> bool:
        if isinstance(x, (int, np.integer)):
            return 0 <= int(x) < self.n
        x = np.asarray(x)
        return x.ndim == 0 and np.issubdtype(x.dtype, np.integer) and 0 <= int(x) < self.n

    def sample(self, rng=None):
        rng = rng or np.random
        return int(rng.randint(self.n))

    def __repr__(self):
        return f"Discrete({self.n})"
