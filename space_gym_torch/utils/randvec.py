"""Bulk randomness for the batched engine.

One `(B, n)` uniform draw per reset (and per step, for the full-step kernel),
consumed through a cursor.  `RandSource` is the batched twin of
space_gym_tpu/utils/randvec.py::RandSource: where the JAX one holds one lane's
`(n,)` vector under `vmap`, this one holds all lanes' `(B, n)` block and every
sampler returns a leading lane axis.  The consumption order is fixed by
program structure, so the same `u` gives the same draws on both sides.
"""
from __future__ import annotations

import torch


class RandSource:
    """Cursor over a (B, n) block of iid U[0,1) draws."""

    def __init__(self, u: torch.Tensor):
        if u.dim() != 2:
            raise ValueError(f"RandSource wants a (B, n) block, got shape {tuple(u.shape)}")
        self.u = u
        self.i = 0

    def take(self, n: int) -> torch.Tensor:
        """Next n uniforms per lane, shape (B, n)."""
        if self.i + n > self.u.shape[1]:
            raise ValueError(f"RandSource exhausted: need {self.i + n} of {self.u.shape[1]}")
        out = self.u[:, self.i : self.i + n]
        self.i += n
        return out

    def _take_one_or_n(self, n):
        u = self.take(1 if n is None else n)
        return u[:, 0] if n is None else u

    def uniform(self, n: int | None = None, minval=0.0, maxval=1.0) -> torch.Tensor:
        return minval + self._take_one_or_n(n) * (maxval - minval)

    def normal(self, n: int | None = None) -> torch.Tensor:
        """Standard normal via the inverse CDF, with the uniform clipped into
        the open interval (randvec.py:56-63)."""
        u = self._take_one_or_n(n)
        fi = torch.finfo(u.dtype)
        epsneg = fi.eps / 2  # 1 - epsneg is the largest float below 1
        return torch.special.ndtri(torch.clamp(u, fi.tiny, 1 - epsneg))

    def bernoulli(self, p: float) -> torch.Tensor:
        return self.take(1)[:, 0] < p

    def randint(self, maxval: int) -> torch.Tensor:
        """Uniform int in [0, maxval)."""
        v = (self.take(1)[:, 0] * maxval).to(torch.int32)
        return torch.clamp(v, max=maxval - 1)

    def permutation(self, n: int) -> torch.Tensor:
        """Uniform random permutation of range(n) per lane (argsort of iid uniforms)."""
        return torch.argsort(self.take(n), dim=1, stable=True).to(torch.int32)

    def scores(self, n: int) -> torch.Tensor:
        return self.take(n)

    def disk(self, radius: torch.Tensor) -> torch.Tensor:
        """Uniform point(s) in disk(s): angle first, then radius
        (helpers.py:48-53).  radius () -> (B, 2); radius (M,) -> (B, M, 2)."""
        m = radius.shape[0] if radius.dim() else 1
        angle = self.take(m) * (2 * torch.pi)
        r = torch.sqrt(self.take(m) * radius.reshape(-1) ** 2)
        out = r[..., None] * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
        return out if radius.dim() else out[:, 0]
