"""Small batched maths: lookups of the reset path and the vector primitives
of the fixed-substep physics (space_gym_tpu/ops/maths.py, lane axis first).
In the parity mode (ops/exact.py) the trigonometry, norms, powers and
divisions round as the reference's numpy does."""
from __future__ import annotations

import torch

from . import exact
from .constants import G


def angle_to_unit_vector(angle: torch.Tensor) -> torch.Tensor:
    """[cos a, sin a] stacked on a trailing axis (helpers.py:4-5)."""
    return torch.stack([exact.cos(angle), exact.sin(angle)], dim=-1)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the trailing axis; np.linalg.norm's bits (BLAS
    dot) in the parity mode."""
    return exact.norm_last(v)


def gravity_force(from_pos, toward_pos, from_mass: float, toward_mass: float) -> torch.Tensor:
    """Newtonian gravity force vector from `from_pos` toward `toward_pos`
    (helpers.py:22-35), in the reference's order: the direction is normalised
    first, then scaled by G*m1*m2/d^2."""
    pos_diff = toward_pos - from_pos
    center_distance = norm2(pos_diff)[..., None]
    force_direction = pos_diff / center_distance
    # dist**2 upstream is a numpy SCALAR power, libm pow(x, 2.0), which
    # differs from x*x by an ulp on some inputs
    scalar_force = exact.rdivc(G * from_mass * toward_mass,
                               exact.powf(center_distance.squeeze(-1), 2))
    return force_direction * scalar_force[..., None]


def onehot_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` for a small leading axis, as a one-hot masked sum.

    table: (n, ...); idx: (...) integer -> idx.shape + table.shape[1:].
    An index outside [0, n) gives zeros, like the JAX twin
    (space_gym_tpu/ops/maths.py::onehot_take); every sum has one nonzero term,
    so the result is exact.
    """
    n = table.shape[0]
    oh = idx[..., None] == torch.arange(n, dtype=idx.dtype, device=idx.device)
    extra = table.dim() - 1
    oh = oh.reshape(oh.shape + (1,) * extra)
    t = table.reshape((1,) * (oh.dim() - table.dim()) + tuple(table.shape))
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    return torch.where(oh, t, zero).sum(dim=-1 - extra, dtype=table.dtype)
