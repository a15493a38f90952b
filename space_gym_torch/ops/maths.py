"""Small batched lookups used by the reset path."""
from __future__ import annotations

import torch


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
