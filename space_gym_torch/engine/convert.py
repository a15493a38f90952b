"""Carry an env state between space_gym_tpu and this package as numpy arrays.

These envs have no weights: the state and the EnvConfig are all there is to
carry, so a JAX `EnvState` mapped to numpy (`jax.tree.map(np.asarray, s)`)
can be stepped here, and a state from here can be stepped there.  Field names
and layouts are the same on both sides (lane axis first).
"""
from __future__ import annotations

import numpy as np
import torch

from ..tiling.device import TilingState
from .core import EnvState


def state_from_numpy(s, device="cpu", dtype=torch.float32) -> EnvState:
    """Any object with EnvState's fields holding numpy arrays -> EnvState of
    tensors on `device`; floats in `dtype`, counters int32, flags bool."""
    def f(a):
        return torch.tensor(np.asarray(a), device=device).to(dtype)

    def i(a):
        return torch.tensor(np.asarray(a), device=device).to(torch.int32)

    def b(a):
        return torch.tensor(np.asarray(a), device=device).bool()

    ts = None
    if s.tiling is not None:
        t = s.tiling
        ts = TilingState(free=i(t.free), ship_tile=i(t.ship_tile), goal_tile=i(t.goal_tile),
                         case_b=b(t.case_b), flip_xy=b(t.flip_xy), col_shift=f(t.col_shift))
    return EnvState(y=f(s.y), planets_pos=f(s.planets_pos), goal_pos=f(s.goal_pos),
                    ref_orbit=f(s.ref_orbit), tiling=ts, steps=i(s.steps))


def state_to_numpy(state: EnvState) -> EnvState:
    """EnvState of tensors -> the same NamedTuples holding numpy arrays."""
    def n(t):
        return t.detach().cpu().numpy()

    ts = None
    if state.tiling is not None:
        ts = TilingState(*[n(t) for t in state.tiling])
    return EnvState(y=n(state.y), planets_pos=n(state.planets_pos), goal_pos=n(state.goal_pos),
                    ref_orbit=n(state.ref_orbit), tiling=ts, steps=n(state.steps))
