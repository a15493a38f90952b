"""Termination event functions, lane axis first.

Twin of space_gym_tpu/ops/events.py (gym_space/dynamic_model.py:183-217):
continuous functions of the state that are positive iff the state is
non-terminal; a termination fires on any sign change between two substep ends.

Event order (the tie-break order on simultaneous roots):
    [per-planet crash (P entries), world_max, world_min, angular_velocity]
"""
from __future__ import annotations

from typing import Sequence

import torch

from .maths import norm2


def make_event_fn(planet_radii: Sequence[float], world_size: float, max_abs_vel_angle: float):
    """Build `g(planets_pos (B, P, 2), y (B, 6)) -> (B, E)`, E = P + 3."""
    radii = tuple(float(r) for r in planet_radii)
    half = world_size / 2

    def event_fn(planets_pos: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        pos_xy = y[:, 0:2]
        planet_g = norm2(planets_pos - pos_xy[:, None, :]) - torch.tensor(
            radii, dtype=y.dtype, device=y.device)
        world_max = (half - pos_xy).min(dim=1).values
        world_min = (half + pos_xy).min(dim=1).values
        ang_vel = max_abs_vel_angle - torch.abs(y[:, 5])
        return torch.cat([planet_g, torch.stack([world_max, world_min, ang_vel], dim=1)], dim=1)

    return event_fn


def make_event_component_fns(planet_radii: Sequence[float], world_size: float,
                             max_abs_vel_angle: float):
    """Per-event versions of `make_event_fn`, each `(planets_pos, y) -> (B,)`:
    the fixed-substep integrator root-finds each event on its own."""
    radii = tuple(float(r) for r in planet_radii)
    half = world_size / 2

    fns = []
    for i, r in enumerate(radii):
        def planet_ev(planets_pos, y, i=i, r=r):
            return norm2(planets_pos[:, i] - y[:, 0:2]) - r

        fns.append(planet_ev)
    fns.append(lambda planets_pos, y: (half - y[:, 0:2]).min(dim=1).values)
    fns.append(lambda planets_pos, y: (half + y[:, 0:2]).min(dim=1).values)
    fns.append(lambda planets_pos, y: max_abs_vel_angle - torch.abs(y[:, 5]))
    return tuple(fns)


def crossings(g_old: torch.Tensor, g_new: torch.Tensor) -> torch.Tensor:
    """Sign-change mask of scipy's find_active_events with direction=0."""
    up = (g_old <= 0) & (g_new >= 0)
    down = (g_old >= 0) & (g_new <= 0)
    return up | down
