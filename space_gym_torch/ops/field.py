"""Ship parameters and steering constants (gym_space/ship_params.py:11-17,
gym_space/dynamic_model.py:138-141).

The kernels' vector field lives in ops/physics.py, component-major, as the
plain twin of the CUDA physics device function (csrc/physics.cuh).  The
functions here are the lane-first `(B, 6)` twins of
space_gym_tpu/ops/field.py, used by the fixed-substep tier (ops/fixed_rk.py).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import exact, maths

STEERING_ACCELERATION = 0
STEERING_VELOCITY = 1
# dynamic_model.py:140 (the comment upstream says 4, the code says 5.0)
VELOCITY_STEERING_SCALE = 5.0


class ShipParams(NamedTuple):
    """Static ship parameters (gym_space/ship_params.py:11-17)."""

    steering: int  # 0 = acceleration, 1 = velocity
    mass: float
    moi: float  # moment of inertia
    max_engine_force: float
    max_thruster_force: float


def apply_steering_override(ship: ShipParams, y: torch.Tensor, action: torch.Tensor,
                            f32_action: bool = False) -> torch.Tensor:
    """Pre-step fixup equal to the reference's in-place RHS mutation: in
    velocity steering omega := thruster * 5.0 (dynamic_model.py:138-141).
    `f32_action=True` rounds the value through float32 first, as the
    continuous envs' float32 action does upstream.  y (B, 6), action (B, 2)."""
    if ship.steering != STEERING_VELOCITY:
        return y
    thr = action[..., 1]
    if f32_action:
        scale = torch.tensor(VELOCITY_STEERING_SCALE, dtype=torch.float32, device=y.device)
        val = (thr.to(torch.float32) * scale).to(y.dtype)
    else:
        val = VELOCITY_STEERING_SCALE * thr
    return torch.cat([y[..., :5], val[..., None]], dim=-1)


def ship_vector_field(ship: ShipParams, planet_masses: Sequence[float],
                      planets_pos: torch.Tensor, action: torch.Tensor, y: torch.Tensor,
                      f32_action: bool = False) -> torch.Tensor:
    """dy/dt of the ship (dynamic_model.py:129-176): planets_pos (B, P, 2),
    action (B, 2) = (engine in [0,1], thruster in [-1,1]), y (B, 6).  Gravity
    is summed planet by planet in order.  `f32_action=True` keeps the products
    of the action with the ship constants in float32, as NumPy does upstream."""
    engine_action = action[..., 0]
    thruster_action = action[..., 1]
    pos_xy = y[..., 0:2]
    angle = y[..., 2]

    if f32_action:
        def c32(v):
            return torch.tensor(v, dtype=torch.float32, device=y.device)

        engine_force_scalar = (engine_action.to(torch.float32)
                               * c32(ship.max_engine_force)).to(y.dtype)
        ext_force_angle_f32 = thruster_action.to(torch.float32) * c32(ship.max_thruster_force)
        ext_force_angle = ext_force_angle_f32.to(y.dtype)
    else:
        engine_force_scalar = engine_action * ship.max_engine_force
        ext_force_angle = thruster_action * ship.max_thruster_force
    engine_force_direction = -maths.angle_to_unit_vector(angle)
    force_xy = engine_force_direction * engine_force_scalar[..., None]

    for i, mass in enumerate(planet_masses):
        force_xy = force_xy + maths.gravity_force(pos_xy, planets_pos[..., i, :], ship.mass, mass)
    # exact.divc: numpy divides by the constant ship mass; the card would
    # multiply by its reciprocal (parity-mode guard)
    acceleration_xy = exact.divc(force_xy, ship.mass)

    if ship.steering == STEERING_ACCELERATION:
        if f32_action:
            acceleration_angle = (ext_force_angle_f32 / c32(ship.moi)).to(y.dtype)
        else:
            acceleration_angle = exact.divc(ext_force_angle, ship.moi)
    else:
        acceleration_angle = torch.zeros_like(ext_force_angle)

    return torch.cat([y[..., 3:6], acceleration_xy, acceleration_angle[..., None]], dim=-1)


def wrap_ship_angle(y: torch.Tensor) -> torch.Tensor:
    """theta := theta mod 2*pi after each control step (dynamic_model.py:179-180)."""
    return torch.cat([y[..., :2], torch.remainder(y[..., 2:3], 2 * torch.pi), y[..., 3:]], dim=-1)
