"""Ship parameters and steering constants (gym_space/ship_params.py:11-17,
gym_space/dynamic_model.py:138-141).

The vector field itself lives in ops/physics.py, component-major, as the plain
twin of the CUDA physics device function (csrc/physics.cuh).
"""
from __future__ import annotations

from typing import NamedTuple

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
