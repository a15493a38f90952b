"""Goal-task analytic observation features on tensors (opt-in, trainer-side).

The port's own copy of space_gym_tpu/envs/goal_math.py: functions of the raw
observation and static config constants only.

Raw Goal obs layout (spaceship_env.py:113-131):
  [0:2]  pos_xy          [2:4]  cos/sin(angle)   [4:6]  vel_xy   [6] vel_angle
  [7:7+2n] planet lidars: unit(ship->planet) * (center_dist - R) * 2/W
  [-2:]  goal lidar:      unit(ship->goal)   * center_dist * 2/W
"""
from __future__ import annotations

import torch

from ..ops.constants import G

DIST_GAINS = (1.0, 4.0, 16.0, 64.0)   # goal-distance margin
DANGER_GAINS = (1.0, 4.0, 16.0)       # closest-planet / border margins
VEL_GAINS = (1.0, 8.0)                # closing / crossing speeds
GRAV_GAINS = (2.0, 16.0)              # local gravity (|a| ~ 0.02-0.6)

N_GOAL_FEATURES = (
    len(DIST_GAINS)        # goal-distance margin
    + 2 * len(VEL_GAINS)   # goal closing + crossing speed
    + 2                    # thrust/goal alignment (cos, sin)
    + len(DANGER_GAINS)    # closest-planet margin
    + len(VEL_GAINS)       # closing speed toward closest planet
    + 1                    # thrust/closest-planet alignment
    + 2 * len(GRAV_GAINS)  # net gravity vector
    + 2                    # gravity projected on goal dir / thrust dir
    + 2 * len(DANGER_GAINS)  # border margins (x, y)
    + 2                    # border approach speeds
)

_EPS = 1e-8


def goal_features(obs, *, n_planets: int, world_size: float, planet_radius: float,
                  goal_radius: float, danger_zone: float, gm_per_planet: float):
    """(..., obs_dim) raw Goal observation -> (..., N_GOAL_FEATURES), every
    output tanh-bounded or a cosine; distances come from lidar norms, planet
    positions are recovered from lidars for the gravity term, and thrust acts
    along -(cos, sin) of the ship angle."""
    half_w = world_size / 2.0
    pos_x, pos_y = obs[..., 0], obs[..., 1]
    tx, ty = -obs[..., 2], -obs[..., 3]
    vx, vy = obs[..., 4], obs[..., 5]

    # goal block: lidar -> distance + unit direction
    gx_l, gy_l = obs[..., -2], obs[..., -1]
    g_norm = torch.sqrt(gx_l * gx_l + gy_l * gy_l)
    goal_dist = g_norm * half_w
    inv_g = 1.0 / torch.clamp(g_norm, min=_EPS)
    ghx, ghy = gx_l * inv_g, gy_l * inv_g
    v_close = vx * ghx + vy * ghy
    v_cross = vx * ghy - vy * ghx
    align_c = tx * ghx + ty * ghy
    align_s = tx * ghy - ty * ghx
    goal_margin = goal_dist - goal_radius

    # closest-planet block + net gravity
    min_surf = min_ux = min_uy = None
    grav_x = grav_y = 0.0
    for i in range(n_planets):
        lx, ly = obs[..., 7 + 2 * i], obs[..., 8 + 2 * i]
        nrm = torch.sqrt(lx * lx + ly * ly)
        surf = nrm * half_w
        inv = 1.0 / torch.clamp(nrm, min=_EPS)
        ux, uy = lx * inv, ly * inv
        center_dist = surf + planet_radius
        a = gm_per_planet / torch.clamp(center_dist * center_dist, min=_EPS)
        grav_x = grav_x + a * ux
        grav_y = grav_y + a * uy
        if min_surf is None:
            min_surf, min_ux, min_uy = surf, ux, uy
        else:
            closer = surf < min_surf
            min_ux = torch.where(closer, ux, min_ux)
            min_uy = torch.where(closer, uy, min_uy)
            min_surf = torch.minimum(surf, min_surf)

    danger_margin = min_surf - danger_zone
    v_danger = vx * min_ux + vy * min_uy
    align_danger = tx * min_ux + ty * min_uy
    grav_close = grav_x * ghx + grav_y * ghy
    grav_thrust = grav_x * tx + grav_y * ty

    # border block
    border_x = half_w - torch.abs(pos_x)
    border_y = half_w - torch.abs(pos_y)
    v_border_x = torch.sign(pos_x) * vx
    v_border_y = torch.sign(pos_y) * vy

    feats = []
    feats += [torch.tanh(g * goal_margin) for g in DIST_GAINS]
    feats += [torch.tanh(g * v_close) for g in VEL_GAINS]
    feats += [torch.tanh(g * v_cross) for g in VEL_GAINS]
    feats += [align_c, align_s]
    feats += [torch.tanh(g * danger_margin) for g in DANGER_GAINS]
    feats += [torch.tanh(g * v_danger) for g in VEL_GAINS]
    feats += [align_danger]
    feats += [torch.tanh(g * grav_x) for g in GRAV_GAINS]
    feats += [torch.tanh(g * grav_y) for g in GRAV_GAINS]
    feats += [torch.tanh(8.0 * grav_close), torch.tanh(8.0 * grav_thrust)]
    feats += [torch.tanh(g * (border_x - danger_zone)) for g in DANGER_GAINS]
    feats += [torch.tanh(g * (border_y - danger_zone)) for g in DANGER_GAINS]
    feats += [torch.tanh(4.0 * v_border_x), torch.tanh(4.0 * v_border_y)]
    return torch.stack(feats, dim=-1)


def features_for_config(obs, config):
    """goal_features with constants pulled from an EnvConfig (envs/config.py)."""
    return goal_features(
        obs,
        n_planets=config.n_planets,
        world_size=config.world_size,
        planet_radius=config.planet_radii[0],
        goal_radius=config.goal_radius,
        danger_zone=config.goal.danger_zone,
        gm_per_planet=G * config.planet_masses[0],
    )
