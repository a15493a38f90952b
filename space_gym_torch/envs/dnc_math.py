"""DoNotCrash analytic observation features on tensors (opt-in, trainer-side).

The port's own copy of space_gym_tpu/envs/dnc_math.py.  The raw observation is
[pos(2), cos/sin(angle), vel(2), vel_angle] and both obstacles sit at the
origin, so every survival-relevant quantity (annulus margins, radial and
tangential velocity, circular-orbit speed error, specific energy, the
omega-cap margin, thrust projections) is an analytic function of it.
"""
from __future__ import annotations

import torch

from ..ops.constants import G

MARGIN_GAINS = (1.0, 4.0, 16.0)   # annulus margins
VEL_GAINS = (1.0, 8.0)            # radial / tangential speeds
ORBIT_GAINS = (2.0, 8.0)          # orbit-speed error, specific energy
OMEGA_GAINS = (0.5, 2.0)          # omega-cap margin

N_DNC_FEATURES = (
    2 * len(MARGIN_GAINS)   # inner + outer annulus margins
    + 2 * len(VEL_GAINS)    # radial + tangential velocity
    + len(ORBIT_GAINS)      # circular-orbit speed error
    + len(ORBIT_GAINS)      # specific orbital energy
    + len(OMEGA_GAINS)      # omega-cap margin
    + 2                     # thrust radial/tangential alignment
    + 1                     # gravity magnitude
)

_EPS = 1e-8


def dnc_features(obs, *, planet_radius: float, border_radius: float, gm: float,
                 max_abs_vel_angle: float):
    """(..., 7) raw DNC observation -> (..., N_DNC_FEATURES)."""
    pos_x, pos_y = obs[..., 0], obs[..., 1]
    tx, ty = -obs[..., 2], -obs[..., 3]
    vx, vy = obs[..., 4], obs[..., 5]
    w = obs[..., 6]

    r = torch.sqrt(pos_x * pos_x + pos_y * pos_y)
    inv_r = 1.0 / torch.clamp(r, min=_EPS)
    rx, ry = pos_x * inv_r, pos_y * inv_r

    inner = r - planet_radius
    outer = border_radius - r
    v_rad = vx * rx + vy * ry
    v_tan = vx * ry - vy * rx

    v_circ = torch.sqrt(gm * inv_r)
    orbit_err = torch.abs(v_tan) - v_circ
    energy = 0.5 * (vx * vx + vy * vy) - gm * inv_r
    e_mid = -gm / (planet_radius + border_radius)
    w_margin = max_abs_vel_angle - torch.abs(w)

    align_rad = tx * rx + ty * ry
    align_tan = tx * ry - ty * rx

    feats = []
    feats += [torch.tanh(g * inner) for g in MARGIN_GAINS]
    feats += [torch.tanh(g * outer) for g in MARGIN_GAINS]
    feats += [torch.tanh(g * v_rad) for g in VEL_GAINS]
    feats += [torch.tanh(g * v_tan) for g in VEL_GAINS]
    feats += [torch.tanh(g * orbit_err) for g in ORBIT_GAINS]
    feats += [torch.tanh(g * (energy - e_mid)) for g in ORBIT_GAINS]
    feats += [torch.tanh(g * w_margin) for g in OMEGA_GAINS]
    feats += [align_rad, align_tan]
    feats += [torch.tanh(8.0 * gm * inv_r * inv_r)]
    return torch.stack(feats, dim=-1)


def features_for_config(obs, config):
    """dnc_features with constants pulled from an EnvConfig (envs/config.py)."""
    p = config.dnc
    return dnc_features(
        obs,
        planet_radius=p.planet_radius,
        border_radius=p.border_radius,
        gm=G * p.planet_mass,
        max_abs_vel_angle=config.max_abs_vel_angle,
    )
