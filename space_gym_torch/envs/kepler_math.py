"""Kepler reference-orbit maths on tensors (gym_space/envs/kepler.py:43-150),
and the orbit's invariants (specific energy, angular momentum, the
Laplace-Runge-Lenz vector) that the property tests hold the integrators to.

The port's own copy of space_gym_tpu/envs/kepler_math.py, in the reference's
operation order; every function broadcasts over leading lane axes.  As there,
the reward functions take the operations that must round as numpy's from an
`xp` argument: plain PyTorch by default, ops/exact.py's `exact_xp` in the
parity engine.
"""
from __future__ import annotations

import torch


class _TorchOps:
    """The default `xp` of the reward functions: plain PyTorch, today's
    expressions.  The parity engine hands ops/exact.py's `exact_xp` instead,
    whose operations round as the reference's numpy does (libm cos, sin and
    pow, np.arctan2, numpy's BLAS norm and matrix-vector product, true
    divisions of a constant)."""

    class _Linalg:
        @staticmethod
        def norm(v):
            return torch.linalg.norm(v, dim=-1)

    linalg = _Linalg()
    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    sqrt = staticmethod(torch.sqrt)
    arctan2 = staticmethod(torch.atan2)
    dot = None  # `rotate` multiplies the 2x2 product out

    @staticmethod
    def pow2(v):
        return v ** 2

    @staticmethod
    def rdiv(c, x):
        return c / x


TORCH_OPS = _TorchOps()


def semi_minor(a, ecc, xp=TORCH_OPS):
    """Semi-minor axis (kepler.py:43-45)."""
    return xp.sqrt(a * a * (1 - ecc * ecc))


def focal_dist(a, b, xp=TORCH_OPS):
    """Focal-point distance from the ellipse centre (kepler.py:47-49)."""
    return xp.sqrt(a * a - b * b)


def rotate(pos_xy, alpha, xp=TORCH_OPS):
    """Rotation by alpha, the reference's 2x2 matrix product (kepler.py:51-58):
    multiplied out by default, numpy's dgemv of the stacked matrix where
    `xp` has a `dot`."""
    c, s = xp.cos(alpha), xp.sin(alpha)
    if xp.dot is None:
        x, y = pos_xy[..., 0], pos_xy[..., 1]
        return torch.stack([c * x + s * y, -s * x + c * y], dim=-1)
    R = torch.stack([torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)], dim=-2)
    return xp.dot(R, pos_xy)


def orbit_vel(alpha_gm, r, ref_a, xp=TORCH_OPS):
    """Vis-viva speed on the reference orbit (kepler.py:60-62)."""
    return xp.sqrt(alpha_gm * (xp.rdiv(2, r) - xp.rdiv(1, ref_a)))


def _shifted_wz(pos_xy, ref_angle, a, ecc, xp):
    b = semi_minor(a, ecc, xp)
    pos_wz = rotate(pos_xy, ref_angle, xp)
    c = focal_dist(a, b, xp)
    return torch.stack([pos_wz[..., 0] - c, pos_wz[..., 1]], dim=-1), b, c


def orbit_target_vel(alpha_gm, pos_xy, ref_angle, ref_a, ecc, curl=1.0, xp=TORCH_OPS):
    """Tangential target velocity on the reference ellipse (kepler.py:64-88)."""
    a = ref_a
    norm = xp.linalg.norm
    pos_wz, b, c = _shifted_wz(pos_xy, ref_angle, a, ecc, xp)
    theta = xp.arctan2(pos_wz[..., 1], pos_wz[..., 0])
    target_rad = b / xp.sqrt(1 - xp.pow2(ecc * xp.cos(theta)))
    pos_wz = pos_wz * target_rad[..., None] / norm(pos_wz)[..., None]
    vt = torch.stack([-curl * a / b * pos_wz[..., 1], curl * b / a * pos_wz[..., 0]], dim=-1)
    r = norm(pos_wz + torch.stack([c, torch.zeros_like(c)], dim=-1))
    vt = vt * orbit_vel(alpha_gm, r, a, xp)[..., None] / norm(vt)[..., None]
    return rotate(vt, -ref_angle, xp)


def orbit_cur_rad(pos_xy, ref_angle, ref_a, ecc, xp=TORCH_OPS):
    """Current radius from the occupied focal point (kepler.py:90-96)."""
    return xp.linalg.norm(_shifted_wz(pos_xy, ref_angle, ref_a, ecc, xp)[0])


def orbit_target_rad(pos_xy, ref_angle, ref_a, ecc, xp=TORCH_OPS):
    """Reference-orbit radius at the current angle (kepler.py:98-109)."""
    pos_wz, b, _ = _shifted_wz(pos_xy, ref_angle, ref_a, ecc, xp)
    theta = xp.arctan2(pos_wz[..., 1], pos_wz[..., 0])
    return b / xp.sqrt(1 - xp.pow2(ecc * xp.cos(theta)))


def dense_reward(alpha_gm, pos_xy, vel_xy, act_penalty, ref_angle, ref_a, ecc,
                 numerator_C, rad_penalty_C, act_penalty_C, xp=TORCH_OPS):
    """_dense_reward5 (kepler.py:111-150): approaches 1 as the radius, velocity
    and action-energy deviations from the reference orbit vanish.  `xp`: the
    operations that round differently from numpy (TORCH_OPS, or
    ops/exact.py's exact_xp for bitwise parity)."""
    cur_rad = orbit_cur_rad(pos_xy, ref_angle, ref_a, ecc, xp)
    target_vel = orbit_target_vel(alpha_gm, pos_xy, ref_angle, ref_a, ecc, xp=xp)
    target_rad = orbit_target_rad(pos_xy, ref_angle, ref_a, ecc, xp)
    rad_penalty = torch.abs(cur_rad - target_rad)
    vel_x_penalty = torch.abs(target_vel[..., 0] - vel_xy[..., 0])
    vel_y_penalty = torch.abs(target_vel[..., 1] - vel_xy[..., 1])
    C = numerator_C
    return xp.rdiv(C, rad_penalty_C * rad_penalty + vel_x_penalty + vel_y_penalty
                   + act_penalty_C * act_penalty + C)


# Multi-scale tanh gains of `error_features`: one feature stays in its linear
# range at every error magnitude from O(1) down to ~1e-5.
FEATURE_GAINS = (1.0, 8.0, 64.0, 512.0)
N_ERROR_FEATURES = 3 * len(FEATURE_GAINS)  # (rad_err, vel_err_x, vel_err_y)


def error_features(alpha_gm, pos_xy, vel_xy, ref_angle, ecc, a):
    """Orbit-deviation features, analytic functions of the raw observation:
    the radial error and both components of target_vel - vel (the penalty
    terms of _dense_reward5), each through tanh at FEATURE_GAINS.
    Returns (..., N_ERROR_FEATURES)."""
    ca, sa = torch.cos(ref_angle), torch.sin(ref_angle)
    x, y = pos_xy[..., 0], pos_xy[..., 1]
    b = torch.sqrt(a * a * (1.0 - ecc * ecc))
    c = torch.sqrt(torch.clamp(a * a - b * b, min=0.0))
    w = ca * x + sa * y - c
    z = -sa * x + ca * y
    cur_rad = torch.sqrt(w * w + z * z)
    theta = torch.atan2(z, w)
    ecos = ecc * torch.cos(theta)
    target_rad = b / torch.sqrt(1.0 - ecos * ecos)
    rad_err = cur_rad - target_rad

    scale = target_rad / torch.clamp(cur_rad, min=1e-8)
    pw, pz = w * scale, z * scale
    vtw = -(a / b) * pz
    vtz = (b / a) * pw
    r = torch.sqrt((pw + c) ** 2 + pz * pz)
    speed = torch.sqrt(torch.clamp(alpha_gm * (2.0 / r - 1.0 / a), min=0.0))
    vn = torch.clamp(torch.sqrt(vtw * vtw + vtz * vtz), min=1e-8)
    vtw, vtz = vtw * speed / vn, vtz * speed / vn
    tvx = ca * vtw - sa * vtz
    tvy = sa * vtw + ca * vtz
    ev_x = tvx - vel_xy[..., 0]
    ev_y = tvy - vel_xy[..., 1]

    errs = torch.stack([rad_err, ev_x, ev_y], dim=-1)
    return torch.cat([torch.tanh(g * errs) for g in FEATURE_GAINS], dim=-1)


def specific_energy(alpha_gm, pos_xy, vel_xy):
    """Specific orbital energy v^2/2 - GM/r (the reference's unused _H helper,
    kepler.py:20-29): conserved along thrust-free trajectories, so it doubles
    as an integrator invariant."""
    r = torch.linalg.norm(pos_xy, dim=-1)
    v2 = torch.sum(vel_xy * vel_xy, dim=-1)
    return v2 / 2 - alpha_gm / r


def angular_momentum(pos_xy, vel_xy):
    """Specific angular momentum x*vy - y*vx (z component); conserved in any
    central-force field."""
    return pos_xy[..., 0] * vel_xy[..., 1] - pos_xy[..., 1] * vel_xy[..., 0]


def lrl_vector(alpha_gm, pos_xy, vel_xy):
    """Laplace-Runge-Lenz vector A = v x L - GM * r_hat (the reference's unused
    _A helper, kepler.py:31-41): conserved on Kepler orbits, along the major
    axis."""
    L = angular_momentum(pos_xy, vel_xy)
    r = torch.linalg.norm(pos_xy, dim=-1, keepdim=True)
    vxL = torch.stack([vel_xy[..., 1] * L, -vel_xy[..., 0] * L], dim=-1)
    return vxL - alpha_gm * pos_xy / r
