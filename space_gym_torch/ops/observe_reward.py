"""Observation and per-task reward of one env step, on component rows.

The plain twins of csrc/observe_reward.cuh (`sg_observe`, `sg_reward`), shared
by the plain versions of the env-step kernel (ops/env_step.py) and the
full-step kernel (ops/full_step_plain.py).  Same computation as the bodies of
space_gym_tpu/ops/pallas_step.py::make_fused_env_step (:385-492) and
pallas_full.py's `observe` / `reward_fn`.  Every tensor is one row of the
component-major (rows, B) layout.
"""
from __future__ import annotations

import torch

from ..envs.config import TASK_GOAL, TASK_KEPLER
from .constants import G


def check_layout(cfg):
    """The kernels' observation layout per task: lidar + goal for Goal,
    orbit parameters for Kepler, the bare ship state for DoNotCrash."""
    want = cfg.task == TASK_GOAL
    if cfg.with_lidar != want or cfg.with_goal != want:
        raise ValueError(f"{cfg.env_id}: lidar/goal flags do not match task {cfg.task!r}")


def make_observe_reward(cfg):
    """Returns `(observe, reward_fn)`:
    `observe(comp, px, py, gx, gy, ref_rows) -> obs_dim rows`;
    `reward_fn(comp0, yf, px, py, gx, gy, ref_rows, ae, at) -> (reward,
    reached)`, the Goal sparse bonus included, `reached` all False off Goal."""
    check_layout(cfg)
    task = cfg.task
    n_planets = cfg.n_planets
    radii = tuple(float(r) for r in cfg.planet_radii)
    ws = cfg.world_size
    obs_dim = cfg.obs_dim
    k = cfg.kepler
    gl = cfg.goal
    d = cfg.dnc
    alpha_gm = G * k.planet_mass if k is not None else 0.0

    def lidar(pos_x, pos_y, ox, oy, radius):
        vx = ox - pos_x
        vy = oy - pos_y
        dd = torch.sqrt(vx * vx + vy * vy)
        scale = (dd - radius) * (2.0 / ws) / dd
        return vx * scale, vy * scale

    def observe(comp, px, py, gx, gy, ref_rows):
        x, yy, th, vx, vy, w = comp
        out = [x, yy, torch.cos(th), torch.sin(th), vx, vy, w]
        if task == TASK_GOAL:
            for i in range(n_planets):
                out += list(lidar(x, yy, px[i], py[i], radii[i]))
            out += list(lidar(x, yy, gx, gy, 0.0))
        if task == TASK_KEPLER:
            out += list(ref_rows)
        assert len(out) == obs_dim
        return out

    def reward_fn(comp0, yf, px, py, gx, gy, ref_rows, ae, at):
        x, yy, _, vx, vy, _ = yf
        if task == TASK_GOAL:
            x0, y0 = comp0[0], comp0[1]
            cur = torch.sqrt((gx - x) ** 2 + (gy - yy) ** 2)
            last = torch.sqrt((gx - x0) ** 2 + (gy - y0) ** 2)
            gvr = (last - cur) * gl.distance_fctr
            mind = cx = cy = cr = None
            for i in range(n_planets):
                dx = px[i] - x
                dy = py[i] - yy
                dd = torch.sqrt(dx * dx + dy * dy)
                if mind is None:
                    mind, cx, cy, cr = dd, px[i], py[i], torch.full_like(dd, radii[i])
                else:
                    closer = dd < mind
                    cx = torch.where(closer, px[i], cx)
                    cy = torch.where(closer, py[i], cy)
                    cr = torch.where(closer, radii[i], cr)
                    mind = torch.minimum(dd, mind)
            prev = torch.sqrt((cx - x0) ** 2 + (cy - y0) ** 2)
            safety = torch.where(((mind - cr) < gl.danger_zone) & (prev > mind),
                                 -gl.distance_fctr * (prev - mind), 0.0)
            rew = (gl.survival_reward_scale + gl.goal_vel_reward_scale * gvr
                   + gl.safety_reward_scale * safety)
            reached = cur < cfg.goal_radius
            return rew + torch.where(reached, gl.goal_sparse_reward, 0.0), reached
        if task == TASK_KEPLER:
            ra, ecc, a_ax = ref_rows
            b_ax = torch.sqrt(a_ax * a_ax * (1 - ecc * ecc))
            c_f = torch.sqrt(a_ax * a_ax - b_ax * b_ax)
            ca = torch.cos(ra)
            sa = torch.sin(ra)
            wp = ca * x + sa * yy - c_f
            zp = -sa * x + ca * yy
            r2 = wp * wp + zp * zp
            cur_rad = torch.sqrt(r2)
            target_rad = b_ax * torch.rsqrt(1 - ecc * ecc * wp * wp / r2)
            sc = target_rad / cur_rad
            wq, zq = wp * sc, zp * sc
            vtw = -(a_ax / b_ax) * zq
            vtz = (b_ax / a_ax) * wq
            rfoc = torch.sqrt((wq + c_f) ** 2 + zq * zq)
            vmag = torch.sqrt(alpha_gm * (2 / rfoc - 1 / a_ax))
            vn = torch.sqrt(vtw * vtw + vtz * vtz)
            vtw, vtz = vtw * vmag / vn, vtz * vmag / vn
            tvx = ca * vtw - sa * vtz
            tvy = sa * vtw + ca * vtz
            act_pen = torch.sqrt(ae * ae + at * at)
            C = k.numerator_C
            rew = C / (k.rad_penalty_C * torch.abs(cur_rad - target_rad)
                       + torch.abs(tvx - vx) + torch.abs(tvy - vy)
                       + k.act_penalty_C * act_pen + C)
            return rew, torch.zeros_like(rew, dtype=torch.bool)
        rew = torch.full_like(x, d.reward_per_step)
        return rew, torch.zeros_like(rew, dtype=torch.bool)

    return observe, reward_fn
