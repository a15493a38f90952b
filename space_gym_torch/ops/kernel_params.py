"""The by-value parameter structs of the CUDA kernels (csrc/params.cuh).

Every field is a 4-byte int or float, in the order of the C structs, so the
ctypes layout and nvcc's agree without padding.  Products and quotients of
constants are folded here in Python double, as the JAX code folds them before
tracing (e.g. G*ship.mass*masses[i], pallas_step.py:105), and rounded to f32
once.
"""
from __future__ import annotations

import ctypes

from ..envs.config import TASK_DO_NOT_CRASH, TASK_GOAL, TASK_KEPLER
from .constants import G
from .field import VELOCITY_STEERING_SCALE

MAX_PLANETS = 4
MAX_SUBSTEPS = 8
TABLEAU_IDS = {"dp5": 0, "bs3": 1}
TASK_IDS = {TASK_GOAL: 0, TASK_KEPLER: 1, TASK_DO_NOT_CRASH: 2}

_f = ctypes.c_float
_i = ctypes.c_int


class PhysParams(ctypes.Structure):
    _fields_ = [
        ("steering", _i),
        ("n_substeps", _i),
        ("refine_iters", _i),
        ("max_engine_force", _f),
        ("ship_mass", _f),
        ("aang_coef", _f),          # max_thruster_force / moi
        ("vel_steer_scale", _f),
        ("half", _f),               # world_size / 2
        ("max_abs_vel_angle", _f),
        ("h", _f),                  # step_size / n_substeps
        ("gm", _f * MAX_PLANETS),   # G * ship.mass * masses[i]
        ("radii", _f * MAX_PLANETS),
        ("t0", _f * MAX_SUBSTEPS),  # substep start times, summed in double
        ("t1", _f * MAX_SUBSTEPS),  # t0 + h, in double
    ]


class FullParams(ctypes.Structure):
    _fields_ = [
        ("phys", PhysParams),
        ("max_episode_steps", _i),
        ("kepler_randomize", _i),
        ("two_over_ws", _f),
        ("max_w", _f),
        ("max_w_3", _f),
        ("max_w_5", _f),
        # Goal reward
        ("survival", _f),
        ("gv_scale", _f),
        ("safety_scale", _f),
        ("sparse", _f),
        ("danger_zone", _f),
        ("distance_fctr", _f),
        ("neg_distance_fctr", _f),
        ("goal_radius", _f),
        # hex tiling
        ("zero_x", _f),
        ("zero_y_a", _f),           # ws/2 - hex_height/2
        ("zero_y_b", _f),           # ws/2 - hex_height (case b)
        ("col_step", _f),           # 1.5 * a
        ("hex_height", _f),
        ("half_hex_height", _f),
        ("free_x", _f),             # ws - tiling_width
        ("disk_r_ship", _f),
        ("disk_r_planet", _f),
        ("disk_r_goal", _f),
        # Kepler
        ("k_dist_lo", _f),
        ("k_dist_span", _f),
        ("alpha_gm", _f),
        ("k_C", _f),
        ("k_rad_C", _f),
        ("k_act_C", _f),
        # DoNotCrash
        ("d_dist_lo", _f),
        ("d_dist_span", _f),
        ("dnc_reward", _f),
        ("continuous", _i),         # K3 translates the raw action (EnvConfig.continuous)
    ]


def phys_params(cfg, n_substeps: int, refine_iters: int) -> PhysParams:
    if not 1 <= cfg.n_planets <= MAX_PLANETS:
        raise ValueError(f"the kernels take 1..{MAX_PLANETS} planets, got {cfg.n_planets}")
    if not 1 <= n_substeps <= MAX_SUBSTEPS:
        raise ValueError(f"the kernels take 1..{MAX_SUBSTEPS} substeps, got {n_substeps}")
    if refine_iters < 0:
        raise ValueError(f"refine_iters must be >= 0, got {refine_iters}")
    ship = cfg.ship
    h = cfg.step_size / n_substeps
    p = PhysParams()
    p.steering = int(ship.steering)
    p.n_substeps = n_substeps
    p.refine_iters = refine_iters
    p.max_engine_force = ship.max_engine_force
    p.ship_mass = ship.mass
    p.aang_coef = ship.max_thruster_force / ship.moi
    p.vel_steer_scale = VELOCITY_STEERING_SCALE
    p.half = cfg.world_size / 2
    p.max_abs_vel_angle = cfg.max_abs_vel_angle
    p.h = h
    for i, (m, r) in enumerate(zip(cfg.planet_masses, cfg.planet_radii)):
        p.gm[i] = G * ship.mass * float(m)
        p.radii[i] = float(r)
    t = 0.0  # the JAX body sums the substep times in Python floats
    for s in range(n_substeps):
        p.t0[s] = t
        p.t1[s] = t + h
        t = t + h
    return p


def full_params(cfg, n_substeps: int, refine_iters: int) -> FullParams:
    q = FullParams()
    q.phys = phys_params(cfg, n_substeps, refine_iters)
    q.max_episode_steps = int(cfg.max_episode_steps)
    q.continuous = int(cfg.continuous)
    q.two_over_ws = 2.0 / cfg.world_size
    max_w = 0.7 * cfg.max_abs_vel_angle
    q.max_w, q.max_w_3, q.max_w_5 = max_w, max_w / 3, max_w / 5
    if cfg.goal is not None:
        gl, geom, ws = cfg.goal, cfg.tiling, cfg.world_size
        q.survival = gl.survival_reward_scale
        q.gv_scale = gl.goal_vel_reward_scale
        q.safety_scale = gl.safety_reward_scale
        q.sparse = gl.goal_sparse_reward
        q.danger_zone = gl.danger_zone
        q.distance_fctr = gl.distance_fctr
        q.neg_distance_fctr = -gl.distance_fctr
        q.goal_radius = cfg.goal_radius
        q.zero_x = -ws / 2 + geom.hex_width / 2
        q.zero_y_a = ws / 2 - geom.hex_height / 2
        q.zero_y_b = ws / 2 - geom.hex_height
        q.col_step = 1.5 * geom.a
        q.hex_height = geom.hex_height
        q.half_hex_height = geom.hex_height / 2
        q.free_x = ws - geom.tiling_width
        q.disk_r_ship = geom.hex_height / 2 - geom.ship_radius
        q.disk_r_planet = geom.hex_height / 2 - geom.planets_radius
        q.disk_r_goal = geom.hex_height / 2 - geom.goal_radius
    if cfg.kepler is not None:
        k = cfg.kepler
        q.kepler_randomize = int(k.randomize)
        q.k_dist_lo = k.planet_radius + 0.5
        q.k_dist_span = (k.border_radius - 0.5) - (k.planet_radius + 0.5)
        q.alpha_gm = G * k.planet_mass
        q.k_C, q.k_rad_C, q.k_act_C = k.numerator_C, k.rad_penalty_C, k.act_penalty_C
    if cfg.dnc is not None:
        d = cfg.dnc
        q.d_dist_lo = d.planet_radius + 0.2
        q.d_dist_span = (d.border_radius - 0.15) - (d.planet_radius + 0.2)
        q.dnc_reward = d.reward_per_step
    return q
