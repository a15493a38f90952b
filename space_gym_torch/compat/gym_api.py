"""Old-Gym-API single-env adapter — the drop-in replacement for the reference
environments (reset() -> obs, 4-tuple step(), seed() method, TimeLimit
semantics folded in; SURVEY.md Q13).

Everything around the physics (reset sampling, tiling, observation, rewards,
RNG streams) runs on the host in f64 numpy with the reference's exact
operation and RNG-call order, so given the same seed the adapter reproduces
the reference bitwise wherever the integrator does.  The physics step runs
on `device` (ops/rk45.py::solve_step on one lane in float64, a few ulp from
scipy; the card unless the caller passes `device="cpu"`), on the host
(compat/host_rk45.py, bit-identical to scipy) or in the native C++ runtime
(parity/native.py, bit-identical to "host" where it finds numpy's OpenBLAS,
at C speed): `physics="device" | "host" | "native"` (`"jax"` is the JAX
package's name for "device", compat/options.py).  "native" builds its
library with g++ on first use; a failed build raises, it never falls back
to another mode.

For batched training rollouts use space_gym_torch.engine instead; this class
exists for parity validation and SB3-style single-env use.

The port of space_gym_tpu/compat/gym_api.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.config import (
    DISCRETE_ACTIONS,
    TASK_DO_NOT_CRASH,
    TASK_GOAL,
    TASK_KEPLER,
    EnvConfig,
)
from ..ops.constants import G
from ..tiling.host import HostTiling
from ..utils import seeding
from ..utils.device import resolve_device
from . import spaces
from .options import adapter_physics


class SpaceGymEnv:
    metadata = {
        "render.modes": ["human", "rgb_array"],
        "video.frames_per_second": 30,
    }

    def __init__(
        self,
        config: EnvConfig,
        physics: str = "device",
        time_limit: bool = True,
        renderer_kwargs: dict | None = None,
        device=None,
    ):
        physics = adapter_physics(physics)
        if physics not in ("device", "host", "native"):
            raise ValueError(f"physics must be 'device', 'host' or 'native', got {physics!r}")
        if physics == "native":
            from ..parity import native

            if not native.is_available():
                raise RuntimeError(f"native solver unavailable: {native.build_error()}")
        self.config = config
        self._physics_mode = physics
        self._time_limit = time_limit
        self._renderer_kwargs = renderer_kwargs or {}
        low, high = config.observation_bounds()
        # Base env obs space is float32 (spaceship_env.py:110); Kepler builds
        # its own Box from a default-dtype array (quirk Q7) — shape-compatible.
        self.observation_space = spaces.Box(low, high, dtype=np.float32)
        if config.continuous:
            ones = np.ones(2, dtype=np.float32)
            self.action_space = spaces.Box(-ones, ones, dtype=np.float32)
        else:
            self.action_space = spaces.Discrete(6)

        self._np_random = None
        self._tiling = None
        if config.task == TASK_GOAL:
            self._tiling = HostTiling(config.tiling, np.random.RandomState())
        self.seed()

        self._state_vec = None
        self.observation = None
        self.last_action = None
        self.last_xy = None
        self.goal_pos = None
        self._elapsed_steps = None
        self._renderer = None

        self.planets_pos = (
            np.array(config.fixed_planet_pos, dtype=float)
            if config.fixed_planet_pos is not None
            else np.zeros((config.n_planets, 2))
        )
        k = config.kepler
        if k is not None:
            self.ref_orbit_a = k.ref_orbit_a
            self.ref_orbit_eccentricity = k.ref_orbit_eccentricity
            self.ref_orbit_angle = k.ref_orbit_angle
            self._alpha_gm = G * k.planet_mass  # python-float product (kepler.py:61)

        self.device = None
        if physics == "device":
            self.device = resolve_device(device)
            self._device_step = _build_device_step(config, self.device)

    # ------------------------------------------------------------- seeding --
    def seed(self, seed=None):
        """Seeds the env RNG, and for Goal tasks the tiling RNG with the same
        seed — two independent RandomStates, like goal.py:74-77."""
        self._np_random, out = seeding.np_random(seed)
        if self._tiling is not None:
            rng, _ = seeding.np_random(seed)
            self._tiling.seed(rng)
        return [out]

    # --------------------------------------------------------------- reset --
    def reset(self):
        cfg = self.config
        if cfg.task == TASK_GOAL:
            self._reset_goal()
        elif cfg.task == TASK_KEPLER:
            self._reset_kepler()
        else:
            self._reset_dnc()
        self._elapsed_steps = 0
        self.last_action = None
        self.last_xy = None
        self._make_observation()
        if self._renderer is not None:
            self._renderer.update_planets(self.planets_pos)
            self._renderer.reset(self.goal_pos)
        return self.observation

    def _set_state(self, pos_xy, pos_angle, vel_xy, vel_angle):
        self._state_vec = np.array([*pos_xy, pos_angle, *vel_xy, vel_angle])

    def _reset_goal(self):
        """goal.py:133-145 with the exact RNG call order documented in
        SURVEY.md 3.2."""
        cfg = self.config
        rng = self._np_random
        positions = self._tiling.reset()
        ship_pos = positions[0]
        self.planets_pos = np.array(positions[1:])
        self.goal_pos = self._tiling.find_new_goal()
        ship_angle = rng.uniform(0, 2 * np.pi)
        velocities_xy = rng.standard_normal(2) * 0.07
        max_abs_ang_vel = 0.7 * cfg.max_abs_vel_angle
        angular_velocity = rng.standard_normal() * max_abs_ang_vel / 3
        angular_velocity = np.clip(angular_velocity, -max_abs_ang_vel, max_abs_ang_vel)
        self._set_state(ship_pos, ship_angle, velocities_xy, angular_velocity)

    def _reset_kepler(self):
        """kepler.py:233-267.  With randomize=True the orbit parameters come
        from the GLOBAL numpy RNG (quirk Q6) — reproduced faithfully."""
        cfg = self.config
        k = cfg.kepler
        rng = self._np_random
        planet_angle = rng.uniform(0, 2 * np.pi)
        dist = rng.uniform(k.planet_radius + 0.5, k.border_radius - 0.5)
        pos_xy = np.stack([np.cos(planet_angle), np.sin(planet_angle)], axis=-1) * dist
        ship_angle = rng.uniform(0, 2 * np.pi)
        if k.randomize:
            self.ref_orbit_eccentricity = np.random.uniform() * 0.7
            self.ref_orbit_angle = np.random.uniform() * 2 * np.pi
        velocities_xy = rng.standard_normal(2) * 0.05
        max_abs_ang_vel = 0.7 * cfg.max_abs_vel_angle
        angular_velocity = rng.standard_normal() * max_abs_ang_vel / 5
        angular_velocity = np.clip(angular_velocity, -max_abs_ang_vel, max_abs_ang_vel)
        self._set_state(pos_xy, ship_angle, velocities_xy, angular_velocity)

    def _reset_dnc(self):
        """do_not_crash.py:34-45."""
        cfg = self.config
        d = cfg.dnc
        rng = self._np_random
        planet_angle = rng.uniform(0, 2 * np.pi)
        dist = rng.uniform(d.planet_radius + 0.2, d.border_radius - 0.15)
        pos_xy = np.stack([np.cos(planet_angle), np.sin(planet_angle)], axis=-1) * dist
        ship_angle = rng.uniform(0, 2 * np.pi)
        velocities_xy = rng.standard_normal(2) * 0.07
        max_abs_ang_vel = 0.7 * cfg.max_abs_vel_angle
        angular_velocity = rng.standard_normal() * max_abs_ang_vel / 3
        angular_velocity = np.clip(angular_velocity, -max_abs_ang_vel, max_abs_ang_vel)
        self._set_state(pos_xy, ship_angle, velocities_xy, angular_velocity)

    # ---------------------------------------------------------------- step --
    def _translate_raw_action(self, raw_action):
        if self.config.continuous:
            engine_action, thruster_action = raw_action
            return (engine_action + 1) / 2, thruster_action  # spaceship_env.py:210-214
        return DISCRETE_ACTIONS[int(raw_action)]

    def step(self, raw_action):
        assert self._elapsed_steps is not None, "Cannot call step() before reset()"
        if self.config.continuous:
            raw_action = np.asarray(raw_action).astype(np.float32)  # spaceship_env.py:69-70
        assert self.action_space.contains(raw_action), raw_action
        action = np.array(self._translate_raw_action(raw_action))
        self.last_action = action
        self.last_xy = self._state_vec[:2].copy()

        if self._physics_mode == "device":
            y, done = self._device_step(self._state_vec, action.astype(np.float64),
                                        self.planets_pos)
            self._state_vec = np.array(y)  # writable host copy
        elif self._physics_mode == "native":
            from ..parity import native

            y, done = native.solve_step_native(self.config, self._state_vec, action,
                                               self.planets_pos)
            self._state_vec = y
        else:
            y, done = _host_physics_step(self.config, self._state_vec, action, self.planets_pos)
            self._state_vec = y
        self._state_vec[2] %= 2 * np.pi  # wrap_ship_angle (dynamic_model.py:179-180)

        self._make_observation()
        reward = self._reward()

        info = {}
        self._elapsed_steps += 1
        if self._time_limit and self._elapsed_steps >= self.config.max_episode_steps:
            info["TimeLimit.truncated"] = not done
            done = True
        return self.observation, reward, done, info

    # ------------------------------------------------------------- rewards --
    def _reward(self):
        cfg = self.config
        if cfg.task == TASK_DO_NOT_CRASH:
            return 100 / cfg.max_episode_steps  # do_not_crash.py:47-48
        if cfg.task == TASK_GOAL:
            return self._goal_reward()
        return self._kepler_reward()

    def _goal_reward(self):
        """goal.py:147-158 + _goal_vel_reward2 (:160-164) +
        _safety_reward_simple2 (:204-227).  Goal reach resamples the goal
        mid-step, consuming tiling RNG (quirk Q11)."""
        cfg = self.config
        p = cfg.goal
        pos_xy = self._state_vec[:2]

        current_dist = np.linalg.norm(self.goal_pos - pos_xy)
        last_dist = np.linalg.norm(self.goal_pos - self.last_xy)
        goal_vel_reward = (last_dist - current_dist) * p.distance_fctr

        ship_x, ship_y = pos_xy
        prev_x, prev_y = self.last_xy
        closest = None
        mindist = np.inf
        for i in range(cfg.n_planets):
            x0, y0 = self.planets_pos[i]
            dist = np.sqrt((ship_x - x0) ** 2 + (ship_y - y0) ** 2)
            if dist < mindist:
                closest = i
                mindist = dist
        r = cfg.planet_radii[closest]
        x0, y0 = self.planets_pos[closest]
        safety = 0
        if (mindist - r) < p.danger_zone:
            prev_dist = np.sqrt((prev_x - x0) ** 2 + (prev_y - y0) ** 2)
            if prev_dist > mindist:
                safety -= p.distance_fctr * (prev_dist - mindist)

        reward = (
            p.survival_reward_scale
            + p.goal_vel_reward_scale * goal_vel_reward
            + p.safety_reward_scale * safety
        )
        if np.linalg.norm(self.goal_pos - pos_xy) < cfg.goal_radius:
            reward += p.goal_sparse_reward
            self.goal_pos = self._tiling.find_new_goal()
            if self._renderer is not None:
                self._renderer.move_goal(self.goal_pos)
        return reward

    def _kepler_reward(self):
        k = self.config.kepler
        act_penalty = np.linalg.norm(self.last_action)  # f32 norm for continuous actions
        return _kepler_dense_reward(
            self._alpha_gm,
            self._state_vec[:2],
            self._state_vec[3:5],
            act_penalty,
            self.ref_orbit_angle,
            self.ref_orbit_a,
            self.ref_orbit_eccentricity,
            k.numerator_C,
            k.rad_penalty_C,
            k.act_penalty_C,
        )

    # ---------------------------------------------------------- observation --
    def _make_observation(self):
        """spaceship_env.py:113-140 (raw, unnormalized obs — quirk Q1) plus
        Kepler's appended orbit parameters (kepler.py:172-187)."""
        cfg = self.config
        s = self._state_vec
        pos_xy = s[:2]
        angle = s[2]
        parts = [
            pos_xy,
            np.stack([np.cos(angle), np.sin(angle)], axis=-1),
            s[3:5],
            np.array([s[5]]),
        ]
        if cfg.with_lidar:
            for i in range(cfg.n_planets):
                parts.append(self._lidar(self.planets_pos[i], cfg.planet_radii[i]))
            if cfg.with_goal:
                parts.append(self._lidar(self.goal_pos, 0.0))
        obs = np.concatenate(parts)
        if cfg.task == TASK_KEPLER:
            obs = np.concatenate(
                [
                    obs,
                    np.array(
                        [self.ref_orbit_angle, self.ref_orbit_eccentricity, self.ref_orbit_a]
                    ),
                ]
            )
        self.observation = obs

    def _lidar(self, obj_pos, obj_radius):
        """_create_lidar_vector (spaceship_env.py:133-140)."""
        v = obj_pos - self._state_vec[:2]
        ang = np.arctan2(v[1], v[0]) % (2 * np.pi)
        scale = (np.linalg.norm(v) - obj_radius) * 2 / self.config.world_size
        return np.stack([np.cos(ang), np.sin(ang)], axis=-1) * scale

    @property
    def planets_lidars(self):
        cfg = self.config
        if not cfg.with_lidar:
            return None
        base = 7
        return self.observation[base : base + 2 * cfg.n_planets].reshape(-1, 2)

    @property
    def goal_lidar(self):
        cfg = self.config
        if not (cfg.with_lidar and cfg.with_goal):
            return None
        base = 7 + 2 * cfg.n_planets
        return self.observation[base : base + 2]

    # ------------------------------------------------------------ analysis --
    def vector_field(self, raw_action, state_vec=None):
        """ODE RHS for analysis, like spaceship_env.py:96-100."""
        if state_vec is None:
            state_vec = self._state_vec
        action = np.array(self._translate_raw_action(np.asarray(raw_action)))
        return _make_host_rhs(self.config, action, self.planets_pos)(0.0, np.array(state_vec, dtype=float))

    # ------------------------------------------------------------ renderer --
    def render(self, mode="human"):
        if self._renderer is None:
            from ..render.renderer import Renderer

            self._renderer = Renderer(
                planets_pos=self.planets_pos,
                planet_radii=self.config.planet_radii,
                world_size=self.config.world_size,
                goal_pos=self.goal_pos,
                debug_mode=self.config.task == TASK_GOAL,
                **self._renderer_kwargs,
            )
        return self._renderer.render(
            self._state_vec[:3], self.last_action, self.goal_lidar, self.planets_lidars, mode
        )

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None

    @property
    def unwrapped(self):
        return self


def _make_host_rhs(config: EnvConfig, action, planets_pos):
    """Reference-exact numpy RHS closure (dynamic_model.py:129-176), including
    the in-place omega override.  The translated `action` array is f32 for
    continuous envs and f64 for discrete — exactly what
    `np.array(self._translate_raw_action(...))` produces upstream, so NumPy's
    mixed-precision arithmetic matches the reference bit-for-bit."""
    ship = config.ship
    masses = config.planet_masses

    def rhs(_t, y):
        engine_action, thruster_action = action
        engine_force_scalar = engine_action * ship.max_engine_force
        angle = y[2]
        direction = -np.stack([np.cos(angle), np.sin(angle)], axis=-1)
        force_xy = direction * engine_force_scalar
        for i, m in enumerate(masses):
            d = planets_pos[i] - y[0:2]
            dist = np.linalg.norm(d)
            force_xy = force_xy + (d / dist) * (G * ship.mass * m / dist**2)
        acceleration_xy = force_xy / ship.mass
        if ship.steering == 0:
            acceleration_angle = thruster_action * ship.max_thruster_force / ship.moi
        else:
            y[5] = thruster_action * 5.0
            acceleration_angle = np.float64(0.0)
        return np.concatenate([y[3:6], acceleration_xy, np.atleast_1d(acceleration_angle)])

    return rhs


def _host_physics_step(config: EnvConfig, state_vec, action, planets_pos):
    """Host physics step through the strict-parity integrator."""
    from . import host_rk45

    rhs = _make_host_rhs(config, action, planets_pos)

    events = []
    for i in range(config.n_planets):
        def ev(_t, y, i=i):
            return np.linalg.norm(planets_pos[i] - y[0:2]) - config.planet_radii[i]

        events.append(ev)
    half = config.world_size / 2
    events.append(lambda _t, y: np.min(half - y[0:2]))
    events.append(lambda _t, y: np.min(half + y[0:2]))
    events.append(lambda _t, y: config.max_abs_vel_angle - np.abs(y[5]))

    y0 = np.array(state_vec, dtype=float)
    return host_rk45.solve_step(rhs, events, y0, config.step_size)


def _build_device_step(config: EnvConfig, device: torch.device):
    """The physics step on `device` in float64: one control interval with
    events of one lane through ops/rk45.py::solve_step."""
    from ..ops import events as ev_mod
    from ..ops import field, rk45

    ship = config.ship
    masses = config.planet_masses
    event_fn = ev_mod.make_event_fn(config.planet_radii, config.world_size,
                                    config.max_abs_vel_angle)
    f32_action = config.continuous

    def checked(y0, action, planets_pos):
        def lane(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device)[None]

        y0, a, p = lane(y0), lane(action), lane(planets_pos)

        def rhs(_t, y):
            return field.ship_vector_field(ship, masses, p, a, y, f32_action=f32_action)

        y0 = field.apply_steering_override(ship, y0, a, f32_action=f32_action)
        out = rk45.solve_step(rhs, lambda y, pp: event_fn(pp, y), y0, config.step_size,
                              event_args=(p,))
        # Host-side twin of the reference's `assert ode_solution.success`
        # (dynamic_model.py:120): step-size underflow is a hard error.
        assert not bool(out.failed[0]), "ODE solver step-size underflow"
        return out.y[0].cpu().numpy(), bool(out.terminated[0])

    return checked


# ----------------------------------------------- Kepler's reward on the host --
# kepler.py:43-150 in numpy with the reference's operation order (the JAX
# package writes it once for numpy and jax.numpy, envs/kepler_math.py; this
# package's envs/kepler_math.py is the batched torch twin).
def _semi_minor(a, ecc):
    return np.sqrt(a * a * (1 - ecc * ecc))


def _rotate(pos_xy, alpha):
    row0 = np.stack([np.cos(alpha), np.sin(alpha)], axis=-1)
    row1 = np.stack([-np.sin(alpha), np.cos(alpha)], axis=-1)
    return np.dot(np.stack([row0, row1], axis=-2), pos_xy)


def _shifted_wz(pos_xy, ref_angle, a, ecc):
    b = _semi_minor(a, ecc)
    pos_wz = _rotate(pos_xy, ref_angle)
    c = np.sqrt(a * a - b * b)
    return np.stack([pos_wz[..., 0] - c, pos_wz[..., 1]], axis=-1), b, c


def _target_rad(b, ecc, theta):
    # ** 2 of a numpy scalar is libm's pow, as upstream (not v * v)
    return b / np.sqrt(1 - (ecc * np.cos(theta)) ** 2)


def _kepler_dense_reward(alpha_gm, pos_xy, vel_xy, act_penalty, ref_angle, ref_a, ecc,
                         numerator_C, rad_penalty_C, act_penalty_C):
    """_dense_reward5 (kepler.py:111-150)."""
    a = ref_a
    pos_wz, b, c = _shifted_wz(pos_xy, ref_angle, a, ecc)
    cur_rad = np.linalg.norm(pos_wz)
    # orbit_target_vel (kepler.py:64-88)
    theta = np.arctan2(pos_wz[..., 1], pos_wz[..., 0])
    pos_t = pos_wz * _target_rad(b, ecc, theta) / np.linalg.norm(pos_wz)
    vt = np.stack([-1.0 * a / b * pos_t[..., 1], 1.0 * b / a * pos_t[..., 0]], axis=-1)
    r = np.linalg.norm(pos_t + np.stack([c, np.zeros_like(c)], axis=-1))
    vt = vt * np.sqrt(alpha_gm * (2 / r - 1 / a)) / np.linalg.norm(vt)
    target_vel = _rotate(vt, -ref_angle)
    # orbit_target_rad (kepler.py:98-109)
    target_rad = _target_rad(b, ecc, theta)
    rad_penalty = np.abs(cur_rad - target_rad)
    vel_x_penalty = np.abs(target_vel[..., 0] - vel_xy[..., 0])
    vel_y_penalty = np.abs(target_vel[..., 1] - vel_xy[..., 1])
    C = numerator_C
    return C / (rad_penalty_C * rad_penalty + vel_x_penalty + vel_y_penalty
                + act_penalty_C * act_penalty + C)
