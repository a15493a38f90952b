"""Batched env engine on PyTorch: every env step is one CUDA kernel launch.

Port of space_gym_tpu/engine/core.py's main path, `EnvEngine(physics="pallas",
pallas_fuse="full")`: per step one bulk `(B, n_u)` uniform draw, then the
full-step kernel (ops/full_step.py, csrc/full_step.cu) does physics,
observation, reward, Goal resample, TimeLimit and masked auto-reset.  The
first state of an episode comes from the batched reset in plain PyTorch
(`reset`), the twin of the JAX engine's XLA reset.

State is a NamedTuple of tensors with the lane axis first.  Randomness comes
from an explicit `torch.Generator`; tests may inject the uniforms instead
(`u=`), so that both engines consume the same matrix.

Auto-reset follows the lockstep-RL convention: when a lane terminates or
truncates, `TimeStep.obs` is the first observation of the new episode and
`TimeStep.final_obs` the terminal observation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..envs.config import DISCRETE_ACTIONS, TASK_GOAL, TASK_KEPLER, EnvConfig
from ..ops.full_step import FullStep
from ..ops.maths import onehot_take
from ..tiling import device as dtiling
from ..utils.device import resolve_device
from ..utils.randvec import RandSource

_PROBE = 4096  # RandSource width used to count the reset's consumption


class EnvState(NamedTuple):
    """Batched per-lane dynamic state (lane axis first)."""

    y: torch.Tensor                 # (B, 6) [x, y, theta, vx, vy, omega]
    planets_pos: torch.Tensor       # (B, P, 2)
    goal_pos: torch.Tensor          # (B, 2) (zeros for non-Goal tasks)
    ref_orbit: torch.Tensor         # (B, 3) [angle, ecc, a] (zeros unless Kepler)
    tiling: Optional[dtiling.TilingState]  # None unless Goal
    steps: torch.Tensor             # (B,) int32 elapsed steps this episode


class TimeStep(NamedTuple):
    obs: torch.Tensor         # post-auto-reset observation (next policy input)
    reward: torch.Tensor
    terminated: torch.Tensor  # physics termination (crash/out-of-world/spin)
    truncated: torch.Tensor   # TimeLimit truncation (max_episode_steps)
    done: torch.Tensor        # terminated | truncated
    final_obs: torch.Tensor   # pre-reset observation


class EnvEngine:
    """Batched engine for one EnvConfig.

    >>> eng = EnvEngine(get_config("GoalContinuous2P-v0"))     # on the card
    >>> g = eng.generator(0)
    >>> state, obs = eng.init(4096, g)
    >>> state, ts = eng.step(state, actions, g)
    """

    def __init__(
        self,
        config: EnvConfig,
        dtype: torch.dtype = torch.float32,
        substeps: int = 2,
        refine_iters: int = 12,
        tableau: str = "dp5",
        device=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {dtype}")
        self.config = config
        self.dtype = dtype
        self.substeps = substeps
        self.refine_iters = refine_iters
        self.tableau = tableau
        self.full = FullStep(config, substeps, refine_iters, tableau)
        self.n_step_rand = self.full.n_uniform_rows
        self.n_reset_rand = self._count_reset()

    # ------------------------------------------------------------------ API --
    def generator(self, seed: int) -> torch.Generator:
        """A generator on the engine's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _uniforms(self, batch: int, n: int, generator) -> torch.Tensor:
        return torch.rand((batch, n), generator=generator, device=self.device, dtype=self.dtype)

    def init(self, batch_size: int, generator: torch.Generator | None = None):
        """Fresh batched state + first observations."""
        return self.reset(batch_size, generator)

    def reset(self, batch_size: int, generator=None, u: torch.Tensor | None = None):
        """Fresh state for every lane from one (B, n_reset_rand) draw (or the
        injected `u`); returns (state, obs (B, D))."""
        if u is None:
            u = self._uniforms(batch_size, self.n_reset_rand, generator)
        state = self._reset_lanes(RandSource(u))
        return state, self._observe(state)

    def step(self, state: EnvState, raw_action: torch.Tensor, generator=None,
             u: torch.Tensor | None = None):
        """One env step for every lane through the full-step kernel."""
        cfg = self.config
        batch = state.y.shape[0]
        if u is None:
            u = self._uniforms(batch, self.n_step_rand, generator)
        ins = self.kernel_operands(state, self._translate_action(raw_action), u)
        yo, po, go, ro, cso, obs, fobs, rew, tio, flags = self.full.apply(*ins)
        if cfg.task == TASK_GOAL:
            n_tiles = cfg.tiling.n_tiles
            tiling = dtiling.TilingState(
                free=tio[:n_tiles].t(),
                ship_tile=tio[n_tiles],
                goal_tile=tio[n_tiles + 1],
                case_b=tio[n_tiles + 3].bool(),
                flip_xy=tio[n_tiles + 4].bool(),
                col_shift=cso.t(),
            )
            steps = tio[n_tiles + 2]
        else:
            tiling = None
            steps = tio[0]
        new_state = EnvState(
            y=yo.t(),
            planets_pos=po.t().reshape(batch, cfg.n_planets, 2),
            goal_pos=go.t(),
            ref_orbit=ro.t(),
            tiling=tiling,
            steps=steps,
        )
        return new_state, TimeStep(
            obs=obs.t(),
            reward=rew[0],
            terminated=flags[0].bool(),
            truncated=flags[1].bool(),
            done=flags[2].bool(),
            final_obs=fobs.t(),
        )

    def kernel_operands(self, state: EnvState, action_b: torch.Tensor, u: torch.Tensor):
        """The full-step kernel's (B, rows) operands, in `FullStep.apply`
        order, for translated actions `action_b`.  The integer state is packed
        as free counts, ship tile, goal tile, steps, case, flip for Goal, and
        as steps and two zero rows otherwise (pallas_full.py:470, :640)."""
        batch, dev = state.y.shape[0], state.y.device
        i32 = torch.int32
        if self.config.task == TASK_GOAL:
            ts = state.tiling
            tili = torch.cat([
                ts.free.to(i32), ts.ship_tile[:, None].to(i32), ts.goal_tile[:, None].to(i32),
                state.steps[:, None].to(i32), ts.case_b[:, None].to(i32),
                ts.flip_xy[:, None].to(i32),
            ], dim=1)
            col_shift = ts.col_shift
        else:
            z = torch.zeros((batch, 1), dtype=i32, device=dev)
            tili = torch.cat([state.steps[:, None].to(i32), z, z], dim=1)
            col_shift = torch.zeros((batch, 1), dtype=self.dtype, device=dev)
        return (state.y, action_b, state.planets_pos, state.goal_pos, state.ref_orbit,
                col_shift, tili, u)

    def rollout(self, state: EnvState, obs: torch.Tensor,
                policy_fn: Callable[[torch.Generator, torch.Tensor], torch.Tensor],
                n_steps: int, generator: torch.Generator | None = None):
        """Python-loop rollout: policy_fn(generator, obs (B, D)) -> raw action.

        Returns (final_state, final_obs, TimeStep stacked over time [T, B, ...])."""
        traj = []
        for _ in range(n_steps):
            action = policy_fn(generator, obs)
            state, ts = self.step(state, action, generator)
            obs = ts.obs
            traj.append(ts)
        stacked = TimeStep(*[torch.stack(field) for field in zip(*traj)])
        return state, obs, stacked

    def random_policy(self):
        """Uniform random policy over the action space (for benchmarks)."""
        if self.config.continuous:
            def pol(generator, obs):
                u = torch.rand((obs.shape[0], 2), generator=generator, device=obs.device,
                               dtype=self.dtype)
                return u * 2.0 - 1.0
        else:
            def pol(generator, obs):
                return torch.randint(0, self.config.n_actions, (obs.shape[0],),
                                     generator=generator, device=obs.device, dtype=torch.int32)
        return pol

    # ------------------------------------------------------------ internals --
    def _count_reset(self) -> int:
        """Uniforms one lane's reset consumes, counted by running the reset
        on one CPU lane of a wide probe (the JAX engine traces it instead)."""
        rs = RandSource(torch.full((1, _PROBE), 0.5, dtype=self.dtype))
        self._reset_lanes(rs)
        return rs.i

    def _translate_action(self, raw_action):
        """spaceship_env.py:189-214: continuous rescale or discrete table."""
        if self.config.continuous:
            a = torch.clamp(raw_action.to(self.dtype), -1.0, 1.0)
            return torch.stack([(a[:, 0] + 1) / 2, a[:, 1]], dim=1)
        table = torch.tensor(DISCRETE_ACTIONS, dtype=self.dtype, device=raw_action.device)
        return onehot_take(table, raw_action.to(torch.int32))

    def _reset_lanes(self, rs: RandSource) -> EnvState:
        cfg = self.config
        dtype = self.dtype
        if cfg.task == TASK_GOAL:
            ts, y, planets, goal, ref = self._reset_goal(rs)
        elif cfg.task == TASK_KEPLER:
            ts, y, planets, goal, ref = self._reset_kepler(rs)
        else:
            ts, y, planets, goal, ref = self._reset_dnc(rs)
        return EnvState(
            y=y.to(dtype),
            planets_pos=planets.to(dtype),
            goal_pos=goal.to(dtype),
            ref_orbit=ref.to(dtype),
            tiling=ts,
            steps=torch.zeros(y.shape[0], dtype=torch.int32, device=y.device),
        )

    def _kinematics(self, rs: RandSource, vel_scale: float, w_div: float):
        """Velocity and clipped spin of a fresh ship."""
        vel = rs.normal(2).to(self.dtype) * vel_scale
        max_w = 0.7 * self.config.max_abs_vel_angle
        w = torch.clamp(rs.normal().to(self.dtype) * max_w / w_div, -max_w, max_w)
        return vel, w

    def _reset_goal(self, rs: RandSource):
        """goal.py:133-145."""
        cfg = self.config
        dtype = self.dtype
        ts, ship_pos, planets = dtiling.tiling_reset(cfg.tiling, rs, dtype)
        ts, goal = dtiling.find_new_goal(cfg.tiling, ts, rs, dtype)
        angle = rs.uniform(maxval=2 * torch.pi).to(dtype)
        vel, w = self._kinematics(rs, 0.07, 3)
        y = torch.cat([ship_pos, angle[:, None], vel, w[:, None]], dim=1)
        ref = torch.zeros((y.shape[0], 3), dtype=dtype, device=y.device)
        return ts, y, planets, goal, ref

    def _fixed_planets(self, batch, device):
        pos = torch.tensor(self.config.fixed_planet_pos, dtype=self.dtype, device=device)
        return pos[None].expand(batch, -1, -1).contiguous()

    def _reset_kepler(self, rs: RandSource):
        """kepler.py:233-267; `randomize` resamples the reference orbit."""
        k = self.config.kepler
        dtype = self.dtype
        planet_angle = rs.uniform(maxval=2 * torch.pi).to(dtype)
        dist = rs.uniform(minval=k.planet_radius + 0.5, maxval=k.border_radius - 0.5).to(dtype)
        pos = torch.stack([torch.cos(planet_angle), torch.sin(planet_angle)], dim=1) * dist[:, None]
        ship_angle = rs.uniform(maxval=2 * torch.pi).to(dtype)
        B, dev = pos.shape[0], pos.device
        if k.randomize:
            u = rs.take(2).to(dtype)
            ecc = u[:, 0] * 0.7
            orbit_angle = u[:, 1] * 2 * torch.pi
        else:
            ecc = torch.full((B,), k.ref_orbit_eccentricity, dtype=dtype, device=dev)
            orbit_angle = torch.full((B,), k.ref_orbit_angle, dtype=dtype, device=dev)
        ref = torch.stack([orbit_angle, ecc, torch.full((B,), k.ref_orbit_a, dtype=dtype, device=dev)], 1)
        vel, w = self._kinematics(rs, 0.05, 5)
        y = torch.cat([pos, ship_angle[:, None], vel, w[:, None]], dim=1)
        goal = torch.zeros((B, 2), dtype=dtype, device=dev)
        return None, y, self._fixed_planets(B, dev), goal, ref

    def _reset_dnc(self, rs: RandSource):
        """do_not_crash.py:34-45."""
        d = self.config.dnc
        dtype = self.dtype
        planet_angle = rs.uniform(maxval=2 * torch.pi).to(dtype)
        dist = rs.uniform(minval=d.planet_radius + 0.2, maxval=d.border_radius - 0.15).to(dtype)
        pos = torch.stack([torch.cos(planet_angle), torch.sin(planet_angle)], dim=1) * dist[:, None]
        ship_angle = rs.uniform(maxval=2 * torch.pi).to(dtype)
        vel, w = self._kinematics(rs, 0.07, 3)
        y = torch.cat([pos, ship_angle[:, None], vel, w[:, None]], dim=1)
        B, dev = y.shape[0], y.device
        return (None, y, self._fixed_planets(B, dev), torch.zeros((B, 2), dtype=dtype, device=dev),
                torch.zeros((B, 3), dtype=dtype, device=dev))

    def _observe(self, state: EnvState) -> torch.Tensor:
        """spaceship_env.py:113-140 (raw, unnormalised) + Kepler's appended
        orbit parameters (kepler.py:172-187); the reset observation."""
        cfg = self.config
        y = state.y
        pos = y[:, 0:2]
        parts = [pos, torch.stack([torch.cos(y[:, 2]), torch.sin(y[:, 2])], dim=1), y[:, 3:5], y[:, 5:6]]
        if cfg.with_lidar:
            radii = torch.tensor(cfg.planet_radii, dtype=self.dtype, device=y.device)
            parts.append(self._lidar(pos[:, None, :], state.planets_pos, radii).reshape(y.shape[0], -1))
            if cfg.with_goal:
                parts.append(self._lidar(pos, state.goal_pos, 0.0))
        if cfg.task == TASK_KEPLER:
            parts.append(state.ref_orbit)  # [angle, ecc, a] (kepler.py:180-185)
        return torch.cat(parts, dim=1)

    def _lidar(self, ship_pos, obj_pos, obj_radius):
        """_create_lidar_vector (spaceship_env.py:133-140):
        unit(ship->obj) * (dist - radius) * 2 / world_size."""
        v = obj_pos - ship_pos
        ang = torch.remainder(torch.atan2(v[..., 1], v[..., 0]), 2 * torch.pi)
        dist = torch.sqrt((v * v).sum(-1))
        scale = (dist - obj_radius) * 2 / self.config.world_size
        return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * scale[..., None]
