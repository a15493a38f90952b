"""Batched env engine on PyTorch, in the step tiers of the JAX engine.

Port of space_gym_tpu/engine/core.py.  Env state is a NamedTuple of tensors
with the lane axis first; `step` covers action translation, ODE integration
with terminal events, observation, reward (with Goal's mid-episode goal
resample), TimeLimit truncation and masked auto-reset.  Four tiers compute the
same step, from most to least of it in one CUDA kernel:

  * `physics="kernel", fuse="full"` (default): the whole step is one launch of
    the full-step kernel K3 (ops/full_step.py, csrc/full_step.cuh), the
    counterpart of `EnvEngine(physics="pallas", pallas_fuse="full")`.  Its
    uniforms come from one bulk `(B, n_u)` draw per step
    (`in_kernel_rng=False`), or the kernel computes them from two key words:
    `in_kernel_rng="threefry"` (`True` is an alias), bit for bit the bulk
    draw of `jax.random.uniform`, or `"philox"`, an own stream with the same
    law.  `"philox"` stands where the JAX engine has `"hw"`, the TPU core's
    hardware generator, which a CUDA card lacks.
  * `fuse="env"`: physics, observation and reward in the env-step kernel K2
    (ops/env_step.py), then the tail below for resample, truncation and reset
    (`pallas_fuse="env"`).
  * `fuse="physics"`: the physics kernel K1 (ops/physics_step.py), then the
    tail for observation, reward, resample, truncation and reset
    (`pallas_fuse="physics"`).
  * `physics="fixed"`: no kernel; the fixed-substep Dormand-Prince integrator
    in plain PyTorch (ops/fixed_rk.py) and the tail (`physics="fixed"`).
  * `physics="adaptive"`: no kernel (the JAX tier has none either); scipy's
    adaptive RK45 with Brent's event roots (ops/rk45.py::solve_step) and the
    tail, in float32 or float64.  It exists for parity with the reference,
    not for speed: its loops read a condition on the host at every
    iteration.  A lane whose solve fails is poisoned with NaN.

The tail (`_step_tail`) is the batched counterpart of the JAX engine's
`_step_lane`: plain PyTorch on the engine's device, consuming one `(B, n)`
block of uniforms through a `RandSource` in the JAX order, the Goal resample
first and the reset second.  Only the tail tiers can step with
`auto_reset=False`.  The first state of an episode comes from the batched
reset in plain PyTorch (`reset`), the twin of the JAX engine's XLA reset.

`rollout` runs T steps of a policy.  Under `fuse="full"` it carries K3's own
component-major (rows, B) operands from step to step (`RowCarry`): K3's
outputs are the next step's inputs as they stand, so the per-step
transposes and `cat`s of `step` leave the rollout, and the state turns into
an `EnvState` once, at the exit.  `capture_rollout` makes those T steps
one CUDA graph (utils/graphs.py), replayed on later calls; `PolicyRollout`
holds one for a trainer's policy, and `rollout` runs them as a loop.  The
tail tiers keep the loop of `step`.

Randomness comes from an explicit `torch.Generator`; tests may inject the
uniforms (`u=`) or the key words (`key=`) instead, so that both engines
consume the same stream.

Under a mesh (`mesh=`, parallel/mesh.py) a rank steps only its lanes, a
block of the global batch along "data".  Every draw with a lanes axis (the
step's uniforms, a policy's noise through `draw_lanes`) is made for the
global lanes from the generator, which every rank seeds alike, and sliced to
the rank's block; the in-kernel generators take the block's first global
lane.  So a lane's randomness is the one-process run's whatever the split.
`reset` makes the lanes it is asked for from one draw: make the global state
and `place` it.  `obs_features` appends analytic functions of the
raw observation (envs/*_math.py) after the step, for trainers.

Auto-reset follows the lockstep-RL convention: when a lane terminates or
truncates, `TimeStep.obs` is the first observation of the new episode and
`TimeStep.final_obs` the terminal observation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..envs import dnc_math, goal_math, kepler_math
from ..envs.config import (DISCRETE_ACTIONS, TASK_DO_NOT_CRASH, TASK_GOAL, TASK_KEPLER,
                           EnvConfig)
from ..ops import events as events_mod
from ..ops import exact, field, fixed_rk, rk45
from ..ops.constants import G
from ..ops.env_step import EnvStep
from ..ops.full_step import FullStep, normalize_rng_mode
from ..ops.maths import norm2, onehot_take
from ..ops.physics_step import PhysicsStep
from ..ops.rng_plain import key_words
from ..tiling import device as dtiling
from ..utils import graphs, profiling
from ..utils.device import resolve_device
from ..utils.randvec import RandSource

_PROBE = 4096  # RandSource width used to count a reset's and a step's consumption


class EnvState(NamedTuple):
    """Batched per-lane dynamic state (lane axis first)."""

    y: torch.Tensor                 # (B, 6) [x, y, theta, vx, vy, omega]
    planets_pos: torch.Tensor       # (B, P, 2)
    goal_pos: torch.Tensor          # (B, 2) (zeros for non-Goal tasks)
    ref_orbit: torch.Tensor         # (B, 3) [angle, ecc, a] (zeros unless Kepler)
    tiling: Optional[dtiling.TilingState]  # None unless Goal
    steps: torch.Tensor             # (B,) int32 elapsed steps this episode


class RowCarry(NamedTuple):
    """A rollout's carried state under fuse="full": K3's component-major
    (rows, B) operands, contiguous, in its order (FullStep.step_rows)."""

    y: torch.Tensor           # (6, B)
    planets: torch.Tensor     # (2P, B)
    goal: torch.Tensor        # (2, B)
    ref_orbit: torch.Tensor   # (3, B)
    col_shift: torch.Tensor   # (cols or 1, B)
    tili: torch.Tensor        # (n_int_rows, B) int32: free counts, ship, goal, steps, case,
                              # flip for Goal; steps and two zero rows otherwise


class Trajectory(NamedTuple):
    """A rollout's steps stacked over time, [T, B, ...].  The per-step fields
    are None when the caller asked for no trajectory; the sums are always
    there."""

    obs: Optional[torch.Tensor]         # what the policy saw at each step
    kept: Optional[dict]                # what the policy kept at each step ("action", ...)
    reward: Optional[torch.Tensor]
    terminated: Optional[torch.Tensor]
    truncated: Optional[torch.Tensor]
    done: Optional[torch.Tensor]
    final_obs: Optional[torch.Tensor]   # pre-reset observation after each step
    reward_sum: torch.Tensor            # () over steps and lanes
    done_sum: torch.Tensor              # () int64: lane-steps that ended an episode


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

    Options (see the module docstring for the tiers):
      physics        "kernel" (default), "fixed" or "adaptive".
      fuse           "full" (default), "env" or "physics": how much of the
                     step the kernel covers when physics="kernel".
      in_kernel_rng  False (default), "threefry" (True is an alias) or
                     "philox", for fuse="full": where K3's uniforms come from.
                     "philox" is the counterpart of the JAX engine's "hw".
      tableau        "dp5" or "bs3" for the kernels; "fixed" and "adaptive"
                     are DP5 only.  substeps and refine_iters apply to the
                     kernels and "fixed".
      auto_reset     False leaves done lanes as they are (tail tiers only).
      f32_actions    "fixed" and "adaptive": the reference's float32 action
                     arithmetic.
      obs_features   None, "kepler", "goal" or "dnc": appended observation
                     features; `obs_dim` includes them, `config.obs_dim` not.
      mesh           None, or a parallel.mesh.Mesh whose "data" axis splits
                     the lanes that `step` and `rollout` are given.

    `n_reset_rand` and `n_step_rand` are the uniforms one lane's reset and
    step consume: K3's row count for fuse="full", the tail's counted
    consumption otherwise.
    """

    def __init__(
        self,
        config: EnvConfig,
        dtype: torch.dtype = torch.float32,
        substeps: int = 2,
        refine_iters: int = 12,
        tableau: str = "dp5",
        device=None,
        physics: str = "kernel",
        fuse: str = "full",
        in_kernel_rng=False,
        auto_reset: bool = True,
        f32_actions: bool = False,
        obs_features: str | None = None,
        mesh=None,
    ):
        if physics not in ("kernel", "fixed", "adaptive"):
            raise ValueError(f"physics must be 'kernel', 'fixed' or 'adaptive', got {physics!r}")
        if fuse not in ("full", "env", "physics"):
            raise ValueError(f"fuse must be 'full', 'env' or 'physics', got {fuse!r}")
        self.tier = fuse if physics == "kernel" else physics
        self.device = resolve_device(device)
        if self.device.type == "cuda" and physics == "kernel" and dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {dtype}")
        if physics != "kernel" and tableau != "dp5":
            raise ValueError(f"physics={physics!r} integrates with DP5 only")
        self.in_kernel_rng = normalize_rng_mode(in_kernel_rng)
        if self.in_kernel_rng and (self.tier != "full" or dtype != torch.float32):
            raise ValueError("in_kernel_rng needs physics='kernel', fuse='full' and float32")
        if not auto_reset and self.tier == "full":
            raise ValueError("auto_reset=False needs a tail tier: physics='fixed' or "
                             "'adaptive', or fuse='env' or 'physics'")
        self.config = config
        self.physics = physics
        self.fuse = fuse
        self.dtype = dtype
        self.substeps = substeps
        self.refine_iters = refine_iters
        self.tableau = tableau
        self.auto_reset = auto_reset
        self.f32_actions = f32_actions
        self.mesh = mesh
        ev_args = (config.planet_radii, config.world_size, config.max_abs_vel_angle)
        self._event_comp_fns = events_mod.make_event_component_fns(*ev_args)
        self._event_fn = events_mod.make_event_fn(*ev_args)
        # physics="adaptive": the last step's solver counts (accepted steps
        # per lane, host reads of loop conditions, lanes that ran Brent)
        self.solve_stats = {}
        k = config.kepler
        self._alpha_gm = G * k.planet_mass if k is not None else 0.0

        if obs_features not in (None, "kepler", "goal", "dnc"):
            raise ValueError(f"unknown obs_features {obs_features!r}")
        needs = {"kepler": TASK_KEPLER, "goal": TASK_GOAL, "dnc": TASK_DO_NOT_CRASH}
        if obs_features and config.task != needs[obs_features]:
            raise ValueError(f"obs_features={obs_features!r} requires a {needs[obs_features]} env")
        self.obs_features = obs_features
        self.obs_dim = config.obs_dim + {
            None: 0,
            "kepler": kepler_math.N_ERROR_FEATURES,
            "goal": goal_math.N_GOAL_FEATURES,
            "dnc": dnc_math.N_DNC_FEATURES,
        }[obs_features]

        kernel_args = (config, substeps, refine_iters, tableau)
        self.full = FullStep(*kernel_args, self.in_kernel_rng) if self.tier == "full" else None
        self.env_step = EnvStep(*kernel_args) if self.tier == "env" else None
        self.physics_step = PhysicsStep(*kernel_args) if self.tier == "physics" else None
        self._action_tables = {}  # device -> the discrete action table there
        self.n_reset_rand = self._count_reset()
        self.n_step_rand = self.full.n_uniform_rows if self.full else self._count_step()

    # ------------------------------------------------------------------ API --
    def generator(self, seed: int) -> torch.Generator:
        """A generator on the engine's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _uniforms(self, rows: int, cols: int, generator) -> torch.Tensor:
        return torch.rand((rows, cols), generator=generator, device=self.device, dtype=self.dtype)

    def lane0(self, batch: int) -> int:
        """The global index of this rank's first lane when it steps `batch`
        lanes: 0 without a mesh."""
        return 0 if self.mesh is None else self.mesh.data_index * batch

    def draw_lanes(self, draw: Callable, shape, dim: int = 0) -> torch.Tensor:
        """`draw(shape)` for this rank's lanes along `dim`: under a mesh the
        draw of the global lanes (every rank's block, in order), sliced to
        this rank's; `draw(shape)` itself without one."""
        if self.mesh is None or self.mesh.data_size == 1:
            return draw(tuple(shape))
        full = list(shape)
        full[dim] *= self.mesh.data_size
        return draw(tuple(full)).narrow(dim, self.lane0(shape[dim]), shape[dim])

    def _lane_uniforms(self, rows: int, cols: int, generator, dim: int) -> torch.Tensor:
        """`_uniforms` with the lanes along `dim`, drawn for the global lanes
        under a mesh; contiguous."""
        return self.draw_lanes(lambda s: self._uniforms(*s, generator), (rows, cols),
                               dim).contiguous()

    def draw_key(self, generator) -> torch.Tensor:
        """Two fresh 32-bit key words as the (2,) int32 tensor the kernel
        reads, drawn and kept on the engine's device: no host round trip."""
        return key_words(torch.randint(0, 1 << 32, (2,), generator=generator, device=self.device,
                                       dtype=torch.int64))

    def init(self, batch_size: int, generator: torch.Generator | None = None):
        """Fresh batched state + first observations."""
        return self.reset(batch_size, generator)

    def reset(self, batch_size: int, generator=None, u: torch.Tensor | None = None):
        """Fresh state for every lane from one (B, n_reset_rand) draw (or the
        injected `u`); returns (state, obs (B, obs_dim))."""
        if u is None:
            u = self._uniforms(batch_size, self.n_reset_rand, generator)
        state = self._reset_lanes(RandSource(u))
        return state, self._augment_obs(self._observe(state))

    def step(self, state: EnvState, raw_action: torch.Tensor, generator=None,
             u: torch.Tensor | None = None, key=None):
        """One env step for every lane.  Randomness: the `generator`, or the
        injected `(B, n_step_rand)` uniforms `u`, or with an in-kernel source
        the injected `key` (two 32-bit words, see ops/rng_plain.py::key_words).
        Under fuse="full" the generator's block is drawn as K3 reads it,
        (n_step_rand, B): lane b takes column b."""
        if self.in_kernel_rng:
            if u is not None:
                raise ValueError(f"in_kernel_rng={self.in_kernel_rng!r} takes key=, not u=")
            rand = self.draw_key(generator) if key is None else key_words(key, self.device)
        else:
            if key is not None:
                raise ValueError("key= needs an in-kernel random source; inject u= instead")
            if u is not None:
                rand = u
            elif self.tier == "full":
                # drawn in K3's (n_u, B) row layout, which the kernel reads as it is
                rand = self._lane_uniforms(self.n_step_rand, state.y.shape[0], generator, 1).t()
            else:
                rand = self._lane_uniforms(state.y.shape[0], self.n_step_rand, generator, 0)
        if self.tier == "full":
            state, ts = self._step_full(state, raw_action, rand)
        else:
            state, ts = self._step_tail(state, raw_action, RandSource(rand))
        if self.obs_features:
            ts = ts._replace(obs=self._augment_obs(ts.obs),
                             final_obs=self._augment_obs(ts.final_obs))
        return state, ts

    def _step_full(self, state: EnvState, raw_action: torch.Tensor, u: torch.Tensor):
        """The whole step through the full-step kernel; `u` is the uniforms
        block or the key words."""
        ins = self.kernel_operands(state, raw_action, u)
        yo, po, go, ro, cso, obs, fobs, rew, tio, flags = self.full.apply(
            *ins, lane0=self.lane0(state.y.shape[0]) if self.in_kernel_rng else 0)
        return self.from_carry(RowCarry(yo, po, go, ro, cso, tio)), _time_step(
            obs, fobs, rew, flags)

    def _state_operands(self, state: EnvState):
        """The state's part of K3's operands, (B, rows) each: y, planets
        (B, P, 2), goal, ref_orbit, col_shift and the int32 rows.  The integer
        state is packed as free counts, ship tile, goal tile, steps, case,
        flip for Goal, and as steps and two zero rows otherwise
        (pallas_full.py:470, :640)."""
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
        return (state.y, state.planets_pos, state.goal_pos, state.ref_orbit, col_shift, tili)

    def kernel_operands(self, state: EnvState, raw_action: torch.Tensor, u: torch.Tensor):
        """The full-step kernel's (B, rows) operands, in `FullStep.apply`
        order, for the policy's raw action (`_kernel_action`); `u` is the
        uniforms block or the key words."""
        y, planets, goal, ref, col_shift, tili = self._state_operands(state)
        return (y, self._kernel_action(raw_action), planets, goal, ref, col_shift, tili, u)

    def _kernel_action(self, raw_action: torch.Tensor) -> torch.Tensor:
        """K3's action operand, (B, 2) lane-major: a continuous config's raw
        action as the policy gives it (K3 translates it, FullParams'
        `continuous`), a discrete config's table rows."""
        if self.config.continuous:
            return raw_action.to(self.dtype).contiguous()
        return self._translate_action(raw_action).contiguous()

    def to_carry(self, state: EnvState) -> RowCarry:
        """The state as K3's contiguous (rows, B) operands."""
        batch = state.y.shape[0]
        return RowCarry(*[t.reshape(batch, -1).t().contiguous()
                          for t in self._state_operands(state)])

    def from_carry(self, carry: RowCarry) -> EnvState:
        """The EnvState whose fields are (transposed) views of the rows."""
        cfg = self.config
        ti = carry.tili
        if cfg.task == TASK_GOAL:
            n_tiles = cfg.tiling.n_tiles
            tiling = dtiling.TilingState(
                free=ti[:n_tiles].t(),
                ship_tile=ti[n_tiles],
                goal_tile=ti[n_tiles + 1],
                case_b=ti[n_tiles + 3].bool(),
                flip_xy=ti[n_tiles + 4].bool(),
                col_shift=carry.col_shift.t(),
            )
            steps = ti[n_tiles + 2]
        else:
            tiling = None
            steps = ti[0]
        return EnvState(
            y=carry.y.t(),
            planets_pos=carry.planets.t().reshape(-1, cfg.n_planets, 2),
            goal_pos=carry.goal.t(),
            ref_orbit=carry.ref_orbit.t(),
            tiling=tiling,
            steps=steps,
        )

    def step_carry(self, carry: RowCarry, raw_action: torch.Tensor, generator=None):
        """One fuse="full" step on the carried rows: K3's outputs are the next
        carry as they stand (`tio` has `tili`'s row order).  Draws what `step`
        draws, in its order and shapes, so that both give the same bits from
        one generator.  Returns (carry, TimeStep with (B, ...) views)."""
        batch = carry.y.shape[1]
        if self.in_kernel_rng:
            u = self.draw_key(generator)
        else:
            u = self._lane_uniforms(self.n_step_rand, batch, generator, 1)
        y, p, g, r, cs, ti = carry
        yo, po, go, ro, cso, obs, fobs, rew, tio, flags = self.full.step_rows(
            y, self._kernel_action(raw_action), p, g, r, cs, u, ti,
            lane0=self.lane0(batch) if self.in_kernel_rng else 0)
        ts = _time_step(obs, fobs, rew, flags)
        if self.obs_features:
            ts = ts._replace(obs=self._augment_obs(ts.obs),
                             final_obs=self._augment_obs(ts.final_obs))
        return RowCarry(yo, po, go, ro, cso, tio), ts

    def rollout(self, state: EnvState, obs: torch.Tensor, policy_fn: Callable, n_steps: int,
                generator: torch.Generator | None = None, trajectory: bool = True):
        """n_steps of `policy_fn(generator, obs (B, obs_dim))`, which returns
        the raw action, or (raw action, dict of (B, ...) tensors to keep; its
        "action" is kept instead of the raw action), as a loop.  Returns
        (state after the last step, its observation, Trajectory).

        Under fuse="full" the steps run on the carried rows (`step_carry`):
        the policy sees each observation as a transposed view of K3's (D, B)
        output.  The tail tiers loop over `step`.  `capture_rollout` makes
        the same steps one CUDA graph."""
        if self.tier != "full":
            return _rollout_loop(self.step, state, obs, policy_fn, n_steps, generator, trajectory)
        body = self._carried_rollout(policy_fn, n_steps, generator, trajectory)
        carry, obs, traj = body(*self._carried_args(state, obs))
        return self.from_carry(carry), obs, traj

    def capture_rollout(self, policy_fn: Callable, n_steps: int, generator: torch.Generator,
                        trajectory: bool = True):
        """`rollout` of these arguments as one CUDA graph: returns a function
        of (state, obs) that gives what `rollout` gives, bit for bit.  The
        graph is captured at its first call, for that call's lane count, and
        replayed at every later call (utils/graphs.py).  The policy reads
        what it reads (its parameters) where it lives at each replay: its
        owner updates it in place, and captures anew when it moves to other
        tensors.  The generator is the graph's: its uniforms, key words and
        the policy's draws advance it as the loop does.  Needs the card and
        fuse="full"; a capture that fails raises.  Each call is the span
        `sg.graph.call` (utils/profiling.py), its iteration id the count of
        calls."""
        if self.tier != "full" or self.device.type != "cuda":
            raise ValueError("a captured rollout needs the card and fuse='full', got "
                             f"{self.device} and the {self.tier!r} tier")
        if generator is None:
            raise ValueError("a captured rollout draws from an explicit generator")
        body = self._carried_rollout(policy_fn, n_steps, generator, trajectory)
        captured = None
        calls = 0
        profiling.prepare(self.device)

        def run(state: EnvState, obs: torch.Tensor):
            nonlocal captured, calls
            calls += 1
            with profiling.span("graph.call", device=self.device, it=calls):
                args = self._carried_args(state, obs)
                if captured is None:
                    captured = graphs.Captured(body, args, generator)
                carry, obs, traj = captured(*args)
                return self.from_carry(carry), obs, traj

        return run

    def _carried_args(self, state: EnvState, obs: torch.Tensor):
        """A carried rollout's arguments: the RowCarry's rows, then the raw
        observation's (D, B) rows."""
        return (*self.to_carry(state), obs[:, :self.config.obs_dim].t().contiguous())

    def _carried_rollout(self, policy_fn, n_steps, generator, trajectory):
        """The steps of a fuse="full" rollout as a function of
        `_carried_args`; returns (RowCarry, observation, Trajectory)."""
        def body(*a):
            carry, obs0 = RowCarry(*a[:6]), a[6]
            # the first observation, like every later one, as a view of (D, B) rows
            return _rollout_loop(self.step_carry, carry, self._augment_obs(obs0.t()), policy_fn,
                                 n_steps, generator, trajectory)
        return body

    def random_policy(self):
        """Uniform random policy over the action space (for benchmarks)."""
        if self.config.continuous:
            def pol(generator, obs):
                u = self.draw_lanes(lambda s: torch.rand(s, generator=generator, device=obs.device,
                                                         dtype=self.dtype), (obs.shape[0], 2))
                return u * 2.0 - 1.0
        else:
            def pol(generator, obs):
                return self.draw_lanes(lambda s: torch.randint(
                    0, self.config.n_actions, s, generator=generator, device=obs.device,
                    dtype=torch.int32), (obs.shape[0],))
        return pol

    # ------------------------------------------------------------ internals --
    def _count_reset(self) -> int:
        """Uniforms one lane's reset consumes, counted by running the reset
        on one CPU lane of a wide probe (the JAX engine traces it instead)."""
        rs = RandSource(torch.full((1, _PROBE), 0.5, dtype=self.dtype))
        self._reset_lanes(rs)
        return rs.i

    def _count_step(self) -> int:
        """Uniforms one lane's step consumes in a tail tier, counted the same
        way: the tail runs on one CPU lane of a wide probe."""
        probe = torch.full((1, _PROBE), 0.5, dtype=self.dtype)
        state = self._reset_lanes(RandSource(probe))
        if self.config.continuous:
            action = torch.zeros((1, 2), dtype=self.dtype)
        else:
            action = torch.zeros((1,), dtype=torch.int32)
        rs = RandSource(probe)
        self._step_tail(state, action, rs)
        return rs.i

    def _augment_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """Append the opt-in `obs_features` columns to a raw (..., D)
        observation; the identity by default."""
        if not self.obs_features:
            return obs
        d = self.config.obs_dim
        if self.obs_features == "goal":
            feats = goal_math.features_for_config(obs, self.config)
        elif self.obs_features == "dnc":
            feats = dnc_math.features_for_config(obs, self.config)
        else:  # obs ends in [angle, ecc, a] (kepler.py:180-185)
            feats = kepler_math.error_features(
                self._alpha_gm, obs[..., 0:2], obs[..., 4:6], obs[..., d - 3], obs[..., d - 2],
                obs[..., d - 1])
        return torch.cat([obs, feats.to(obs.dtype)], dim=-1)

    def _translate_action(self, raw_action):
        """spaceship_env.py:189-214: continuous rescale or discrete table."""
        if self.config.continuous:
            a = torch.clamp(raw_action.to(self.dtype), -1.0, 1.0)
            return torch.stack([(a[:, 0] + 1) / 2, a[:, 1]], dim=1)
        # made once per device (a captured rollout's eager warm-up makes it):
        # a tensor from a list is a host copy, which a CUDA graph cannot hold
        dev = raw_action.device
        if dev not in self._action_tables:
            self._action_tables[dev] = torch.tensor(DISCRETE_ACTIONS, dtype=self.dtype,
                                                    device=dev)
        return onehot_take(self._action_tables[dev], raw_action.to(torch.int32))

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
        w = torch.clamp(exact.divc(rs.normal().to(self.dtype) * max_w, w_div), -max_w, max_w)
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
        pos = torch.stack([exact.cos(planet_angle), exact.sin(planet_angle)], dim=1) * dist[:, None]
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
        pos = torch.stack([exact.cos(planet_angle), exact.sin(planet_angle)], dim=1) * dist[:, None]
        ship_angle = rs.uniform(maxval=2 * torch.pi).to(dtype)
        vel, w = self._kinematics(rs, 0.07, 3)
        y = torch.cat([pos, ship_angle[:, None], vel, w[:, None]], dim=1)
        B, dev = y.shape[0], y.device
        return (None, y, self._fixed_planets(B, dev), torch.zeros((B, 2), dtype=dtype, device=dev),
                torch.zeros((B, 3), dtype=dtype, device=dev))

    # ------------------------------------------------------------ the tail --
    def _physics(self, y0, action, planets_pos):
        """physics="fixed" or "adaptive": one control interval of every lane
        in plain PyTorch; returns (y (B, 6), terminated (B,))."""
        cfg = self.config
        f32a = self.f32_actions and cfg.continuous

        def rhs(_t, y):
            return field.ship_vector_field(cfg.ship, cfg.planet_masses, planets_pos, action, y,
                                           f32_action=f32a)

        y0 = field.apply_steering_override(cfg.ship, y0, action, f32_action=f32a)
        if self.tier == "fixed":
            ev_fns = tuple((lambda y, f=f: f(planets_pos, y)) for f in self._event_comp_fns)
            out = fixed_rk.fixed_solve_step(rhs, ev_fns, y0, cfg.step_size,
                                            n_substeps=self.substeps,
                                            refine_iters=self.refine_iters)
            return field.wrap_ship_angle(out.y), out.terminated
        stats = {}
        out = rk45.solve_step(rhs, lambda y, p: self._event_fn(p, y), y0, cfg.step_size,
                              event_args=(planets_pos,), stats=stats)
        self.solve_stats = dict(stats, n_steps=out.n_steps)
        # the reference asserts the solver's success (dynamic_model.py:120);
        # a batch has no per-lane assert, so a failed lane is poisoned
        y = torch.where(out.failed[:, None], torch.full_like(out.y, float("nan")), out.y)
        return field.wrap_ship_angle(y), out.terminated

    def _step_tail(self, state: EnvState, raw_action, rs: RandSource):
        """The step of the tail tiers: what the tier's kernel (if any) leaves
        out runs here in plain PyTorch.  The RandSource is consumed as in the
        JAX `_step_lane`: the Goal resample, then the reset."""
        cfg = self.config
        action = self._translate_action(raw_action)
        last_xy = state.y[:, 0:2]

        if self.tier == "env":
            # physics, observation and reward came out of the kernel; only the
            # goal resample, which consumes uniforms, remains
            y, terminated, final_obs, reward = self.env_step(
                state.y, action, state.planets_pos, state.goal_pos, state.ref_orbit)
            if cfg.task == TASK_GOAL:
                _, goal_pos, tiling = self._goal_resample(state, y, rs)
            else:
                goal_pos, tiling = state.goal_pos, state.tiling
        else:
            if self.tier == "physics":
                y, terminated = self.physics_step(state.y, action, state.planets_pos)
            else:
                y, terminated = self._physics(state.y, action, state.planets_pos)
            reward, goal_pos, tiling = self._reward(state, y, last_xy, action, rs)
            # the observation shows the goal that was reached; the new goal
            # enters the next step's state (spaceship_env.py:76-77)
            final_obs = self._observe(state._replace(y=y))

        steps = state.steps + 1
        truncated = (steps >= cfg.max_episode_steps) & ~terminated
        done = terminated | truncated
        cont = EnvState(y=y, planets_pos=state.planets_pos, goal_pos=goal_pos,
                        ref_orbit=state.ref_orbit, tiling=tiling, steps=steps)
        if self.auto_reset:
            fresh = self._reset_lanes(rs)
            new_state = _select_state(done, fresh, cont)
            obs = torch.where(done[:, None], self._observe(fresh), final_obs)
        else:
            new_state = cont
            obs = final_obs
        return new_state, TimeStep(obs=obs, reward=reward, terminated=terminated,
                                   truncated=truncated, done=done, final_obs=final_obs)

    def _reward(self, state: EnvState, y, last_xy, action, rs: RandSource):
        """(reward (B,), goal_pos, tiling) after the step."""
        cfg = self.config
        if cfg.task == TASK_GOAL:
            return self._goal_reward(state, y, last_xy, rs)
        if cfg.task == TASK_KEPLER:
            r = self._kepler_reward(state, y, action)
        else:
            r = torch.full((y.shape[0],), cfg.dnc.reward_per_step, dtype=self.dtype,
                           device=y.device)
        return r, state.goal_pos, state.tiling

    def _goal_resample(self, state: EnvState, y, rs: RandSource):
        """Goal-reach resample (goal.py:154-157): a new goal is drawn for
        every lane, consuming tiling randomness, and taken where the old one
        was reached.  Returns (reached, goal_pos, tiling)."""
        cfg = self.config
        reached = norm2(state.goal_pos - y[:, 0:2]) < cfg.goal_radius
        new_tiling, new_goal = dtiling.find_new_goal(cfg.tiling, state.tiling, rs, self.dtype)
        tiling = dtiling.TilingState(*[_select(reached, a, b)
                                       for a, b in zip(new_tiling, state.tiling)])
        goal_pos = torch.where(reached[:, None], new_goal, state.goal_pos)
        return reached, goal_pos, tiling

    def _goal_reward(self, state: EnvState, y, last_xy, rs: RandSource):
        """goal.py:147-158 (+ _goal_vel_reward2 :160-164,
        _safety_reward_simple2 :204-227), with the goal resample on reach."""
        cfg = self.config
        p = cfg.goal
        pos = y[:, 0:2]

        cur_dist = norm2(state.goal_pos - pos)
        last_dist = norm2(state.goal_pos - last_xy)
        goal_vel_reward = (last_dist - cur_dist) * p.distance_fctr

        # the reference's closest-planet scan squares numpy SCALARS
        # (goal.py:204-227): libm pow in the parity mode, not x*x, and the
        # IEEE sqrt
        def scalar_dist(a, b):
            d = a - b
            return exact.sqrt(exact.powf(d[..., 0], 2) + exact.powf(d[..., 1], 2))

        dists = scalar_dist(pos[:, None, :], state.planets_pos)          # (B, P)
        mindist, closest = dists.min(dim=1)
        closest = closest.to(torch.int32)
        radius = onehot_take(torch.tensor(cfg.planet_radii, dtype=self.dtype, device=y.device),
                             closest)
        oh = closest[:, None] == torch.arange(cfg.n_planets, dtype=torch.int32, device=y.device)
        closest_pos = torch.where(oh[:, :, None], state.planets_pos,
                                  torch.zeros((), dtype=self.dtype, device=y.device)).sum(1)
        prev_dist = scalar_dist(last_xy, closest_pos)
        in_danger = (mindist - radius) < p.danger_zone
        approaching = prev_dist > mindist
        safety = torch.where(in_danger & approaching, -p.distance_fctr * (prev_dist - mindist),
                             torch.zeros_like(mindist))

        reward = (p.survival_reward_scale + p.goal_vel_reward_scale * goal_vel_reward
                  + p.safety_reward_scale * safety)
        reached, goal_pos, tiling = self._goal_resample(state, y, rs)
        reward = reward + torch.where(reached, p.goal_sparse_reward, 0.0)
        return reward.to(self.dtype), goal_pos, tiling

    def _kepler_reward(self, state: EnvState, y, action):
        """_dense_reward5 (kepler.py:111-150)."""
        k = self.config.kepler
        ref = state.ref_orbit
        # np.linalg.norm(last_action): float32 sdot for continuous actions
        xp = exact.exact_xp if exact.enabled() else kepler_math.TORCH_OPS
        return kepler_math.dense_reward(
            self._alpha_gm, y[:, 0:2], y[:, 3:5], norm2(action), ref[:, 0], ref[:, 2], ref[:, 1],
            k.numerator_C, k.rad_penalty_C, k.act_penalty_C, xp,
        ).to(self.dtype)

    # ---------------------------------------------------------- observation --
    def _observe(self, state: EnvState) -> torch.Tensor:
        """spaceship_env.py:113-140 (raw, unnormalised) + Kepler's appended
        orbit parameters (kepler.py:172-187); the reset observation."""
        cfg = self.config
        y = state.y
        pos = y[:, 0:2]
        parts = [pos, torch.stack([exact.cos(y[:, 2]), exact.sin(y[:, 2])], dim=1), y[:, 3:5],
                 y[:, 5:6]]
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
        ang = torch.remainder(exact.atan2(v[..., 1], v[..., 0]), 2 * torch.pi)
        # np.linalg.norm (BLAS dot) in the parity mode
        dist = exact.norm_last(v) if exact.enabled() else torch.sqrt((v * v).sum(-1))
        scale = exact.divc((dist - obj_radius) * 2, self.config.world_size)
        return torch.stack([exact.cos(ang), exact.sin(ang)], dim=-1) * scale[..., None]


class PolicyRollout:
    """n_steps of `policy(params, generator, obs)` on `engine`, for a trainer
    or an evaluator that rolls out the same policy again and again and
    updates its parameters in place.  Its owner calls it as
    `rollout(params, state, obs, generator)` and gets what
    `EnvEngine.rollout` gives.

    With `graph` (set where a graph can be made: on the card under
    fuse="full") the steps are one CUDA graph (`EnvEngine.capture_rollout`),
    captured at the first call and again when `params` or the generator are
    other tensors than those of the graph (a new or a restored state): the
    graph reads the tensors it was captured with.  It holds one graph at a
    time.  Without it (the CPU, the tail tiers, or `graph = False` set by the
    caller) it is the loop of `EnvEngine.rollout`.  `graph = True` where no
    graph can be made raises."""

    def __init__(self, engine: EnvEngine, policy: Callable, n_steps: int,
                 trajectory: bool = True):
        self.engine = engine
        self.policy = policy
        self.n_steps = n_steps
        self.trajectory = trajectory
        self.graph = engine.device.type == "cuda" and engine.tier == "full"
        self._key = self._run = None

    def __call__(self, params: dict, state: EnvState, obs: torch.Tensor,
                 generator: torch.Generator):
        def bound(g, o):
            return self.policy(params, g, o)

        if not self.graph:
            return self.engine.rollout(state, obs, bound, self.n_steps, generator,
                                       self.trajectory)
        key = (generator, *[(t.data_ptr(), t.shape, t.stride()) for t in params.values()])
        if key != self._key:
            self._key = self._run = None  # frees the old graph's memory first
            self._run = self.engine.capture_rollout(bound, self.n_steps, generator,
                                                    self.trajectory)
            self._key = key
        return self._run(state, obs)


def _time_step(obs, fobs, rew, flags) -> TimeStep:
    """K3's (D, B) observations, (1, B) reward and (3, B) bool flags as a
    TimeStep of (B, ...) views."""
    return TimeStep(obs=obs.t(), reward=rew[0], terminated=flags[0], truncated=flags[1],
                    done=flags[2], final_obs=fobs.t())


def _rollout_loop(step, carry, obs, policy_fn, n_steps, generator, trajectory):
    """The steps of a rollout: `step(carry, raw action, generator)` ->
    (carry, TimeStep).  Returns (carry, observation, Trajectory)."""
    rewards = 0  # per lane, summed at the end: one reduction, not two a step
    steps = []
    for t in range(n_steps):
        out = policy_fn(generator, obs)
        action, kept = out if isinstance(out, tuple) else (out, {})
        carry, ts = step(carry, action, generator)
        rewards = rewards + ts.reward
        # int32 counts, one kernel a step: int32 + bool stays int32
        dones = ts.done.to(torch.int32) if t == 0 else dones + ts.done
        if trajectory:
            steps.append((obs, {"action": action, **kept}, ts))
        obs = ts.obs
    reward_sum, done_sum = rewards.sum(), dones.sum()
    if not trajectory:
        return carry, obs, Trajectory(None, None, None, None, None, None, None, reward_sum,
                                      done_sum)
    kept = {k: torch.stack([s[1][k] for s in steps]) for k in steps[0][1]}
    ts = TimeStep(*[torch.stack(f) for f in zip(*[s[2] for s in steps])])
    return carry, obs, Trajectory(
        obs=torch.stack([s[0] for s in steps]), kept=kept, reward=ts.reward,
        terminated=ts.terminated, truncated=ts.truncated, done=ts.done,
        final_obs=ts.final_obs, reward_sum=reward_sum, done_sum=done_sum)


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per lane, a where mask (B,) else b; trailing axes broadcast."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _select_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per lane, state a where mask else state b."""
    tiling = None
    if a.tiling is not None:
        tiling = dtiling.TilingState(*[_select(mask, x, y) for x, y in zip(a.tiling, b.tiling)])
    return EnvState(y=_select(mask, a.y, b.y),
                    planets_pos=_select(mask, a.planets_pos, b.planets_pos),
                    goal_pos=_select(mask, a.goal_pos, b.goal_pos),
                    ref_orbit=_select(mask, a.ref_orbit, b.ref_orbit),
                    tiling=tiling, steps=_select(mask, a.steps, b.steps))
