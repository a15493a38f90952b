"""What the checks share about the Goal env: the program's configuration held
to the file's, the program's state as the reference's rows, the lane-by-lane
comparison, and the reference's step as one CUDA graph."""
from __future__ import annotations

import math

import torch

from .reference.goal_env import GoalEnv, Lanes

# a lane is off when an integer row differs or a float differs by more than
# this, relative to max(1, |reference|)
LANE_TOL = 1e-3


def program_config(env: dict):
    """The port's EnvConfig of the file's env, held to the file's numbers."""
    from space_gym_torch import get_config

    cfg = get_config(env["env_id"])
    want = {
        "n_planets": env["n_planets"], "world_size": env["world_size"],
        "max_abs_vel_angle": env["max_abs_vel_angle"], "step_size": env["step_size"],
        "max_episode_steps": env["max_episode_steps"], "continuous": env["continuous"],
        "ship.mass": env["ship"]["mass"], "ship.moi": env["ship"]["moi"],
        "ship.max_engine_force": env["ship"]["max_engine_force"],
        "ship.max_thruster_force": env["ship"]["max_thruster_force"],
        "ship.steering": 1 if env["ship"]["steering"] == "velocity" else 0,
        **{f"goal.{k}": v for k, v in env["goal"].items()},
    }
    for key, v in want.items():
        obj = cfg
        for part in key.split("."):
            obj = getattr(obj, part)
        if obj != v:
            raise ValueError(f"{env['env_id']}: the program's {key} is {obj}, the "
                             f"configuration file's {v}")
    return cfg


def lanes_of(state, idx, dtype) -> Lanes:
    """The program's EnvState at lanes `idx` as the reference's rows."""
    ts = state.tiling

    def rows(t):
        return [r.to(dtype) for r in t[idx].reshape(len(idx), -1).t()]

    return Lanes(rows(state.y), rows(state.planets_pos), rows(state.goal_pos),
                 rows(ts.col_shift), [r.to(torch.int32) for r in ts.free[idx].t()],
                 ts.ship_tile[idx].to(torch.int32), ts.goal_tile[idx].to(torch.int32),
                 state.steps[idx].to(torch.int32), ts.case_b[idx].bool(), ts.flip_xy[idx].bool())


def lanes_off(got: Lanes, got_obs, want: Lanes, want_obs) -> torch.Tensor:
    """Per lane, whether `got` departs from `want`: an integer row differs, or
    a float by more than LANE_TOL relative to max(1, |want|); the ship's
    angle is compared on the circle."""
    off = torch.zeros_like(want.steps, dtype=torch.bool)
    for g, w in zip(got.free + [got.ship_tile, got.goal_tile, got.steps, got.case_b, got.flip],
                    want.free + [want.ship_tile, want.goal_tile, want.steps, want.case_b,
                                 want.flip]):
        off |= g.to(torch.int64) != w.to(torch.int64)
    floats_g = got.y + got.planets + got.goal + got.col_shift + list(got_obs)
    floats_w = want.y + want.planets + want.goal + want.col_shift + list(want_obs)
    for i, (g, w) in enumerate(zip(floats_g, floats_w)):
        g, w = g.double(), w.double()
        d = (g - w).abs()
        if i == 2:  # theta in [0, 2 pi)
            d = torch.minimum(d, 2 * math.pi - d)
        off |= ~(d <= LANE_TOL * torch.clamp(w.abs(), min=1.0))
    return off


def flat(lanes: Lanes) -> list:
    return [*lanes.y, *lanes.planets, *lanes.goal, *lanes.col_shift, *lanes.free,
            lanes.ship_tile, lanes.goal_tile, lanes.steps, lanes.case_b, lanes.flip]


def unflat(like: Lanes, ts: list) -> Lanes:
    it = iter(ts)
    rows = {f: [next(it) for _ in getattr(like, f)] for f in ("y", "planets", "goal",
                                                              "col_shift", "free")}
    return Lanes(**rows, ship_tile=next(it), goal_tile=next(it), steps=next(it),
                 case_b=next(it), flip=next(it))


class GraphStep:
    """`env.step` captured once into a CUDA graph and replayed at every step:
    the reference's own plain operations, launched as one graph instead of one
    by one.  A call copies its arguments into the graph's inputs and returns
    the graph's outputs, which the next call overwrites."""

    def __init__(self, env: GoalEnv, lanes: Lanes, action, u):
        self.like = lanes
        self.ins = [t.clone() for t in flat(lanes)]
        self.action, self.u = action.clone(), u.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            env.step(unflat(lanes, self.ins), self.action, self.u)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = env.step(unflat(lanes, self.ins), self.action, self.u)

    def __call__(self, lanes: Lanes, action, u):
        for dst, src in zip(self.ins, flat(lanes)):
            dst.copy_(src)
        self.action.copy_(action)
        self.u.copy_(u)
        self.graph.replay()
        return self.out
