"""Full-episode BITWISE replay of the recorded reference trajectories through
the port's own batched engine (EnvEngine, float64 adaptive physics).

Counterpart of space_gym_tpu/parity/device_replay.py.  The engine's step
path (action translation, scipy's adaptive RK45 with event roots,
observation, reward with Goal's mid-episode resample, termination and
TimeLimit) runs as it does for every user of `physics="adaptive"`, and must
reproduce the reference's obs, reward, done and state at every step of every
recorded episode (tests/goldens: 7 env IDs x 2 seed sets), bit for bit.

Randomness: the engine consumes it through RandSource slots; the parity
engine feeds the SEMANTIC draws recorded from the reference's MT19937
streams instead of uniforms:

* Kepler: the env RNG's scalar draws themselves (angles, distance, the two
  global-np.random orbit uniforms of randomize=True, the velocity and spin
  normals); the reset state is assembled by the engine with the reference's
  expressions.
* Goal: the TILING DRAWS (case/flip/col-shift/gate uniforms, range-scaled
  disk angles, and the integer outputs of randint and choice); the sampler's
  arithmetic runs in the sequential-exact twin (tiling/device_exact.py), so
  ship, planet and goal POSITIONS are computed, not injected.
* Goal resample: the step feed carries that resample's tiling draws (zeros
  on steps without one); the engine's own reach decision gates whether the
  new goal and free list apply.

The parity engine enters ops/exact.py's `parity()` around its reset and
step, so its norms, dots, pow, trigonometry and constant divisions round as
numpy's, on the CPU through the host library directly and on the card
through a host round trip per op (`exact.counts`).  No environment variable
and no subprocess: other engines in the process keep their bits.

Usage: python -m space_gym_torch.parity.device_replay [--env-id ID]
[--subset s] [--golden-dir DIR] [--sampler-oracle] [--device cpu]
Prints one JSON line per (env_id, subset) and exits non-zero on any step
that is not bitwise.  Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import get_config
from ..engine.core import EnvEngine, _select
from ..envs.config import TASK_GOAL, TASK_KEPLER
from ..ops import exact
from ..tiling import device_exact as dx
from ..tiling.device import TilingState
from ..tiling.host import HostTiling
from ..utils import seeding
from ..utils.device import resolve_device
from ..utils.randvec import RandSource

GOLDEN_IDS = [
    "GoalContinuous2P-v0",
    "GoalContinuous3P-v0",
    "GoalContinuous4P-v0",
    "KeplerCircleOrbit-v0",
    "KeplerEllipseEasy-v0",
    "KeplerEllipseHard-v0",
    "KeplerRandomOrbits-v0",
]
GOLDEN_SETS = ["", "seed7"]
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens")


class ParityRand(RandSource):
    """RandSource twin over a (B, n) feed whose uniform() and normal() return
    the recorded SEMANTIC values verbatim: the feed holds post-transform draws
    where the reference's RNG scaled a range, and recorded normals (MT19937's
    polar method cannot be reproduced from a uniform)."""

    def uniform(self, n=None, minval=0.0, maxval=1.0):
        return self._take_one_or_n(n)

    def normal(self, n=None):
        return self._take_one_or_n(n)


class ParityEngine(EnvEngine):
    """EnvEngine with the reset and resample randomness replaced by semantic
    slots; everything else (physics, obs, rewards, termination, truncation)
    is the stock tail path of `physics="adaptive"`."""

    def __init__(self, config, device=None):
        # set before the base class counts the reset's and the step's slots
        # through the overridden methods below
        self._exact_consts = (dx.make_exact_consts(config.tiling)
                              if config.task == TASK_GOAL else None)
        super().__init__(config, physics="adaptive", dtype=torch.float64, auto_reset=False,
                         f32_actions=True, device=device)

    def _translate_action(self, raw_action):
        # the continuous translation in float32 as the reference does it
        # (spaceship_env.py:69-71, 210-214), with no clamp: (a+1)/2 ROUNDS in
        # float32 when a+1 needs 25 mantissa bits
        if self.config.continuous:
            a = raw_action.to(torch.float32)
            return torch.stack([(a[:, 0] + 1) / 2, a[:, 1]], dim=1)
        return super()._translate_action(raw_action)

    def _reset_goal(self, rs):
        # the tiling DRAWS in hexagonal_tiling.py:53-134 call order, through
        # the sequential-exact twin, then the env RNG's draws as goal.py:140-145
        cfg = self.config
        ts, positions = dx.reset_exact(cfg.tiling, self._exact_consts, rs, self.dtype)
        ts, goal = dx.find_new_goal_exact(cfg.tiling, self._exact_consts, ts, rs, self.dtype)
        angle = rs.uniform(maxval=2 * torch.pi).to(self.dtype)
        vel, w = self._kinematics(rs, 0.07, 3)
        y = torch.cat([positions[:, 0], angle[:, None], vel, w[:, None]], dim=1)
        ref = torch.zeros((y.shape[0], 3), dtype=self.dtype, device=y.device)
        return ts, y, positions[:, 1:], goal, ref

    def _goal_resample(self, state, y, rs):
        # the reach decision on the engine's state (bitwise state, bitwise
        # decision); the new goal is COMPUTED from that resample's fed draws
        # (zeros on steps without one: consumed, then masked out)
        cfg = self.config
        new_ts, new_goal = dx.find_new_goal_exact(cfg.tiling, self._exact_consts, state.tiling,
                                                  rs, self.dtype)
        reached = exact.norm_last(state.goal_pos - y[:, 0:2]) < cfg.goal_radius
        goal_pos = torch.where(reached[:, None], new_goal, state.goal_pos)
        tiling = TilingState(*[_select(reached, n, o) for n, o in zip(new_ts, state.tiling)])
        return reached, goal_pos, tiling

    # -- the feed-driven entry points.  Slot COUNTS are RandSource's (one slot
    # per value either way), so the engine's n_reset_rand and n_step_rand,
    # counted through the methods above, are the feed sizes.
    def reset_from_feed(self, feed: torch.Tensor):
        """(state, obs) of every lane from its (B, n_reset_rand) feed."""
        with exact.parity():
            state = self._reset_lanes(ParityRand(feed))
            return state, self._observe(state)

    def step_from_feed(self, state, raw_action, feed: torch.Tensor):
        """One step of every lane on its (B, n_step_rand) feed; returns
        (state, TimeStep)."""
        with exact.parity():
            return self._step_tail(state, raw_action, ParityRand(feed))


def make_parity_engine(env_id: str, device=None) -> ParityEngine:
    """The parity engine of `env_id` on `device` (the card by default)."""
    return ParityEngine(get_config(env_id), device=device)


class _DrawRecorder:
    """RandomState proxy that logs every RNG call HostTiling makes, so that
    the feed builder takes the draw sequence from the bitwise HOST ORACLE
    itself instead of re-implementing its control flow."""

    def __init__(self, rng):
        self._rng = rng
        self.log = []

    def uniform(self, low=0.0, high=1.0, size=None):
        v = self._rng.uniform(low, high, size)
        self.log.append(("uniform", np.atleast_1d(np.asarray(v, np.float64))))
        return v

    def randint(self, n):
        v = self._rng.randint(n)
        self.log.append(("randint", np.asarray([v], np.float64)))
        return v

    def choice(self, n, size=None, replace=True):
        v = self._rng.choice(n, size=size, replace=replace)
        self.log.append(("choice", np.asarray(v, np.float64).reshape(-1)))
        return v


def _take(it, kind):
    k, v = next(it)
    assert k == kind, (k, kind)
    return v


def _parse_goal_draws(it):
    """find_new_goal's draws -> the fixed 6-slot feed segment:
    [u_reuse, cand(3, zero-padded), goal_angle, goal_r]."""
    u_reuse = _take(it, "uniform")
    cand = np.zeros(3)
    if u_reuse[0] >= 0.25:
        c = _take(it, "choice")
        cand[: len(c)] = c
    g_angle = _take(it, "uniform")
    g_r = _take(it, "uniform")
    return np.concatenate([u_reuse, cand, g_angle, g_r])


def _parse_goal_reset_draws(geom, log):
    """HostTiling.reset() + find_new_goal() draw log -> the fixed-layout
    tiling segment of the reset feed (device_exact's consumption order):
    u_case(2), u_cols(cols), [2P: u_diag, diag_idx], tiles(n_obj),
    angles(n_obj), r_u(n_obj), then the 6-slot goal segment."""
    it = iter(log)
    n_obj = geom.n_planets + 1
    parts = [_take(it, "uniform"), _take(it, "uniform")]  # case/flip, cols
    if geom.n_planets == 2:
        u_diag = _take(it, "uniform")
        if u_diag[0] < 0.25:
            d = _take(it, "randint")
            parts += [u_diag, d, np.zeros(n_obj)]
        else:
            tiles = _take(it, "choice")
            parts += [u_diag, np.zeros(1), tiles]
    else:
        parts += [_take(it, "choice")]
    parts += [_take(it, "uniform"), _take(it, "uniform")]  # angles, r_u
    parts += [_parse_goal_draws(it)]
    rest = list(it)
    assert not rest, f"unconsumed tiling draws: {rest}"
    return np.concatenate(parts)


class GoalEpisodeFeeder:
    """Per-episode feeds of a Goal env: replays the HOST tiling oracle
    (tiling/host.HostTiling) on a recording RandomState and emits the
    draw-level feeds the twin consumes.  Resample feeds are made at the
    steps where the golden goal sequence changes."""

    N_STEP_SLOTS = 6

    def __init__(self, geom, tiling_rng):
        self.geom = geom
        self.rec = _DrawRecorder(tiling_rng)
        self.ht = HostTiling(geom, self.rec)

    def reset_feed_tiling(self, golden, p):
        self.rec.log.clear()
        positions = self.ht.reset()
        goal = self.ht.find_new_goal()
        # the host oracle must agree with the recorded goldens (it is the
        # same code that produced them)
        np.testing.assert_array_equal(positions[0], golden[p + "reset_state"][:2])
        np.testing.assert_array_equal(np.asarray(positions[1:]), golden[p + "reset_planets"])
        np.testing.assert_array_equal(goal, golden[p + "reset_goal"])
        feed = _parse_goal_reset_draws(self.geom, self.rec.log)
        self.cur_goal = np.asarray(golden[p + "reset_goal"])
        assert len(self.ht.free_tiles) <= self.geom.n_tiles + dx.FREE_CAP_EXTRA
        return feed

    def step_feed(self, golden, p, t):
        """The 6-slot tiling segment of step t: real draws iff this step
        resampled the goal (the golden goal changes), zeros otherwise."""
        g_t = np.asarray(golden[p + "goals"][t])
        if np.array_equal(g_t, self.cur_goal):
            return np.zeros(self.N_STEP_SLOTS)
        self.rec.log.clear()
        goal = self.ht.find_new_goal()
        np.testing.assert_array_equal(goal, g_t)
        assert len(self.ht.free_tiles) <= self.geom.n_tiles + dx.FREE_CAP_EXTRA
        feed = _parse_goal_draws(iter(self.rec.log))
        self.cur_goal = g_t
        return feed


def build_reset_feed(env_id, golden, ep, seed):
    """Draw-level reset feed in the ParityEngine's consumption order, from
    the reference's RNG call sequences (SURVEY.md §3.2) through the same
    sha512 -> MT19937 derivation (utils/seeding.py).  For Goal envs also
    returns the episode's step-feed generator (tiling stream)."""
    cfg = get_config(env_id)
    p = f"ep{ep}_"
    rng, _ = seeding.np_random(seed + ep)
    np.random.seed(seed + 1000 * ep)  # Kepler's randomize uses the GLOBAL np.random (Q6)

    if cfg.task == TASK_GOAL:
        # the tiling RNG: an independent RandomState seeded with the SAME
        # seed as the env RNG (goal.py:74-77, gym_api.seed)
        t_rng, _ = seeding.np_random(seed + ep)
        feeder = GoalEpisodeFeeder(cfg.tiling, t_rng)
        tiling_feed = feeder.reset_feed_tiling(golden, p)
        angle = rng.uniform(0, 2 * np.pi)
        n_vel = rng.standard_normal(2)
        n_w = rng.standard_normal()
        return np.concatenate([tiling_feed, [angle], n_vel, [n_w]]), feeder

    if cfg.task == TASK_KEPLER:
        k = cfg.kepler
        planet_angle = rng.uniform(0, 2 * np.pi)
        dist = rng.uniform(k.planet_radius + 0.5, k.border_radius - 0.5)
        ship_angle = rng.uniform(0, 2 * np.pi)
        parts = [planet_angle, dist, ship_angle]
        if k.randomize:
            parts += [np.random.uniform(), np.random.uniform()]
        n_vel = rng.standard_normal(2)
        n_w = rng.standard_normal()
        return np.asarray(parts + [n_vel[0], n_vel[1], n_w], float), None

    raise ValueError(f"no goldens exist for task family of {env_id}")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def replay(env_id: str, subset: str, golden_dir: str | None = None, device=None) -> dict:
    """Every recorded episode of one golden file through the parity engine
    on `device` (the card by default), one lane per episode.  Returns the
    counts of bitwise steps, the largest errors, ms per step on the host
    clock (around synchronised steps) and the host round trips per step."""
    g = np.load(os.path.join(golden_dir or GOLDEN_DIR, subset, f"{env_id}.npz"))
    seed = int(g["seed"])
    eng = make_parity_engine(env_id, device)
    dev = eng.device
    n_reset, n_step = eng.n_reset_rand, eng.n_step_rand

    stats = dict(env_id=env_id, subset=subset or "seed42", episodes=int(g["episodes"]),
                 steps=0, state_bitwise=0, obs_bitwise=0, reward_bitwise=0, flag_match=0,
                 max_state_err=0.0, max_obs_err=0.0, max_reward_err=0.0)
    mismatches = []
    trips0, step_s = exact.counts["round_trips"], 0.0

    def note(err_key, got, want):
        stats[err_key] = max(stats[err_key], _err(got, want))
        return np.array_equal(got, want)

    for ep in range(int(g["episodes"])):
        p = f"ep{ep}_"
        feed, feeder = build_reset_feed(env_id, g, ep, seed)
        assert feed.shape[0] == n_reset, (feed.shape, n_reset)
        state, obs0 = eng.reset_from_feed(torch.as_tensor(feed[None], device=dev))
        checks = [("reset_state", state.y, "max_state_err"), ("reset_obs", obs0, "max_obs_err")]
        if feeder is not None:  # the engine must have COMPUTED the layout
            checks += [("reset_planets", state.planets_pos, "max_state_err"),
                       ("reset_goal", state.goal_pos, "max_state_err")]
        for key, got, err_key in checks:
            if not note(err_key, _host(got[0]), g[p + key]):
                mismatches.append(f"ep{ep} {key}")

        actions = g[p + "actions"]
        goals = g[p + "goals"] if feeder is not None else None
        for t in range(len(actions)):
            ufeed = feeder.step_feed(g, p, t)[None] if n_step else np.zeros((1, 0))
            assert ufeed.shape[1] == n_step, (ufeed.shape, n_step)
            act = torch.as_tensor(np.asarray(actions[t])[None], device=dev)
            ufeed = torch.as_tensor(ufeed, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, ts = eng.step_from_feed(state, act, ufeed)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s += time.perf_counter() - t0
            stats["steps"] += 1
            ok_state = note("max_state_err", _host(state.y[0]), g[p + "post_states"][t])
            if goals is not None:
                # the post-step goal too, through resamples: it is COMPUTED
                ok_state = note("max_state_err", _host(state.goal_pos[0]), goals[t]) and ok_state
            ok_obs = note("max_obs_err", _host(ts.final_obs[0]), g[p + "obs"][t])
            ok_rew = note("max_reward_err", _host(ts.reward[0]), g[p + "rewards"][t])
            ok_flag = (bool(ts.done[0]) == bool(g[p + "dones"][t])
                       and bool(ts.truncated[0]) == bool(g[p + "truncated"][t]))
            stats["state_bitwise"] += int(ok_state)
            stats["obs_bitwise"] += int(ok_obs)
            stats["reward_bitwise"] += int(ok_rew)
            stats["flag_match"] += int(ok_flag)
            if not (ok_state and ok_obs and ok_rew and ok_flag) and len(mismatches) < 8:
                mismatches.append(f"ep{ep} t{t}: state={ok_state} obs={ok_obs} "
                                  f"rew={ok_rew} flags={ok_flag}")

    n = stats["steps"]
    stats["bitwise"] = (not mismatches and stats["state_bitwise"] == n
                        and stats["obs_bitwise"] == n and stats["reward_bitwise"] == n
                        and stats["flag_match"] == n)
    stats["ms_per_step"] = step_s * 1e3 / n
    stats["host_round_trips"] = exact.counts["round_trips"] - trips0
    if mismatches:
        stats["mismatches"] = mismatches
    return stats


def sampler_oracle(n_seeds: int = 4, n_resamples: int = 20, device=None) -> dict:
    """Deep draw-level oracle of the tiling twin, far beyond the golden
    episodes' sparse goal reaches: for each Goal config and seed, HostTiling
    (the declared bitwise sampler oracle) runs through the draw recorder, a
    reset and `n_resamples` find_new_goal calls that exercise the ordered free list's
    appends, duplicates and pops, and the recorded draws go through
    tiling/device_exact on `device`, the seeds as lanes.  Returns the count
    of seeds whose ship, planet or goal positions are not all BITWISE equal,
    per config, and "ok"."""
    dev = resolve_device(device)
    results = {}
    for env_id in GOLDEN_IDS[:3]:
        geom = get_config(env_id).tiling
        consts = dx.make_exact_consts(geom)
        heads, goals, reset_feeds, goal_feeds = [], [], [], []
        for seed in range(n_seeds):
            rng, _ = seeding.np_random(seed)
            rec = _DrawRecorder(rng)
            ht = HostTiling(geom, rec)
            positions = ht.reset()
            g0 = ht.find_new_goal()
            reset_feeds.append(_parse_goal_reset_draws(geom, rec.log))
            hg, gf = [], []
            for _ in range(n_resamples):
                rec.log.clear()
                hg.append(ht.find_new_goal())
                gf.append(_parse_goal_draws(iter(rec.log)))
            assert len(ht.free_tiles) <= consts.cap
            heads.append(np.concatenate([np.asarray(positions).reshape(-1), g0]))
            goals.append(np.stack(hg))
            goal_feeds.append(np.stack(gf))
        with exact.parity():
            rs = ParityRand(torch.as_tensor(np.stack(reset_feeds), device=dev))
            ts, positions = dx.reset_exact(geom, consts, rs, torch.float64)
            ts, g0 = dx.find_new_goal_exact(geom, consts, ts, rs, torch.float64)
            feeds = torch.as_tensor(np.stack(goal_feeds), device=dev)
            gs = []
            for i in range(n_resamples):
                ts, gp = dx.find_new_goal_exact(geom, consts, ts, ParityRand(feeds[:, i]),
                                                torch.float64)
                gs.append(gp)
        head = _host(torch.cat([positions.reshape(n_seeds, -1), g0], dim=1))
        gs = _host(torch.stack(gs, dim=1))
        results[env_id] = sum(
            int(not (np.array_equal(head[s], heads[s]) and np.array_equal(gs[s], goals[s])))
            for s in range(n_seeds))
    return {"sampler_oracle": results, "resamples_per_seed": n_resamples, "seeds": n_seeds,
            "ok": not any(results.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env-id", default=None, help="one ID (default: all seven)")
    ap.add_argument("--subset", default=None, help="'' or 'seed7' (default: both)")
    ap.add_argument("--golden-dir", default=None, help="default: the repo's tests/goldens")
    ap.add_argument("--sampler-oracle", action="store_true",
                    help="run the deep host-vs-twin tiling sampler oracle instead of the "
                         "golden replay")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    if args.sampler_oracle:
        out = sampler_oracle(device=args.device)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    ids = [args.env_id] if args.env_id else GOLDEN_IDS
    subsets = [args.subset] if args.subset is not None else GOLDEN_SETS
    ok = True
    for env_id in ids:
        for subset in subsets:
            st = replay(env_id, subset, args.golden_dir, args.device)
            print(json.dumps(st), flush=True)
            ok = ok and st["bitwise"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
