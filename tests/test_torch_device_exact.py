"""The port's sequential-exact tiling twin (space_gym_torch/tiling/
device_exact.py) and its feed builders (space_gym_torch/parity/
device_replay.py) against the JAX package.

* The port's sampler oracle runs the draws of the JAX package's HostTiling
  (the declared bitwise sampler oracle) through the twin: every ship, planet
  and goal position bit for bit, 3 Goal configs x 4 seeds x 20 resamples.
* The twin against space_gym_tpu/tiling/device_exact.py under jax.jit in its
  default mode, on the same feeds: integer state (the ordered free list,
  ship and goal tiles, case, flip) equal, positions within 1e-12.
* The feeds the port builds from a golden equal the JAX package's.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_gym_tpu.parity import device_replay as jreplay
from space_gym_tpu.tiling import device_exact as jdx
from space_gym_tpu.tiling.host import HostTiling as JaxHostTiling
from space_gym_torch import get_config
from space_gym_torch.parity import device_replay as replay
from space_gym_torch.tiling import device_exact as dx
from space_gym_torch.utils import seeding

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

GOAL_IDS = replay.GOLDEN_IDS[:3]
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SEEDS, RESAMPLES = 4, 20
TOL_POS = 1e-12


def test_sampler_oracle_is_bitwise_against_the_jax_host_tiling(monkeypatch):
    monkeypatch.setattr(replay, "HostTiling", JaxHostTiling)
    out = replay.sampler_oracle(SEEDS, RESAMPLES, device="cpu")
    assert out["ok"], out
    assert set(out["sampler_oracle"]) == set(GOAL_IDS)


def _feeds(geom, seed):
    """The draw feeds of one seed: the reset's, then RESAMPLES goal feeds
    (recorded from the port's HostTiling)."""
    rec = replay._DrawRecorder(seeding.np_random(seed)[0])
    ht = replay.HostTiling(geom, rec)
    ht.reset()
    ht.find_new_goal()
    reset = replay._parse_goal_reset_draws(geom, rec.log)
    goals = []
    for _ in range(RESAMPLES):
        rec.log.clear()
        ht.find_new_goal()
        goals.append(replay._parse_goal_draws(iter(rec.log)))
    return reset, np.stack(goals)


@functools.cache
def _jax_twin(env_id):
    """JAX's twin over a reset feed and a stack of goal feeds, jitted over
    the seeds: (reset tiling, positions, first goal, goals, final tiling)."""
    geom = get_config(env_id).tiling
    consts = jdx.make_exact_consts(geom)

    def one(reset_feed, goal_feeds):
        rs = jreplay.ParityRand(reset_feed)
        ts0, positions = jdx.reset_exact(geom, consts, rs, jnp.float64)
        ts, g0 = jdx.find_new_goal_exact(geom, consts, ts0, rs, jnp.float64)

        def step(ts, feed):
            return jdx.find_new_goal_exact(geom, consts, ts, jreplay.ParityRand(feed),
                                           jnp.float64)

        ts, gs = jax.lax.scan(step, ts, goal_feeds)
        return ts0, positions, g0, gs, ts

    return jax.jit(jax.vmap(one))


def _ints(ts):
    return [np.asarray(ts.free), np.asarray(ts.ship_tile), np.asarray(ts.goal_tile),
            np.asarray(ts.case_b), np.asarray(ts.flip_xy)]


@pytest.mark.parametrize("env_id", GOAL_IDS)
def test_twin_matches_the_jax_twin(env_id):
    geom = get_config(env_id).tiling
    consts = dx.make_exact_consts(geom)
    reset, goals = zip(*[_feeds(geom, s) for s in range(SEEDS)])
    reset, goals = np.stack(reset), np.stack(goals)
    jts0, jpos, jg0, jgs, jts = _jax_twin(env_id)(jnp.asarray(reset), jnp.asarray(goals))

    rs = replay.ParityRand(torch.as_tensor(reset))
    ts0, pos = dx.reset_exact(geom, consts, rs, torch.float64)
    ts, g0 = dx.find_new_goal_exact(geom, consts, ts0, rs, torch.float64)
    gs = []
    for i in range(RESAMPLES):
        ts, g = dx.find_new_goal_exact(geom, consts, ts, replay.ParityRand(
            torch.as_tensor(goals[:, i])), torch.float64)
        gs.append(g)
    assert rs.i == reset.shape[1]
    for got, want in [(ts0, jts0), (ts, jts)]:
        for a, b in zip(_ints(got), _ints(want)):
            np.testing.assert_array_equal(a, b)
    for got, want in [(ts0.col_shift, jts0.col_shift), (pos, jpos), (g0, jg0),
                      (torch.stack(gs, 1), jgs)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_POS)


@pytest.mark.parametrize("env_id", replay.GOLDEN_IDS)
def test_feeds_equal_the_jax_feeds(env_id):
    """build_reset_feed for every episode of both seed sets, and for Goal
    every step's resample feed of the first episode."""
    for subset in replay.GOLDEN_SETS:
        g = np.load(os.path.join(GOLDENS, subset, f"{env_id}.npz"))
        seed = int(g["seed"])
        for ep in range(int(g["episodes"])):
            feed, feeder = replay.build_reset_feed(env_id, g, ep, seed)
            jfeed, jfeeder = jreplay.build_reset_feed(env_id, g, ep, seed)
            np.testing.assert_array_equal(feed, jfeed)
            if feeder is None or ep:
                continue
            for t in range(len(g["ep0_actions"])):
                np.testing.assert_array_equal(feeder.step_feed(g, "ep0_", t),
                                              jfeeder.step_feed(g, "ep0_", t))
    if env_id in GOAL_IDS:
        geom = get_config(env_id).tiling
        rec = replay._DrawRecorder(seeding.np_random(3)[0])
        ht = replay.HostTiling(geom, rec)
        ht.reset()
        ht.find_new_goal()
        np.testing.assert_array_equal(replay._parse_goal_reset_draws(geom, rec.log),
                                      jreplay._parse_goal_reset_draws(geom, rec.log))
