"""The port's adaptive tier (`EnvEngine(physics="adaptive")`) against the
recorded reference trajectories and against the JAX engine's adaptive tier.

- Physics against the goldens: every recorded step of an id (its first 40
  steps per episode, as tests/test_engine.py::test_single_step_physics_vs_golden)
  in one batched call, from the recorded pre-step state, at atol 1e-10: all
  7 ids, both seed sets.
- The whole step against `space_gym_tpu`'s adaptive engine on the same
  uniforms (test_torch_fixed.py::run_both): flags equal, floats at its ATOL.
- A singular lane is poisoned with NaN, and the fixed and adaptive tiers
  agree on termination (tests/test_properties.py, tests/test_engine.py).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine

from .test_torch_fixed import run_both
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_IDS = ["GoalContinuous2P-v0", "GoalContinuous3P-v0", "GoalContinuous4P-v0",
              "KeplerCircleOrbit-v0", "KeplerEllipseEasy-v0", "KeplerEllipseHard-v0",
              "KeplerRandomOrbits-v0"]


def golden_steps(env_id, subset):
    """(pre-step states, raw actions, planets, post-step states) of the first
    40 steps of every recorded episode, stacked on the lane axis."""
    g = np.load(os.path.join(GOLDEN_DIR, subset, f"{env_id}.npz"))
    cols = [[], [], [], []]
    for ep in range(int(g["episodes"])):
        p = f"ep{ep}_"
        states = np.concatenate([g[p + "reset_state"][None], g[p + "post_states"]])
        n = min(len(g[p + "actions"]), 40)
        for c, v in zip(cols, (states[:n], g[p + "actions"][:n],
                               np.repeat(g[p + "reset_planets"][None], n, 0), states[1:n + 1])):
            c.append(v)
    return [np.concatenate(c) for c in cols]


@pytest.mark.parametrize("subset", ["", "seed7"])
@pytest.mark.parametrize("env_id", GOLDEN_IDS)
def test_adaptive_physics_vs_golden(env_id, subset):
    """The reference's float32 action arithmetic, as the JAX engine's golden
    test runs it (f32_actions=True)."""
    y0, actions, planets, want = golden_steps(env_id, subset)
    eng = EnvEngine(get_config(env_id), physics="adaptive", dtype=torch.float64,
                    f32_actions=True, device="cpu")
    a = eng._translate_action(torch.as_tensor(actions))
    y, terminated = eng._physics(torch.as_tensor(y0), a, torch.as_tensor(planets))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-10, err_msg=env_id)
    assert eng.solve_stats["n_steps"].shape == (len(y0),)


@functools.cache
def jax_adaptive_engine():
    """The one JAX adaptive engine of this module (its trace is the
    expensive part): GoalContinuous2P-v0, float64, episodes of 2 steps."""
    cfg = dataclasses.replace(space_gym_tpu.get_config("GoalContinuous2P-v0"),
                              max_episode_steps=2)
    return JaxEngine(cfg, physics="adaptive", dtype=jnp.float64)


def test_adaptive_engine_matches_jax_adaptive_engine():
    """B=8 for 3 steps from the JAX reset: every lane resets at the second
    step, lanes 0-1 start on their goal and resample it."""
    cfg = dataclasses.replace(get_config("GoalContinuous2P-v0"), max_episode_steps=2)
    eng = EnvEngine(cfg, physics="adaptive", dtype=torch.float64, device="cpu")
    assert eng.tier == "adaptive" and eng.full is None
    steps = run_both(jax_adaptive_engine(), eng, 8, 3, seed=9, goal_lanes=2)
    assert steps[1].truncated.all() and not steps[0].truncated.any()
    assert (steps[0].reward[:2] > cfg.goal.goal_sparse_reward - 2).all()


def test_adaptive_engine_without_auto_reset():
    cfg = dataclasses.replace(get_config("KeplerCircleOrbit-v0"), max_episode_steps=2)
    eng = EnvEngine(cfg, physics="adaptive", dtype=torch.float64, device="cpu",
                    auto_reset=False)
    g = eng.generator(0)
    state, obs = eng.init(8, g)
    for _ in range(3):
        state, ts = eng.step(state, torch.zeros(8, 2, dtype=torch.float64), g)
    assert ts.done.all() and (ts.obs == ts.final_obs).all()
    assert (state.steps == 3).all()


def test_adaptive_solver_poisons_a_singular_lane():
    """tests/test_properties.py::test_adaptive_solver_fails_loud_on_singular_lane:
    a ship at a planet's centre (a non-finite right-hand side) comes back as
    NaN; the other lanes of the batch stay finite, and the step ends."""
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), physics="adaptive", device="cpu")
    g = eng.generator(0)
    state, _ = eng.init(4, g)
    y = state.y.clone()
    y[0, :2] = state.planets_pos[0, 0]
    state2, ts = eng.step(state._replace(y=y), torch.zeros(4, 2), g)
    final = ts.final_obs
    assert not torch.isfinite(final[0, :7]).any()  # poisoned, loud
    assert torch.isfinite(state2.y[1:]).all() and torch.isfinite(final[1:]).all()


def test_fixed_vs_adaptive_termination_agreement():
    """tests/test_engine.py::test_fixed_vs_adaptive_termination_agreement:
    random actions for 20 control steps on 32 lanes; dead lanes restart from
    the reset.  The two integrators agree on termination but for at most one
    borderline event, and live states to 1e-5."""
    cfg = get_config("GoalContinuous2P-v0")
    fast = EnvEngine(cfg, physics="fixed", dtype=torch.float64, device="cpu")
    slow = EnvEngine(cfg, physics="adaptive", dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    state, _ = fast.reset(32, u=torch.as_tensor(rng.random((32, fast.n_reset_rand))))
    ys = state.y
    mismatches = 0
    for _ in range(20):
        acts = fast._translate_action(torch.as_tensor(rng.uniform(-1, 1, (32, 2))))
        yf, tf = fast._physics(ys, acts, state.planets_pos)
        ya, ta = slow._physics(ys, acts, state.planets_pos)
        mismatches += int((tf != ta).sum())
        both_alive = ~tf & ~ta
        np.testing.assert_allclose(yf[both_alive].numpy(), ya[both_alive].numpy(), rtol=0,
                                   atol=1e-5)
        ys = torch.where((tf | ta)[:, None], state.y, yf)
    assert mismatches <= 1
