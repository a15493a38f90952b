"""The port's native C++ host runtime (space_gym_torch/parity/native.py, its
own copy of sgt_native.cpp, built into build/native/) against the port's
scipy-exact host path and the JAX package's native solver, after
tests/test_native.py.

Every golden step of the five recorded envs (tests/goldens/) is bit-equal
to `physics="host"` (compat/host_rk45.py) and to
space_gym_tpu/parity/native.py::solve_step_native, with the same
termination flag; a whole Goal episode replays the golden through
`make(..., physics="native")` bit for bit; a crash ends on the planet's
surface; the adversarial states of tests/test_fuzz.py stay finite.  A
failed build raises and never falls back.  Skipped only where g++ is
missing, as tests/test_native.py is where its build fails.
"""
import os
import shutil

import numpy as np
import pytest

from space_gym_tpu.parity import native as jnative

from space_gym_torch import get_config, make
from space_gym_torch.compat.gym_api import _host_physics_step
from space_gym_torch.parity import native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build")

GOLDEN_IDS = [
    "GoalContinuous2P-v0",
    "GoalContinuous3P-v0",
    "GoalContinuous4P-v0",
    "KeplerCircleOrbit-v0",
    "KeplerEllipseEasy-v0",
]
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def iter_golden_steps(env_id):
    g = np.load(os.path.join(GOLDENS, f"{env_id}.npz"))
    env = make(env_id, physics="host")
    for ep in range(int(g["episodes"])):
        p = f"ep{ep}_"
        states = np.concatenate([g[p + "reset_state"][None], g[p + "post_states"]])
        actions = g[p + "actions"]
        planets = g[p + "reset_planets"]
        for t in range(len(actions)):
            a = np.array(env._translate_raw_action(actions[t].astype(np.float32)))
            yield states[t].copy(), a, planets


@pytest.mark.parametrize("env_id", GOLDEN_IDS)
def test_native_matches_host_and_jax_native_per_step(env_id):
    assert native.is_available(), native.build_error()
    assert native.has_blas(), "numpy's OpenBLAS was not found: the bits would be the fallback's"
    cfg = get_config(env_id)
    jcfg = __import__("space_gym_tpu").get_config(env_id)
    total = 0
    for y0, a, planets in iter_golden_steps(env_id):
        yh, dh = _host_physics_step(cfg, y0.copy(), a, planets)
        yn, dn = native.solve_step_native(cfg, y0, a, planets)
        yj, dj = jnative.solve_step_native(jcfg, y0, a, planets)
        assert dh == dn == dj
        assert np.array_equal(yn, yh), (total, yn - yh)
        assert np.array_equal(yn, yj), (total, yn - yj)
        total += 1
    assert total > 100


def test_native_full_episode_bitwise_goal2p():
    env_id = "GoalContinuous2P-v0"
    g = np.load(os.path.join(GOLDENS, f"{env_id}.npz"))
    env = make(env_id, physics="native")
    seed = int(g["seed"])
    for ep in range(int(g["episodes"])):
        p = f"ep{ep}_"
        np.random.seed(seed + 1000 * ep)
        env.seed(seed + ep)
        obs = env.reset()
        np.testing.assert_array_equal(obs, g[p + "reset_obs"])
        actions = g[p + "actions"]
        for t in range(len(actions)):
            obs, reward, done, info = env.step(actions[t])
            np.testing.assert_array_equal(obs, g[p + "obs"][t], err_msg=f"ep{ep} t{t}")
            assert reward == g[p + "rewards"][t]
            assert done == bool(g[p + "dones"][t])


def test_native_event_semantics():
    """Crash step returns the state at event time (planet surface)."""
    cfg = get_config("DoNotCrashContinuous-v0")
    y0 = np.array([0.3, 0.0, 0.0, -2.0, 0.0, 0.0])
    a = np.array([0.0, 0.0])
    planets = np.asarray(cfg.fixed_planet_pos, float)
    y, terminated = native.solve_step_native(cfg, y0, a, planets)
    assert terminated
    assert abs(np.linalg.norm(y[:2]) - cfg.dnc.planet_radius) < 1e-12


def test_native_solver_adversarial_states():
    """The grazing states of tests/test_fuzz.py (its generator, its key):
    finite, no error code, the JAX native solver's bits."""
    import jax

    from .test_fuzz import adversarial_states

    cfg = get_config("DoNotCrashContinuous-v0")
    jcfg = __import__("space_gym_tpu").get_config("DoNotCrashContinuous-v0")
    ys = np.asarray(adversarial_states(jcfg, 64, jax.random.key(5)))
    planets = np.asarray(cfg.fixed_planet_pos, float)
    rng = np.random.RandomState(0)
    n_term = 0
    for y0 in ys:
        a = rng.uniform(-1, 1, 2)
        a = np.array([(a[0] + 1) / 2, a[1]])
        y, term = native.solve_step_native(cfg, y0, a, planets)
        yj, tj = jnative.solve_step_native(jcfg, y0, a, planets)
        assert np.isfinite(y).all() and term == tj and np.array_equal(y, yj)
        n_term += term
    assert n_term > 0


def test_a_failed_build_raises(monkeypatch):
    """physics="native" without its library raises the build's error; no
    other mode stands in."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++: error: no such file")
    with pytest.raises(RuntimeError, match="no such file"):
        make("GoalContinuous2P-v0", physics="native")
    with pytest.raises(RuntimeError, match="native solver unavailable"):
        native.solve_step_native(get_config("GoalContinuous2P-v0"), np.zeros(6),
                                 np.zeros(2), np.zeros((2, 2)))
