"""The port's engine (space_gym_torch/engine) against space_gym_tpu's.

* batched reset with injected uniforms vs the JAX per-lane reset under vmap,
  f64, atol 1e-10;
* step (plain full-step twin on the CPU), teacher-forced from the JAX
  fixed-path trajectory, on live lanes that did not reach their goal, at the
  tolerances of tests/test_pallas_full.py;
* a CPU rollout, the state converters, device selection, and the rule that
  the port imports neither jax nor space_gym_tpu.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import space_gym_tpu
from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine, state_from_numpy, state_to_numpy
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _jax_engine(env_id, dtype, physics="fixed"):
    """Built once per module for each configuration: it holds no state.  The
    f64 engines serve the reset tests, which never step them: one substep and
    8 refinements make their constructors' trace of the step shorter."""
    import jax.numpy as jnp
    from space_gym_tpu.engine import EnvEngine as JaxEngine

    depth = dict(substeps=1, refine_iters=8) if dtype == "f64" else {}
    return JaxEngine(space_gym_tpu.get_config(env_id), physics=physics,
                     dtype={"f64": jnp.float64, "f32": jnp.float32}[dtype], **depth)


def _flat(state):
    """EnvState (numpy leaves) -> dict of arrays."""
    out = {k: getattr(state, k) for k in ("y", "planets_pos", "goal_pos", "ref_orbit", "steps")}
    if state.tiling is not None:
        for k in state.tiling._fields:
            out[f"tiling.{k}"] = getattr(state.tiling, k)
    return out


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalContinuous4P-v0",
                                    "KeplerRandomOrbits-v0", "DoNotCrashContinuous-v0"])
def test_reset_matches_jax_lane_reset(env_id):
    import jax
    import jax.numpy as jnp
    from space_gym_tpu.utils.randvec import RandSource as JaxRandSource

    jeng = _jax_engine(env_id, "f64")
    eng = EnvEngine(get_config(env_id), dtype=torch.float64, device="cpu")
    assert eng.n_reset_rand == jeng.n_reset_rand
    B = 64
    u = np.random.default_rng(0).random((B, eng.n_reset_rand))

    def lane(ul):
        st = jeng._reset_lane(JaxRandSource(ul))
        return st, jeng._observe(st)

    jstate, jobs = jax.jit(jax.vmap(lane))(jnp.asarray(u))
    state, obs = eng.reset(B, u=torch.as_tensor(u))
    want = _flat(jax.tree.map(np.asarray, jstate))
    got = _flat(state_to_numpy(state))
    assert got.keys() == want.keys()
    for k in want:
        if want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10, err_msg=k)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-10)


def test_step_matches_jax_fixed_path_on_live_lanes():
    import jax

    env_id = "GoalContinuous2P-v0"
    cfg = get_config(env_id)
    jeng = _jax_engine(env_id, "f32")
    eng = EnvEngine(cfg, dtype=torch.float32, device="cpu")  # dp5 x 2, refine 12
    B = 64
    state, _ = jeng.init(jax.random.key(3), B)
    rng = np.random.default_rng(4)
    checked = 0
    for t in range(3):
        act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        sx, tx = jeng.step(state, jax.numpy.asarray(act), jax.random.key(10 + t))
        sp = state_from_numpy(jax.tree.map(np.asarray, state))
        u = torch.as_tensor(rng.random((B, eng.n_step_rand), dtype=np.float32))
        st, tp = eng.step(sp, torch.as_tensor(act), u=u)
        done_x = np.asarray(tx.done)
        np.testing.assert_array_equal(tp.done.numpy(), done_x, err_msg=f"t={t}")
        reached = np.linalg.norm(np.asarray(state.goal_pos) - np.asarray(sx.y[:, :2]),
                                 axis=-1) < cfg.goal_radius
        m = ~done_x & ~reached
        np.testing.assert_allclose(st.y.numpy()[m], np.asarray(sx.y)[m], rtol=0, atol=2e-5)
        np.testing.assert_allclose(tp.final_obs.numpy()[m], np.asarray(tx.final_obs)[m],
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(tp.reward.numpy()[m], np.asarray(tx.reward)[m],
                                   rtol=1e-3, atol=1e-4)
        checked += int(m.sum())
        state = sx
    assert checked >= B


def test_cpu_rollout_stays_finite_and_auto_resets():
    cfg = get_config("GoalContinuous2P-v0")
    eng = EnvEngine(cfg, tableau="bs3", substeps=1, refine_iters=8, device="cpu")
    g = eng.generator(0)
    state, obs = eng.init(64, g)
    state, obs, traj = eng.rollout(state, obs, eng.random_policy(), 50, g)
    assert traj.obs.shape == (50, 64, cfg.obs_dim)
    assert traj.reward.shape == (50, 64)
    assert torch.isfinite(state.y).all() and torch.isfinite(traj.obs).all()
    assert traj.done.any()
    assert (traj.done == (traj.terminated | traj.truncated)).all()
    # a lane that is done starts its next episode at step 0
    assert (state.steps[traj.done[-1]] == 0).all()
    assert (state.steps < cfg.max_episode_steps).all()


def test_discrete_actions_translate_through_the_table():
    cfg = get_config("GoalDiscrete2-v0")
    eng = EnvEngine(cfg, device="cpu")
    a = eng._translate_action(torch.arange(6, dtype=torch.int32))
    from space_gym_torch.envs.config import DISCRETE_ACTIONS

    assert a.tolist() == [list(r) for r in DISCRETE_ACTIONS]
    g = eng.generator(1)
    state, obs = eng.init(16, g)
    state, ts = eng.step(state, eng.random_policy()(g, obs), g)
    assert torch.isfinite(ts.obs).all()


def test_state_round_trip_through_numpy():
    import jax

    # 64 lanes, as test_step_matches_jax_fixed_path_on_live_lanes: the same
    # engine steps them without tracing its step again
    jeng = _jax_engine("GoalContinuous2P-v0", "f32")
    jstate, _ = jeng.init(jax.random.key(0), 64)
    want = jax.tree.map(np.asarray, jstate)
    got = state_to_numpy(state_from_numpy(want))
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], v, err_msg=k)
    # and back into the JAX engine, which steps it
    from space_gym_tpu.engine import EnvState as JaxState
    from space_gym_tpu.tiling.device import TilingState as JaxTiling

    back = JaxState(*[JaxTiling(*f) if isinstance(f, tuple) else f for f in got])
    jeng.step(back, jax.numpy.zeros((64, 2), np.float32), jax.random.key(1))


def test_entry_point_defaults_to_the_card():
    cfg = get_config("DoNotCrashContinuous-v0")
    if torch.cuda.is_available():
        assert EnvEngine(cfg).device.type == "cuda"
        with pytest.raises(TypeError):
            EnvEngine(cfg, dtype=torch.float64)  # the kernels take float32
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EnvEngine(cfg)
    adaptive = EnvEngine(cfg, physics="adaptive", device="cpu")  # plain PyTorch, no kernel
    assert adaptive.tier == "adaptive" and adaptive.device.type == "cpu"
    assert adaptive.full is adaptive.env_step is adaptive.physics_step is None
    assert EnvEngine(cfg, physics="fixed", device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import space_gym_torch\n"
        "for m in pkgutil.walk_packages(space_gym_torch.__path__, 'space_gym_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'space_gym_tpu'))\n"
        "print(len(list(pkgutil.walk_packages(space_gym_torch.__path__))), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

