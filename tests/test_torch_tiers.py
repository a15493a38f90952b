"""The port's kernel tiers below the full step, and the observation features,
against space_gym_tpu.

* the plain twin of the env-step kernel K2 (ops/env_step.py) against the
  Pallas kernel `fused_env_step_for_config` in interpret mode, f64, atol 1e-9,
  both tableaux, the four env families;
* `EnvEngine(fuse="env")` and `EnvEngine(fuse="physics")` on the CPU (plain
  twins + the batched tail) against the JAX engine with the same
  `pallas_fuse` in interpret mode, same uniforms, f64, atol 1e-9, on every
  lane, reset and resample lanes included;
* the three observation-feature functions against the JAX ones, f64, atol
  1e-12, and `obs_dim`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.envs import dnc_math as jdnc
from space_gym_tpu.envs import goal_math as jgoal
from space_gym_tpu.envs import kepler_math as jkepler
from space_gym_tpu.ops.pallas_step import fused_env_step_for_config

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.envs import dnc_math, goal_math, kepler_math
from space_gym_torch.ops.constants import G
from space_gym_torch.ops.env_step import EnvStep

from .test_torch_fixed import run_both
from .torch_scenarios import one_torch_thread, scenario_inputs  # noqa: F401 (autouse)

B = 8
FAMILIES = ["GoalContinuous2P-v0", "GoalContinuous4P-v0", "KeplerRandomOrbits-v0",
            "DoNotCrashContinuous-v0"]


# DP5 with one substep, and not on the four-planet env:
# the interpret-mode call of the unrolled DP5 x 2 / refine 12 body takes minutes.
@pytest.mark.parametrize("env_id,tableau,substeps,refine",
                         [(e, "bs3", 1, 8) for e in FAMILIES]
                         + [(e, "dp5", 1, 12) for e in FAMILIES if e != "GoalContinuous4P-v0"])
def test_plain_env_step_matches_pallas_kernel_f64(env_id, tableau, substeps, refine):
    cfg, ins = scenario_inputs(env_id, B, seed=13)
    y, a, p, g, r = ins[:5]
    jfused = fused_env_step_for_config(space_gym_tpu.get_config(env_id), substeps, refine, B,
                                       True, tableau=tableau)
    want = [np.asarray(v) for v in jfused(*[jnp.asarray(v) for v in (y, a, p, g, r)])]
    k2 = EnvStep(cfg, substeps, refine, tableau)
    launches = EnvStep.launches
    got = [v.numpy() for v in k2(*[torch.as_tensor(v) for v in (y, a, p, g, r)])]
    assert EnvStep.launches == launches, "CPU tensors take the plain twin"
    np.testing.assert_array_equal(got[1], want[1])
    for name, gv, wv in zip(("y", "terminated", "obs", "reward"), got, want):
        assert gv.shape == wv.shape, name
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-9, err_msg=name)
    assert want[1][4:6].all() and not want[1][0:2].any()
    if cfg.task == "goal":  # the sparse bonus on the lanes sitting on their goal
        assert (got[3][6:8] > cfg.goal.goal_sparse_reward - 2).all()


def test_env_step_wrapper_checks_operands():
    cfg, ins = scenario_inputs("KeplerRandomOrbits-v0", B, seed=1)
    k2 = EnvStep(cfg, 1, 8, "bs3")
    t = [torch.as_tensor(v).t().contiguous() for v in
         (ins[0], ins[1], ins[2].reshape(B, -1), ins[3], ins[4])]
    assert k2.bytes_per_lane() == 4 * (6 + 2 + 4 + 2 + 3 + 6 + 1 + cfg.obs_dim + 1)
    with pytest.raises(ValueError):
        k2.step_rows(t[0], t[1], t[2], t[3], t[4][:2])
    with pytest.raises(TypeError):
        k2.step_rows(t[0], t[1].float(), t[2], t[3], t[4])
    with pytest.raises(ValueError):
        EnvStep(cfg, 1, 8, "rk4")


@pytest.mark.parametrize("fuse", ["env", "physics"])
@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerRandomOrbits-v0",
                                    "DoNotCrashContinuous-v0"])
def test_fused_tier_engine_matches_jax_engine(env_id, fuse):
    """BS3 x 1 / refine 8 to keep the interpret-mode calls short; a reset of
    every lane at the second step, Goal lanes 0-1 resample at the first."""
    cfg = dataclasses.replace(get_config(env_id), max_episode_steps=2)
    jcfg = dataclasses.replace(space_gym_tpu.get_config(env_id), max_episode_steps=2)
    jeng = JaxEngine(jcfg, physics="pallas", pallas_fuse=fuse, dtype=jnp.float64, substeps=1,
                     refine_iters=8, pallas_tableau="bs3")
    eng = EnvEngine(cfg, fuse=fuse, dtype=torch.float64, device="cpu", substeps=1,
                    refine_iters=8, tableau="bs3")
    steps = run_both(jeng, eng, B, 3, seed=8, goal_lanes=2 if cfg.task == "goal" else 0)
    assert steps[1].done.all() and steps[1].truncated.any()


def test_fused_tier_without_auto_reset_matches_jax():
    env_id = "DoNotCrashContinuous-v0"
    jeng = JaxEngine(space_gym_tpu.get_config(env_id), physics="pallas", pallas_fuse="env",
                     dtype=jnp.float64, auto_reset=False, substeps=1, refine_iters=8,
                     pallas_tableau="bs3")
    eng = EnvEngine(get_config(env_id), fuse="env", dtype=torch.float64, device="cpu",
                    auto_reset=False, substeps=1, refine_iters=8, tableau="bs3")
    assert eng.n_step_rand == 0
    run_both(jeng, eng, B, 2, seed=9)


# ---------------------------------------------------------- obs features --
def _random_obs(env_id, n, seed):
    """Raw observations of a CPU rollout's reset, perturbed with numpy."""
    cfg = get_config(env_id)
    rng = np.random.default_rng(seed)
    eng = EnvEngine(cfg, physics="fixed", dtype=torch.float64, device="cpu")
    _, obs = eng.reset(n, u=torch.as_tensor(rng.random((n, eng.n_reset_rand))))
    return cfg, obs.numpy() + rng.normal(0, 0.05, obs.shape)


def test_goal_features_match_jax():
    cfg, obs = _random_obs("GoalContinuous3P-v0", 64, 1)
    want = jgoal.features_for_config(jnp, jnp.asarray(obs), space_gym_tpu.get_config(cfg.env_id))
    got = goal_math.features_for_config(torch.as_tensor(obs), cfg)
    assert got.shape == (64, goal_math.N_GOAL_FEATURES) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_dnc_features_match_jax():
    cfg, obs = _random_obs("DoNotCrashContinuous-v0", 64, 2)
    want = jdnc.features_for_config(jnp, jnp.asarray(obs), space_gym_tpu.get_config(cfg.env_id))
    got = dnc_math.features_for_config(torch.as_tensor(obs), cfg)
    assert got.shape == (64, dnc_math.N_DNC_FEATURES) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_kepler_error_features_and_reward_match_jax():
    cfg, obs = _random_obs("KeplerRandomOrbits-v0", 64, 3)
    alpha = G * cfg.kepler.planet_mass
    d = cfg.obs_dim
    args = (obs[:, 0:2], obs[:, 4:6], obs[:, d - 3], obs[:, d - 2], obs[:, d - 1])
    want = jkepler.error_features(jnp, jnp.asarray(alpha), *[jnp.asarray(a) for a in args])
    got = kepler_math.error_features(alpha, *[torch.as_tensor(a) for a in args])
    assert got.shape == (64, kepler_math.N_ERROR_FEATURES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # the reward the fixed tier pays, lane by lane against the per-lane JAX one
    import jax

    pen = np.random.default_rng(4).random(64)
    k = cfg.kepler
    consts = (k.numerator_C, k.rad_penalty_C, k.act_penalty_C)
    jr = jax.vmap(lambda p, v, ap, ra, a, e: jkepler.dense_reward(
        jnp, alpha, p, v, ap, ra, a, e, *consts))(*[jnp.asarray(a) for a in (
            args[0], args[1], pen, args[2], args[4], args[3])])
    tr = kepler_math.dense_reward(alpha, *[torch.as_tensor(a) for a in (
        args[0], args[1], pen, args[2], args[4], args[3])], *consts)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)


@pytest.mark.parametrize("env_id,features", [("GoalContinuous2P-v0", "goal"),
                                             ("KeplerRandomOrbits-v0", "kepler"),
                                             ("DoNotCrashContinuous-v0", "dnc")])
def test_obs_features_engine_matches_jax_engine(env_id, features):
    """One substep and 8 refinements on both sides: the features are under
    test here, the integration depth in tests/test_torch_fixed.py, and the
    JAX step traces in half the time."""
    jeng = JaxEngine(space_gym_tpu.get_config(env_id), physics="fixed", dtype=jnp.float64,
                     obs_features=features, substeps=1, refine_iters=8)
    eng = EnvEngine(get_config(env_id), physics="fixed", dtype=torch.float64, device="cpu",
                    obs_features=features, substeps=1, refine_iters=8)
    assert eng.obs_dim == jeng.obs_dim > eng.config.obs_dim
    steps = run_both(jeng, eng, B, 1, seed=10)
    assert steps[0].obs.shape == (B, eng.obs_dim) == steps[0].final_obs.shape
