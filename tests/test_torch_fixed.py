"""The port's fixed-substep tier (`EnvEngine(physics="fixed")`) against
space_gym_tpu's, module by module and as a whole.

Every input is made with numpy from a seed and fed to both sides in float64.
Floats agree to atol 1e-9 (rounding of a few hundred f64 operations through
one control step; libm's sin/cos/log may differ by an ulp between the two
frameworks), flags and integer state exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.ops import events as jevents
from space_gym_tpu.ops import field as jfield
from space_gym_tpu.ops import fixed_rk as jfixed
from space_gym_tpu.ops import rk45 as jrk

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine, state_from_numpy, state_to_numpy
from space_gym_torch.ops import events, field, fixed_rk, rk45

from .torch_scenarios import one_torch_thread, scenario_inputs  # noqa: F401 (autouse)

ATOL = 1e-9
B = 8
FAMILIES = ["GoalContinuous2P-v0", "GoalDiscrete4-v0", "KeplerRandomOrbits-v0",
            "DoNotCrashContinuous-v0"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _scenario(env_id, seed=21):
    """y, translated action, planets of the scenario lanes, plus two spinning
    lanes (0 and 1) close to the angular-velocity cap with full thruster: they
    cross it under acceleration steering (DoNotCrash); velocity steering
    (Goal, Kepler) overrides their spin with 5 * thruster, under the cap."""
    cfg, ins = scenario_inputs(env_id, B, seed)
    y, a, p = (np.array(v) for v in ins[:3])
    y[0:2, 5] = cfg.max_abs_vel_angle - 1e-3
    a[0:2, 1] = 1.0
    return cfg, space_gym_tpu.get_config(env_id), y, a, p


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "DoNotCrashContinuous-v0"])
@pytest.mark.parametrize("f32_action", [False, True])
def test_ship_vector_field_matches_jax(env_id, f32_action):
    cfg, jc, y, a, p = _scenario(env_id)
    want = jax.vmap(lambda pp, aa, yy: jfield.ship_vector_field(
        jc.ship, jc.planet_masses, pp, aa, yy, f32_action=f32_action))(
            jnp.asarray(p), jnp.asarray(a), jnp.asarray(y))
    got = field.ship_vector_field(cfg.ship, cfg.planet_masses, _t(p), _t(a), _t(y),
                                  f32_action=f32_action)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    wy = jfield.wrap_ship_angle(jfield.apply_steering_override(
        jc.ship, jnp.asarray(y) * 3.0, jnp.asarray(a), f32_action=f32_action))
    gy = field.wrap_ship_angle(field.apply_steering_override(
        cfg.ship, _t(y) * 3.0, _t(a), f32_action=f32_action))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0, atol=ATOL)


def test_steering_override_in_velocity_mode():
    ship = get_config("DoNotCrashContinuous-v0").ship._replace(steering=field.STEERING_VELOCITY)
    _, _, y, a, _ = _scenario("GoalContinuous2P-v0")
    for f32a in (False, True):
        want = jfield.apply_steering_override(jfield.ShipParams(*ship), jnp.asarray(y),
                                              jnp.asarray(a), f32_action=f32a)
        got = field.apply_steering_override(ship, _t(y), _t(a), f32_action=f32a)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 5].numpy() != y[:, 5]).any()


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "DoNotCrashContinuous-v0"])
def test_event_functions_match_jax(env_id):
    cfg, jc, y, _, p = _scenario(env_id)
    args = (cfg.planet_radii, cfg.world_size, cfg.max_abs_vel_angle)
    want = np.asarray(jax.vmap(jevents.make_event_fn(*args))(jnp.asarray(p), jnp.asarray(y)))
    got = events.make_event_fn(*args)(_t(p), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    comps = events.make_event_component_fns(*args)
    jcomps = jevents.make_event_component_fns(*args)
    assert len(comps) == len(jcomps) == cfg.n_planets + 3
    for e, (f, jf) in enumerate(zip(comps, jcomps)):
        np.testing.assert_allclose(f(_t(p), _t(y)).numpy(),
                                   np.asarray(jax.vmap(jf)(jnp.asarray(p), jnp.asarray(y))),
                                   rtol=0, atol=1e-12, err_msg=str(e))
        np.testing.assert_allclose(f(_t(p), _t(y)).numpy(), got[:, e], rtol=0, atol=1e-12)
    g_old = np.array([[-1.0, 0.0, 1.0, 2.0, 0.0]])
    g_new = np.array([[1.0, 0.0, -1.0, 3.0, -0.5]])
    np.testing.assert_array_equal(events.crossings(_t(g_old), _t(g_new)).numpy(),
                                  np.asarray(jevents.crossings(g_old, g_new)))


def _rhs_pair(cfg, jc, a, p):
    def rhs(_t_, y):
        return field.ship_vector_field(cfg.ship, cfg.planet_masses, _t(p), _t(a), y)

    def jrhs(pp, aa):
        return lambda _t_, y: jfield.ship_vector_field(jc.ship, jc.planet_masses, pp, aa, y)

    return rhs, jrhs


def test_rk_step_and_dense_output_match_jax():
    cfg, jc, y, a, p = _scenario("GoalContinuous2P-v0")
    rhs, jrhs = _rhs_pair(cfg, jc, a, p)
    h = 0.035
    tq = np.linspace(0.0, h, B)

    def lane(pp, aa, yy, t):
        r = jrhs(pp, aa)
        y_new, f_new, K = jrk.rk_step(r, 0.0, yy, r(0.0, yy), h)
        Q = jrk.dense_q(K)
        return y_new, f_new, Q, jrk.dense_eval(0.0, h, yy, Q, t)

    want = jax.vmap(lane)(jnp.asarray(p), jnp.asarray(a), jnp.asarray(y), jnp.asarray(tq))
    yt = _t(y)
    zero, ht = torch.zeros((), dtype=torch.float64), torch.tensor(h, dtype=torch.float64)
    y_new, f_new, K = rk45.rk_step(rhs, zero, yt, rhs(zero, yt), ht)
    Q = rk45.dense_q(K)
    got = (y_new, f_new, Q, rk45.dense_eval(zero, ht, yt, Q, _t(tq)))
    for name, g, w in zip(("y_new", "f_new", "Q", "dense"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("env_id,substeps,refine", [
    ("GoalContinuous2P-v0", 2, 12), ("DoNotCrashContinuous-v0", 1, 8),
    ("KeplerRandomOrbits-v0", 2, 12)])
def test_fixed_solve_step_matches_jax(env_id, substeps, refine):
    """Crash (lanes 4-5), out-of-world or goal (6-7), spin cap (0-1), live and
    truncating lanes: state, t, terminated and event_index."""
    cfg, jc, y, a, p = _scenario(env_id)
    rhs, jrhs = _rhs_pair(cfg, jc, a, p)
    args = (cfg.planet_radii, cfg.world_size, cfg.max_abs_vel_angle)
    jcomps = jevents.make_event_component_fns(*args)
    comps = events.make_event_component_fns(*args)

    def lane(pp, aa, yy):
        ev = tuple((lambda s, f=f: f(pp, s)) for f in jcomps)
        return jfixed.fixed_solve_step(jrhs(pp, aa), ev, yy, jc.step_size, substeps, refine)

    want = jax.vmap(lane)(jnp.asarray(p), jnp.asarray(a), jnp.asarray(y))
    ev = tuple((lambda s, f=f: f(_t(p), s)) for f in comps)
    got = fixed_rk.fixed_solve_step(rhs, ev, _t(y), cfg.step_size, substeps, refine)
    np.testing.assert_array_equal(got.terminated.numpy(), np.asarray(want.terminated))
    np.testing.assert_array_equal(got.event_index.numpy(), np.asarray(want.event_index))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=ATOL)
    term = got.terminated.numpy()
    assert term[4:6].all(), "crash lanes terminate"
    assert (got.event_index.numpy()[4:6] == 0).all()
    if cfg.ship.steering == field.STEERING_ACCELERATION:
        assert term[0:2].all(), "spinning lanes terminate"
        assert (got.event_index.numpy()[0:2] == cfg.n_planets + 2).all()
    if cfg.task != "goal":
        assert term[6:8].all(), "lanes leaving the world terminate"
    assert (got.t.numpy()[term] < cfg.step_size).all()


# ------------------------------------------------------------- the engine --
def _flat(state):
    out = {k: getattr(state, k) for k in ("y", "planets_pos", "goal_pos", "ref_orbit", "steps")}
    if state.tiling is not None:
        for k in state.tiling._fields:
            out[f"tiling.{k}"] = getattr(state.tiling, k)
    return out


def _assert_state_equal(got, want, msg):
    got, want = _flat(state_to_numpy(got)), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        if want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=f"{msg} {k}")


def _assert_timestep_equal(tp, tx, msg):
    for k in ("terminated", "truncated", "done"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(tx, k)),
                                      err_msg=f"{msg} {k}")
    for k in ("obs", "final_obs", "reward"):
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(tx, k)), rtol=0,
                                   atol=ATOL, err_msg=f"{msg} {k}")


def run_both(jeng, eng, batch, n_steps, seed, goal_lanes=0):
    """Step both engines from the JAX reset, each on its own state, with the
    uniforms the JAX engine draws from its key injected into the port's;
    `goal_lanes` lanes start on their goal.  Asserts equality after every
    step on every lane; returns the port's TimeSteps."""
    cfg = eng.config
    assert eng.n_reset_rand == jeng.n_reset_rand
    assert eng.n_step_rand == jeng.n_step_rand
    jdt = jeng.dtype
    rng = np.random.default_rng(seed)
    jstate, jobs = jeng.init(jax.random.key(seed), batch)
    u0 = jax.random.uniform(jax.random.key(seed), (batch, jeng.n_reset_rand), dtype=jdt)
    state, obs = eng.reset(batch, u=_t(u0))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=ATOL)
    if goal_lanes:
        y = np.array(jstate.y)
        y[:goal_lanes, 0:2] = np.asarray(jstate.goal_pos)[:goal_lanes]
        y[:goal_lanes, 3:6] = 0.0
        jstate = jstate._replace(y=jnp.asarray(y))
        state = state._replace(y=_t(y))
    _assert_state_equal(state, jstate, "reset")
    out = []
    for t in range(n_steps):
        if cfg.continuous:
            act = rng.uniform(-1, 1, (batch, 2)).astype(np.asarray(jstate.y).dtype)
        else:
            act = rng.integers(0, cfg.n_actions, batch).astype(np.int32)
        key = jax.random.key(1000 * seed + t)
        jstate, tx = jeng.step(jstate, jnp.asarray(act), key)
        u = jax.random.uniform(key, (batch, jeng.n_step_rand), dtype=jdt)
        state, tp = eng.step(state, _t(act), u=_t(u))
        _assert_timestep_equal(tp, tx, f"t={t}")
        _assert_state_equal(state, jstate, f"t={t}")
        out.append(tp)
    return out


@pytest.mark.parametrize("env_id", FAMILIES)
def test_fixed_engine_matches_jax_fixed_engine(env_id):
    """max_episode_steps=2 forces a reset of every lane at every second step;
    Goal lanes 0-3 start on their goal, so they resample.  The engine's
    default depth (DP5 x 2, refine 12) on GoalContinuous2P-v0; one substep
    and 8 refinements on the other families (the solver's depths are held to
    JAX in test_fixed_solve_step_matches_jax): their JAX step traces in half
    the time."""
    cfg = dataclasses.replace(get_config(env_id), max_episode_steps=2)
    jcfg = dataclasses.replace(space_gym_tpu.get_config(env_id), max_episode_steps=2)
    depth = {} if env_id == "GoalContinuous2P-v0" else dict(substeps=1, refine_iters=8)
    jeng = JaxEngine(jcfg, physics="fixed", dtype=jnp.float64, **depth)
    eng = EnvEngine(cfg, physics="fixed", dtype=torch.float64, device="cpu", **depth)
    steps = run_both(jeng, eng, 16, 4, seed=5, goal_lanes=4 if cfg.task == "goal" else 0)
    assert steps[1].truncated.all() and steps[3].done.all()
    assert not steps[0].truncated.any()
    if cfg.task == "goal":
        # the sparse bonus, less at most a safety penalty near a planet
        assert (steps[0].reward[:4] > cfg.goal.goal_sparse_reward - 2).all()


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerRandomOrbits-v0"])
def test_fixed_engine_without_auto_reset_matches_jax(env_id):
    """One substep and 8 refinements: the engine without its reset tail is
    under test (the default depth in the test above), and the JAX step
    traces in half the time."""
    cfg = dataclasses.replace(get_config(env_id), max_episode_steps=2)
    jcfg = dataclasses.replace(space_gym_tpu.get_config(env_id), max_episode_steps=2)
    depth = dict(substeps=1, refine_iters=8)
    jeng = JaxEngine(jcfg, physics="fixed", dtype=jnp.float64, auto_reset=False, **depth)
    eng = EnvEngine(cfg, physics="fixed", dtype=torch.float64, device="cpu", auto_reset=False,
                    **depth)
    assert eng.n_step_rand < EnvEngine(cfg, physics="fixed", device="cpu").n_step_rand
    steps = run_both(jeng, eng, 8, 3, seed=6)
    assert steps[1].truncated.all()
    assert (steps[2].obs == steps[2].final_obs).all()


def test_fixed_engine_f32_actions_and_default_dtype():
    """A float32 engine with the reference's float32 action arithmetic: one
    step from the same state, f32 tolerances; one substep and 8 refinements,
    as the action arithmetic is under test."""
    env_id = "GoalContinuous2P-v0"
    depth = dict(substeps=1, refine_iters=8)
    for f32a in (True,):
        jeng = JaxEngine(space_gym_tpu.get_config(env_id), physics="fixed", f32_actions=f32a,
                         **depth)
        eng = EnvEngine(get_config(env_id), physics="fixed", device="cpu", f32_actions=f32a,
                        **depth)
        jstate, _ = jeng.init(jax.random.key(2), 32)
        act = np.random.default_rng(2).uniform(-1, 1, (32, 2)).astype(np.float32)
        key = jax.random.key(3)
        js, tx = jeng.step(jstate, jnp.asarray(act), key)
        u = jax.random.uniform(key, (32, jeng.n_step_rand), dtype=jnp.float32)
        st, tp = eng.step(state_from_numpy(jax.tree.map(np.asarray, jstate)), _t(act), u=_t(u))
        np.testing.assert_array_equal(tp.done.numpy(), np.asarray(tx.done))
        np.testing.assert_allclose(st.y.numpy(), np.asarray(js.y), rtol=0, atol=5e-6)
        np.testing.assert_allclose(tp.final_obs.numpy(), np.asarray(tx.final_obs), rtol=0,
                                   atol=5e-6)


def test_engine_options_are_validated():
    cfg = get_config("GoalContinuous2P-v0")
    eng = EnvEngine(cfg, physics="adaptive", device="cpu", auto_reset=False)
    assert eng.tier == "adaptive" and eng.n_step_rand < EnvEngine(
        cfg, physics="adaptive", device="cpu").n_step_rand
    for bad in (dict(physics="pallas"), dict(fuse="all"), dict(in_kernel_rng="hw"),
                dict(physics="fixed", tableau="bs3"), dict(physics="fixed", in_kernel_rng=True),
                dict(fuse="env", in_kernel_rng="philox"), dict(auto_reset=False),
                dict(obs_features="kepler"), dict(obs_features="all"),
                dict(physics="adaptive", tableau="bs3"),
                dict(physics="adaptive", in_kernel_rng="philox")):
        with pytest.raises(ValueError):
            EnvEngine(cfg, device="cpu", **bad)
    eng = EnvEngine(cfg, device="cpu", in_kernel_rng=True)
    assert eng.in_kernel_rng == "threefry"
    state, _ = eng.init(4, eng.generator(0))
    with pytest.raises(ValueError):
        eng.step(state, torch.zeros(4, 2), u=torch.zeros(4, eng.n_step_rand))
    with pytest.raises(ValueError):
        EnvEngine(cfg, device="cpu").step(state, torch.zeros(4, 2), key=[1, 2])
