"""Physics property tests of the port, after tests/test_properties.py:
conservation laws on thrust-free Kepler coasts and termination-boundary
invariants, on the port's "fixed" and "adaptive" tiers and on the plain twin
of the full-step kernel K3 (ops/full_step_plain.py, through
FullStep.apply on CPU tensors), in float64, at the JAX tests' tolerances.

The three Kepler invariants of envs/kepler_math.py (specific energy,
angular momentum, the Laplace-Runge-Lenz vector) equal the JAX package's
(space_gym_tpu/envs/kepler_math.py on numpy) within 1e-15 on the coast's
states.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from space_gym_tpu.envs import kepler_math as jkepler

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.envs import kepler_math
from space_gym_torch.ops.constants import G
from space_gym_torch.ops.full_step import FullStep
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64


def k3_physics(eng):
    """One control interval of K3's plain twin on (B, 6) states and the
    translated action, as the other tiers' `_physics` take it: (final y,
    terminated, final observation).  K3 of the config with
    `continuous=False` passes the action as it is.  Done lanes reset in K3,
    so the final observation (pre-reset) is what shows where a terminated
    lane ended."""
    cfg, k3 = eng.config, eng.full
    full = FullStep(dataclasses.replace(cfg, continuous=False), k3.n_substeps, k3.refine_iters,
                    k3.tableau)
    k = cfg.kepler
    ref_row = [k.ref_orbit_angle, k.ref_orbit_eccentricity, k.ref_orbit_a] if k else [0.0] * 3

    def step(y, action, planets):
        B = y.shape[0]
        z = lambda n: torch.zeros((B, n), dtype=F64)  # noqa: E731
        ref = torch.tensor(ref_row, dtype=F64).expand(B, 3).contiguous()
        ti = torch.zeros((B, full.n_int_rows), dtype=torch.int32)
        outs = full.apply(y, action, planets, z(2), ref, z(full.cs_rows), ti,
                          z(full.n_uniform_rows))
        return outs[0].t(), outs[9][0].bool(), outs[6].t()

    return step


def physics(tier, cfg, substeps=2, refine_iters=12):
    """(y, action, planets) -> (y, terminated) of one tier, float64, CPU."""
    kw = dict(dtype=F64, substeps=substeps, refine_iters=refine_iters, device="cpu")
    if tier == "k3":
        eng = EnvEngine(cfg, physics="kernel", **kw)
        step = k3_physics(eng)
        return eng, lambda y, a, p: step(y, a, p)[:2]
    eng = EnvEngine(cfg, physics=tier, **kw)
    return eng, eng._physics


def coast_trajectory(tier, substeps, n_steps=200):
    """Zero-thrust Kepler coast on a circular orbit at r=1.2 (one lane): the
    first n_steps + 1 states of one 400-step run."""
    states, alpha_gm = _coast(tier, substeps)
    return states[:n_steps + 1], alpha_gm


@functools.cache
def _coast(tier, substeps, n_steps=400, refine_iters=0):
    """No event fires on the coast, so the event refinement, which moves only
    lanes whose events fired, changes no bit of it (test_coast_skips_nothing)
    and is left out here: it is most of a fixed step's cost on the CPU."""
    cfg = get_config("KeplerCircleOrbit-v0")
    eng, phys = physics(tier, cfg, substeps, refine_iters)
    alpha_gm = G * cfg.kepler.planet_mass
    r0 = 1.2
    y = torch.tensor([[r0, 0.0, 0.0, 0.0, math.sqrt(alpha_gm / r0), 0.0]], dtype=F64)
    a = eng._translate_action(torch.tensor([[-1.0, 0.0]], dtype=F64))
    assert float(a[0, 0]) == 0.0  # engine = (a0 + 1) / 2 = 0
    planets = torch.tensor(cfg.fixed_planet_pos, dtype=F64)[None]
    states = [y[0]]
    for _ in range(n_steps):
        y, term = phys(y, a, planets)
        assert not bool(term[0])
        states.append(y[0])
    return torch.stack(states).numpy(), alpha_gm


@pytest.mark.parametrize("tier", ["fixed", "k3"])
def test_coast_skips_nothing(tier):
    """The coast's first steps with the event refinement (12 iterations)
    equal those without, bit for bit."""
    with_refine = _coast.__wrapped__(tier, 2, n_steps=3, refine_iters=12)[0]
    assert np.array_equal(with_refine, _coast(tier, 2)[0][:4])


@pytest.mark.parametrize("tier,substeps,tol_e,tol_l", [
    ("fixed", 2, 1e-8, 1e-10),
    ("fixed", 1, 1e-7, 1e-9),
    ("k3", 2, 1e-8, 1e-10),
    ("k3", 1, 1e-7, 1e-9),
    ("adaptive", 2, 1e-4, 1e-6),  # the reference's tolerance controller (rtol=1e-3)
])
def test_coast_conserves_energy_and_momentum(tier, substeps, tol_e, tol_l):
    states, alpha_gm = coast_trajectory(tier, substeps)
    pos, vel = torch.as_tensor(states[:, 0:2]), torch.as_tensor(states[:, 3:5])
    E = kepler_math.specific_energy(alpha_gm, pos, vel).numpy()
    L = kepler_math.angular_momentum(pos, vel).numpy()
    assert np.max(np.abs(E - E[0])) / abs(E[0]) < tol_e
    assert np.max(np.abs(L - L[0])) / abs(L[0]) < tol_l


@pytest.mark.parametrize("tier", ["fixed", "k3"])
def test_lrl_vector_conserved_on_ellipse(tier):
    states, alpha_gm = coast_trajectory(tier, 2)
    A = kepler_math.lrl_vector(alpha_gm, torch.as_tensor(states[:, 0:2]),
                               torch.as_tensor(states[:, 3:5])).numpy()
    drift = np.linalg.norm(A - A[0], axis=-1).max()
    assert drift < 1e-8 * alpha_gm


def test_kepler_invariants_equal_jax():
    states, alpha_gm = coast_trajectory("adaptive", 2)
    # a spread of orbits beside the coast: eccentric, retrograde, far out
    rng = np.random.default_rng(0)
    extra = np.concatenate([rng.uniform(-3, 3, (64, 2)), rng.normal(0, 1.5, (64, 2))], 1)
    pos = np.concatenate([states[:, 0:2], extra[:, 0:2]])
    vel = np.concatenate([states[:, 3:5], extra[:, 2:4]])
    tp, tv = torch.as_tensor(pos), torch.as_tensor(vel)
    pairs = [
        (kepler_math.specific_energy(alpha_gm, tp, tv), jkepler.specific_energy(
            np, alpha_gm, pos, vel)),
        (kepler_math.angular_momentum(tp, tv), jkepler.angular_momentum(np, pos, vel)),
        (kepler_math.lrl_vector(alpha_gm, tp, tv), jkepler.lrl_vector(np, alpha_gm, pos, vel)),
    ]
    for got, want in pairs:
        assert got.dtype == F64
        scale = np.maximum(np.abs(want), 1.0)
        assert np.max(np.abs(got.numpy() - want) / scale) <= 1e-15


@pytest.mark.parametrize("tier", ["fixed", "k3"])
def test_fixed_integrator_is_higher_accuracy_than_reference_setting(tier):
    """One orbital period: the fixed 2-substep DP5 (the tier, or K3's twin)
    beats the reference's adaptive rtol=1e-3 configuration on one orbit."""
    sf, _ = coast_trajectory(tier, 2, n_steps=400)
    sa, _ = coast_trajectory("adaptive", 2, n_steps=400)
    r_f = np.hypot(sf[:, 0], sf[:, 1])
    r_a = np.hypot(sa[:, 0], sa[:, 1])
    assert np.abs(r_f - 1.2).max() < np.abs(r_a - 1.2).max()
    assert np.abs(r_f - 1.2).max() < 1e-6


@pytest.mark.parametrize("tier", ["fixed", "kernel"])
def test_termination_states_respect_boundaries(tier):
    """The auto-resetting engine (tier "fixed", or "kernel": K3's plain
    twin) never leaves a live lane outside the world, and a terminated lane
    ends at a boundary, never deep inside the planet; at one substep and 8
    refinements, the cheapest configuration of the test suite.  The spin
    check reads the observation's omega (column 6; tests/test_properties.py
    reads column 5, vy)."""
    cfg = get_config("DoNotCrashContinuous-v0")
    eng = EnvEngine(cfg, physics=tier, dtype=F64, substeps=1, refine_iters=8, device="cpu")
    state, obs = eng.init(256, eng.generator(0))
    traj = eng.rollout(state, obs, eng.random_policy(), 300, eng.generator(1))[2]
    xy = traj.obs[..., 0:2].reshape(-1, 2).numpy()
    r = np.hypot(xy[:, 0], xy[:, 1])
    tol = 2e-4
    assert r.max() <= cfg.dnc.border_radius + tol
    term = traj.terminated.reshape(-1).numpy()
    assert term.sum() > 0
    fxy = traj.final_obs[..., 0:2].reshape(-1, 2).numpy()[term]
    fr = np.hypot(fxy[:, 0], fxy[:, 1])
    fw = np.abs(traj.final_obs[..., 6].reshape(-1).numpy()[term])
    crashed_planet = fr <= cfg.dnc.planet_radius + tol
    left_border = fr >= cfg.dnc.border_radius - tol
    overspin = fw >= cfg.max_abs_vel_angle - 1e-3
    assert (crashed_planet | left_border | overspin).all()
    assert fr.min() >= cfg.dnc.planet_radius - tol


def test_adaptive_solver_fails_loud_on_singular_lane():
    """A lane at a planet's centre (non-finite right-hand side) is poisoned
    with NaN, the others are intact, and the step ends (the step-size
    controller must not spin on a NaN error estimate)."""
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), physics="adaptive", device="cpu")
    state, _ = eng.init(4, eng.generator(0))
    y = state.y.clone()
    y[0, :2] = state.planets_pos[0, 0]
    state = state._replace(y=y)
    u = torch.rand((4, eng.n_step_rand), generator=torch.Generator().manual_seed(1))
    nxt, ts = eng.step(state, torch.zeros((4, 2)), u=u)
    assert not torch.isfinite(ts.final_obs[0, :2]).any()  # poisoned, loud
    assert torch.isfinite(ts.final_obs[1:]).all()          # the others intact
