"""Robustness fuzzing of the port, after tests/test_fuzz.py: the integrators
and the engine stay finite and semantically sane from adversarial states
(grazing trajectories, near-surface spawns, extreme velocities,
boundary-straddling starts), on the port's "fixed" and "adaptive" tiers and
on the plain twin of the full-step kernel K3, at the JAX tests'
tolerances.

The grazing states are tests/test_fuzz.py's own (its generator and keys,
made with jax.random), so both packages are fuzzed on the same inputs.  The
long bang-bang rollout runs 200 steps here, at about 20 ms a step on the
CPU, where the JAX test runs 2000; chip_smoke.py's fuzz_path runs the 2000
steps at 512 lanes on the card through K3 (and 64 through physics="fixed").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import space_gym_tpu

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from .test_fuzz import adversarial_states
from .test_torch_properties import k3_physics
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
DNC = "DoNotCrashContinuous-v0"


def grazing_inputs(n):
    """tests/test_fuzz.py's grazing states and actions (keys 0 and 1), as
    float64 tensors."""
    jcfg = space_gym_tpu.get_config(DNC)
    ys = np.asarray(adversarial_states(jcfg, n, jax.random.key(0)))
    acts = np.asarray(jax.random.uniform(jax.random.key(1), (n, 2), jnp.float64,
                                         minval=-1, maxval=1))
    return torch.tensor(ys), torch.tensor(acts)


def step_fn(tier, cfg):
    """(y, translated action, planets) -> (y at the step's end, terminated)
    of one tier; for K3 the pre-reset state of a terminated lane is its final
    observation's position and spin."""
    if tier == "k3":
        eng = EnvEngine(cfg, physics="kernel", dtype=F64, device="cpu")
        step = k3_physics(eng)

        def run(y, a, p):
            _, term, fobs = step(y, a, p)
            # final observation: x, y, cos, sin, vx, vy, omega, ...
            return torch.cat([fobs[:, 0:2], torch.zeros_like(fobs[:, :1]), fobs[:, 4:7]], 1), term
        return eng, run
    eng = EnvEngine(cfg, physics=tier, dtype=F64, device="cpu")
    return eng, eng._physics


@pytest.mark.parametrize("tier", ["fixed", "adaptive", "k3"])
def test_integrator_finite_from_grazing_states(tier):
    cfg = get_config(DNC)
    eng, phys = step_fn(tier, cfg)
    n = 128
    ys, acts = grazing_inputs(n)
    planets = torch.tensor(cfg.fixed_planet_pos, dtype=F64)[None].expand(n, -1, -1).contiguous()
    y, term = phys(ys, eng._translate_action(acts), planets)
    y, term = y.numpy(), term.numpy()
    assert np.isfinite(y).all()
    # Lanes that started that close to the surface at those speeds mostly
    # terminate; terminated states sit essentially on an event surface.
    assert term.mean() > 0.2
    r = np.hypot(y[term, 0], y[term, 1])
    w = np.abs(y[term, 5])
    on_surface = np.abs(r - cfg.dnc.planet_radius) < 1e-3
    on_border = np.abs(r - cfg.dnc.border_radius) < 1e-3
    on_spin = np.abs(w - cfg.max_abs_vel_angle) < 1e-3
    assert (on_surface | on_border | on_spin).all()


@pytest.mark.parametrize("tier", ["fixed", "kernel"])
def test_engine_survives_long_adversarial_rollout(tier):
    """Max-magnitude bang-bang actions (float32, as the JAX test): no NaN,
    auto-reset keeps every lane inside the world, episodes end."""
    cfg = get_config("GoalContinuous2P-v0")
    eng = EnvEngine(cfg, physics=tier, substeps=1, refine_iters=8, device="cpu")
    state, obs = eng.init(512, eng.generator(0))

    def bang_bang(g, o):
        return (torch.randint(0, 2, (o.shape[0], 2), generator=g) * 2 - 1).to(torch.float32)

    state, obs, traj = eng.rollout(state, obs, bang_bang, 200, eng.generator(1))
    assert torch.isfinite(traj.reward).all() and torch.isfinite(traj.obs).all()
    xy = obs[:, 0:2].numpy()
    assert (np.abs(xy) <= cfg.world_size / 2 + 1e-3).all()
    assert int(traj.terminated.sum()) > 0


@pytest.mark.parametrize("tier", ["fixed", "k3"])
def test_zero_and_exact_boundary_states(tier):
    """Degenerate starts: exactly at max spin, exactly on the planet's
    surface.  direction=0 events fire on touching."""
    cfg = get_config(DNC)
    _, phys = step_fn(tier, cfg)
    planets = torch.tensor(cfg.fixed_planet_pos, dtype=F64)[None]
    a0 = torch.zeros((1, 2), dtype=F64)
    # at max angular velocity, acceleration steering, no thrust: the spin
    # event's value is 0 at t=0 and fires within the step
    y = torch.tensor([[0.5, 0.0, 0.0, 0.0, 0.0, cfg.max_abs_vel_angle]], dtype=F64)
    _, term = phys(y, a0, planets)
    assert bool(term[0])
    # resting on the planet surface: the crash event is 0 at the start
    y = torch.tensor([[cfg.dnc.planet_radius, 0.0, 0.0, 0.0, 0.0, 0.0]], dtype=F64)
    ynew, term = phys(y, a0, planets)
    assert bool(term[0]) and torch.isfinite(ynew).all()
