"""The port's physics (space_gym_torch/ops/physics.py, the plain twin of the
CUDA device function in csrc/physics.cuh, and the K1 wrapper in
ops/physics_step.py) against space_gym_tpu.

* against the Pallas physics kernel `make_fused_step` (interpret mode) in f64
  on the same state, with crash lanes: atol 1e-9, termination flags equal;
* against the JAX fixed-substep XLA path, f32, as tests/test_pallas.py does:
  atol 5e-6, flags equal;
* the Illinois root rule on a grazing crossing, against the JAX rule and an
  independent bisection.
"""
import numpy as np
import pytest
import torch

import space_gym_tpu
from space_gym_tpu.ops.pallas_step import make_fused_step

from space_gym_torch import get_config
from space_gym_torch.ops.physics import illinois_refine
from space_gym_torch.ops.physics_step import PhysicsStep

from .torch_scenarios import one_torch_thread, scenario_inputs  # noqa: F401 (autouse)

B = 8


@pytest.mark.parametrize("env_id,tableau,substeps,refine", [
    ("GoalContinuous2P-v0", "bs3", 1, 8),
    ("DoNotCrashContinuous-v0", "dp5", 2, 12),
])
def test_plain_physics_matches_pallas_kernel_f64(env_id, tableau, substeps, refine):
    import jax.numpy as jnp

    cfg, ins = scenario_inputs(env_id, B, seed=7)
    y, a, p = ins[0], ins[1], ins[2]
    jc = space_gym_tpu.get_config(env_id)
    fused = make_fused_step(jc.ship, jc.planet_masses, jc.planet_radii, jc.world_size,
                            jc.max_abs_vel_angle, jc.step_size, substeps, refine, block=B,
                            interpret=True, tableau=tableau)
    yw, tw = (np.asarray(v) for v in fused(jnp.asarray(y), jnp.asarray(a), jnp.asarray(p)))
    k1 = PhysicsStep(cfg, substeps, refine, tableau)
    yg, tg = k1(torch.as_tensor(y), torch.as_tensor(a), torch.as_tensor(p))
    np.testing.assert_array_equal(tg.numpy(), tw)
    np.testing.assert_allclose(yg.numpy(), yw, rtol=0, atol=1e-9)
    assert tw[4:6].all(), "the crash lanes terminate"
    assert not tw[0:2].any()


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerEllipseHard-v0"])
def test_plain_physics_matches_fixed_path_f32(env_id):
    import jax
    import jax.numpy as jnp
    from space_gym_tpu.engine import EnvEngine as JaxEngine

    jc = space_gym_tpu.get_config(env_id)
    eng = JaxEngine(jc, physics="fixed", dtype=jnp.float32)
    n = 128
    state, _ = eng.init(jax.random.key(0), n)
    rng = np.random.default_rng(1)
    act = jnp.asarray(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    ab = jax.vmap(eng._translate_action)(act)
    k1 = PhysicsStep(get_config(env_id), 2, 12, "dp5")
    physics = jax.jit(jax.vmap(eng._physics))
    y = state.y
    for step in range(2):
        yr, tr = (np.asarray(v) for v in physics(y, ab, state.planets_pos))
        yp, tp = k1(torch.as_tensor(np.asarray(y)), torch.as_tensor(np.asarray(ab)),
                    torch.as_tensor(np.asarray(state.planets_pos)))
        np.testing.assert_array_equal(tp.numpy(), tr, err_msg=f"step {step}")
        np.testing.assert_allclose(yp.numpy(), yr, rtol=0, atol=5e-6, err_msg=f"step {step}")
        y = jnp.where(tr[:, None], y, yr)


def _bisect(f, lo, hi, iters=200):
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if f(mid) <= 0:
            hi = mid
        else:
            lo = mid
    return hi


@pytest.mark.parametrize("iters", [8, 12, 24])
def test_illinois_grazing_crossing_matches_reference_rule(iters):
    """g(t) = 1e-6 - t^2 on [0, 1], root 1e-3.  The port keeps the reference
    rule bug for bug: at 8 iterations (the bench's refine) it returns the
    whole interval's end, a reference fault recorded in ROADMAP.md; at 24
    it has converged."""
    import jax.numpy as jnp
    from space_gym_tpu.ops.fixed_rk import _refine_scalar

    def g(t):
        return 1e-6 - t * t

    root = _bisect(g, 0.0, 1.0)
    assert abs(root - 1e-3) < 1e-15
    got = illinois_refine(lambda t: g(t), torch.tensor([0.0], dtype=torch.float64),
                          torch.tensor([1.0], dtype=torch.float64),
                          torch.tensor([g(0.0)], dtype=torch.float64),
                          torch.tensor([g(1.0)], dtype=torch.float64), iters).item()
    want = float(_refine_scalar(lambda y: y, lambda t: g(t), jnp.float64(g(0.0)),
                                jnp.float64(g(1.0)), jnp.float64(0.0), jnp.float64(1.0), iters))
    assert got == want
    if iters == 24:
        assert abs(got - root) < 1e-9


def test_angle_wrap_matches_jnp_mod():
    import jax.numpy as jnp
    from space_gym_torch.ops.physics import TWO_PI

    x = np.array([-13.0, -TWO_PI, -1e-9, -0.0, 0.0, 1.0, TWO_PI, 7.5, 1e3])
    np.testing.assert_array_equal(torch.remainder(torch.as_tensor(x), TWO_PI).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(x), TWO_PI)))


def test_wrapper_checks_shapes_and_counts_no_cpu_launch():
    cfg, ins = scenario_inputs("GoalContinuous2P-v0", B, seed=3)
    k1 = PhysicsStep(cfg, 1, 8, "bs3")
    y, a, p = (torch.as_tensor(v) for v in ins[:3])
    with pytest.raises(ValueError):
        k1.step_rows(y.t().contiguous(), a.t().contiguous(), p.reshape(B, -1)[:, :3].t())
    with pytest.raises(ValueError):
        PhysicsStep(cfg, 9, 8, "bs3")  # more substeps than the kernel's table holds
    launches = PhysicsStep.launches
    k1(y, a, p)
    assert PhysicsStep.launches == launches

