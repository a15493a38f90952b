"""The port's full env step (space_gym_torch/ops/full_step.py) against the JAX
full-step Pallas kernel (space_gym_tpu/ops/pallas_full.py, interpret mode).

Both sides get the same numpy-seeded state and the same uniforms `u`, in f64,
at B=8 lanes with BS3 x 1 substep / refine 8 (the bench configuration) to keep
the interpret-mode call short.  Lanes are set up to be live, truncated,
crashed and goal-reached, so every reset and resample branch is compared value
for value.  Tolerance: atol 1e-9 on floats (f64 rounding through one step),
equality on integers and flags.
"""
import numpy as np
import pytest
import torch

import space_gym_tpu
from space_gym_tpu.ops.pallas_full import make_full_step

from space_gym_torch import get_config
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.full_step_plain import count_uniform_rows, norminv
from space_gym_torch.utils import profiling

from .torch_scenarios import one_torch_thread, scenario_inputs  # noqa: F401 (autouse)

B = 8
SUB, REFINE, TAB = 1, 8, "bs3"


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerRandomOrbits-v0",
                                    "DoNotCrashContinuous-v0"])
def test_plain_full_step_matches_jax_kernel(env_id):
    import jax.numpy as jnp

    cfg, ins = scenario_inputs(env_id, B, seed=11)  # the JAX kernel's: translated actions
    _, raw = scenario_inputs(env_id, B, seed=11, raw_action=True)  # the port's: raw actions
    jcfg = space_gym_tpu.get_config(env_id)
    jfull = make_full_step(jcfg, SUB, REFINE, block=B, interpret=True, tableau=TAB)
    assert jfull.n_uniform_rows == ins[-1].shape[1]
    want = [np.asarray(o) for o in jfull(*[jnp.asarray(a) for a in ins])]

    full = FullStep(cfg, SUB, REFINE, TAB)
    got = [o.numpy() for o in full.apply(*[torch.as_tensor(a) for a in raw])]
    names = ("y", "planets", "goal", "ref", "col_shift", "obs", "final_obs", "reward",
             "int_rows", "flags")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, err_msg=name)
    flags = got[-1]
    assert flags[0, 4:6].all(), "crash lanes must terminate"
    assert flags[1, 2:4].all(), "truncation lanes must truncate"
    assert not flags[2, 0:2].any(), "live lanes stay live"
    if cfg.task == "goal":
        # reached lanes got the sparse bonus and a new goal
        assert (got[7][0, 6:8] > cfg.goal.goal_sparse_reward - 1).all()
        assert (got[2][:, 6] != ins[3][6]).any()


def test_count_uniform_rows_values():
    for env_id, n in [("GoalContinuous2P-v0", 50), ("GoalContinuous4P-v0", 138),
                      ("KeplerCircleOrbit-v0", 6), ("DoNotCrashContinuous-v0", 6)]:
        assert count_uniform_rows(get_config(env_id)) == n


def test_norminv_matches_jax_and_ndtri():
    import jax.numpy as jnp
    from scipy.special import ndtri
    from space_gym_tpu.ops.pallas_full import _norminv

    u = np.linspace(1e-9, 1 - 1e-9, 20001)
    got = norminv(torch.as_tensor(u)).numpy()
    # libm log/sqrt may differ by an ulp between the two frameworks
    np.testing.assert_allclose(got, np.asarray(_norminv(jnp.asarray(u))), rtol=0, atol=1e-13)
    assert np.abs(got - ndtri(u)).max() < 1e-8
    # f32 clip: no NaN at the ends of [0, 1)
    u32 = torch.tensor([0.0, 1e-30, 0.5, 1 - 2**-24], dtype=torch.float32)
    assert torch.isfinite(norminv(u32)).all()


def test_wrapper_rejects_bad_operands():
    cfg, ins = scenario_inputs("DoNotCrashContinuous-v0", B, seed=1, raw_action=True)
    full = FullStep(cfg, SUB, REFINE, TAB)
    t = [torch.as_tensor(a) for a in ins]
    with pytest.raises(ValueError):
        full.apply(*t[:-1], t[-1][:, :-1])  # too few uniform rows
    with pytest.raises(TypeError):
        full.apply(*t[:6], t[6].float(), t[7])  # ti not int32
    launches = profiling.counts()
    full.apply(*t)  # CPU tensors take the plain twin and count no launch
    assert profiling.counts() == launches

