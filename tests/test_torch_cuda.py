"""On-card tests of the port's CUDA kernels against their plain PyTorch twins.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
where there is no card.  This file imports neither jax nor space_gym_tpu, so
it also runs on a machine with only PyTorch (the tests' conftest.py imports
jax, hence `--noconftest` there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances (float32, kernel vs twin on the same inputs): states and
observations atol 1e-5, rewards atol 1e-3 (the Goal reward multiplies
position differences by goal_vel_reward_scale * distance_fctr = 500); the
kernels are built without FMA contraction, so the two differ by the ulps of
rsqrtf/sinf/cosf/logf.
"""
import numpy as np
import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine, state_from_numpy, state_to_numpy
from space_gym_torch.ops.env_step import EnvStep
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.physics_step import PhysicsStep
from space_gym_torch.ops.rng_plain import key_words

from .torch_scenarios import scenario_inputs

TOL_STATE = 1e-5
TOL_REWARD = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalContinuous4P-v0",
                                    "KeplerRandomOrbits-v0", "DoNotCrashContinuous-v0"])
@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
def test_cuda_full_step_matches_plain_twin(env_id, tableau, substeps, refine):
    _need_card()
    cfg, ins = scenario_inputs(env_id, 64, seed=5)
    full = FullStep(cfg, substeps, refine, tableau)
    ins32 = [torch.as_tensor(a) if a.dtype == np.int32 else torch.as_tensor(a).float()
             for a in ins]
    want = full.apply(*ins32)
    launches = FullStep.launches
    got = [o.cpu() for o in full.apply(*[a.cuda() for a in ins32])]
    assert FullStep.launches == launches + 1
    assert (got[-1] == want[-1]).all() and (got[-2] == want[-2]).all()
    for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
        tol = TOL_REWARD if i == 7 else TOL_STATE
        assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True), i


@pytest.mark.cuda
@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
def test_cuda_physics_matches_plain_twin(tableau, substeps, refine):
    _need_card()
    cfg, ins = scenario_inputs("GoalContinuous2P-v0", 64, seed=9)
    k1 = PhysicsStep(cfg, substeps, refine, tableau)
    y, a, p = (torch.as_tensor(v).float() for v in ins[:3])
    yw, tw = k1(y, a, p)
    launches = PhysicsStep.launches
    yg, tg = k1(y.cuda(), a.cuda(), p.cuda())
    assert PhysicsStep.launches == launches + 1
    assert (tg.cpu() == tw).all() and tw.any()
    assert torch.allclose(yg.cpu(), yw, rtol=0, atol=TOL_STATE)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    cfg, ins = scenario_inputs("DoNotCrashContinuous-v0", 8, seed=1)
    full = FullStep(cfg, 1, 8, "bs3")
    t = [torch.as_tensor(a).cuda() for a in ins]  # float64 floats
    with pytest.raises(TypeError):
        full.apply(*t)
    k1 = PhysicsStep(cfg, 1, 8, "bs3")
    with pytest.raises(TypeError):
        k1(*t[:3])


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine():
    _need_card()
    cfg = get_config("GoalContinuous2P-v0")
    eg = EnvEngine(cfg, tableau="bs3", substeps=1, refine_iters=8)
    ec = EnvEngine(cfg, tableau="bs3", substeps=1, refine_iters=8, device="cpu")
    rng = np.random.default_rng(0)
    sc, _ = ec.reset(256, u=torch.as_tensor(rng.random((256, ec.n_reset_rand), dtype=np.float32)))
    act = torch.as_tensor(rng.uniform(-1, 1, (256, 2)).astype(np.float32))
    u = torch.as_tensor(rng.random((256, ec.n_step_rand), dtype=np.float32))
    _, tg = eg.step(state_from_numpy(state_to_numpy(sc), device="cuda"), act.cuda(), u=u.cuda())
    _, tc = ec.step(sc, act, u=u)
    assert (tg.done.cpu() == tc.done).all()
    assert torch.allclose(tg.final_obs.cpu(), tc.final_obs, rtol=0, atol=TOL_STATE)
    assert torch.allclose(tg.obs.cpu(), tc.obs, rtol=0, atol=TOL_STATE)
    assert torch.allclose(tg.reward.cpu(), tc.reward, rtol=0, atol=TOL_REWARD)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalContinuous3P-v0",
                                    "KeplerRandomOrbits-v0", "DoNotCrashContinuous-v0"])
@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
def test_cuda_env_step_matches_plain_twin(env_id, tableau, substeps, refine):
    _need_card()
    cfg, ins = scenario_inputs(env_id, 64, seed=6)
    k2 = EnvStep(cfg, substeps, refine, tableau)
    t = [torch.as_tensor(v).float() for v in ins[:5]]
    want = k2(*t)
    launches = EnvStep.launches
    got = [o.cpu() for o in k2(*[v.cuda() for v in t])]
    assert EnvStep.launches == launches + 1
    assert (got[1] == want[1]).all() and want[1].any()
    assert torch.allclose(got[0], want[0], rtol=0, atol=TOL_STATE)
    assert torch.allclose(got[2], want[2], rtol=0, atol=TOL_STATE, equal_nan=True)
    assert torch.allclose(got[3], want[3], rtol=0, atol=TOL_REWARD, equal_nan=True)
    with pytest.raises(TypeError):
        k2(*[torch.as_tensor(v).cuda() for v in ins[:5]])  # float64


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["threefry", "philox"])
@pytest.mark.parametrize("env_id,batch", [("GoalContinuous2P-v0", 1000),
                                          ("GoalContinuous4P-v0", 129),
                                          ("KeplerRandomOrbits-v0", 64)])
def test_cuda_generators_match_plain_versions_bitwise(env_id, batch, mode):
    """The block a kernel writes through the device function K3 draws with,
    against ops/rng_plain.py, bit for bit; then K3 given the key against K3
    fed that block: every output bit-identical."""
    _need_card()
    cfg, ins = scenario_inputs(env_id, 64, seed=7)
    keyed = FullStep(cfg, 1, 8, "bs3", in_kernel_rng=mode)
    mem = FullStep(cfg, 1, 8, "bs3")
    key = key_words([0x9E3779B9, 0x00C0FFEE])
    u = keyed.kernel_uniforms(key.cuda(), batch)
    want = keyed.plain_uniforms(key, batch)
    assert u.shape == want.shape == (keyed.n_uniform_rows, batch)
    assert torch.equal(u.cpu().view(torch.int32), want.view(torch.int32))

    t = [torch.as_tensor(a).cuda() if a.dtype == np.int32 else torch.as_tensor(a).float().cuda()
         for a in ins]
    block = keyed.kernel_uniforms(key.cuda(), 64)
    by_mode = dict(FullStep.launches_by_rng)
    got = keyed.apply(*t[:7], key.cuda())
    assert FullStep.launches_by_rng[mode] == by_mode[mode] + 1
    assert FullStep.launches_by_rng[False] == by_mode[False]
    fed = mem.apply(*t[:7], block.t())
    for g, w in zip(got, fed):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert fed[-1][2].any(), "some lane resets"
    with pytest.raises(TypeError):
        keyed.apply(*t)  # a uniforms block where the key belongs


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(fuse="env"), dict(fuse="physics"), dict(physics="fixed"),
                                dict(in_kernel_rng="threefry"), dict(in_kernel_rng="philox")],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_cuda_tier_matches_its_cpu_engine(kw):
    """Every tier on the card against the same tier on the CPU (plain twins),
    same state, actions and uniforms or key."""
    _need_card()
    cfg = get_config("GoalContinuous2P-v0")
    eg = EnvEngine(cfg, **kw)
    ec = EnvEngine(cfg, device="cpu", **kw)
    assert eg.n_step_rand == ec.n_step_rand
    rng = np.random.default_rng(0)
    sc, _ = ec.reset(256, u=torch.as_tensor(rng.random((256, ec.n_reset_rand), dtype=np.float32)))
    act = torch.as_tensor(rng.uniform(-1, 1, (256, 2)).astype(np.float32))
    sg = state_from_numpy(state_to_numpy(sc), device="cuda")
    if eg.in_kernel_rng:
        _, tg = eg.step(sg, act.cuda(), key=[123, 456])
        _, tc = ec.step(sc, act, key=[123, 456])
    else:
        u = torch.as_tensor(rng.random((256, ec.n_step_rand), dtype=np.float32))
        _, tg = eg.step(sg, act.cuda(), u=u.cuda())
        _, tc = ec.step(sc, act, u=u)
    assert (tg.done.cpu() == tc.done).all()
    assert torch.allclose(tg.final_obs.cpu(), tc.final_obs, rtol=0, atol=TOL_STATE)
    assert torch.allclose(tg.obs.cpu(), tc.obs, rtol=0, atol=TOL_STATE)
    assert torch.allclose(tg.reward.cpu(), tc.reward, rtol=0, atol=TOL_REWARD)
