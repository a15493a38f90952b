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
rsqrtf/sinf/cosf/logf.  The learner kernels K4 and K5 (models/fused_sac.py)
are held to `update_k_reference` at the tolerances of
tests/test_torch_fused_sac.py, to themselves bit for bit on a second call, and
to each other bit for bit; the TD3 kernel K6 (models/fused_td3.py) the same
way, with both step counts held to the plain version's.
"""
import numpy as np
import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine, state_from_numpy, state_to_numpy
from space_gym_torch.models import (SACConfig, SACTrainer, TD3Config, TD3Trainer, fused_sac,
                                    fused_td3, networks)
from space_gym_torch.models.replay import Transition, pack_slab, replay_cols, unpack_flat
from space_gym_torch.ops.env_step import EnvStep
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.physics_step import PhysicsStep
from space_gym_torch.ops.rng_plain import key_words
from space_gym_torch.utils import cuda_build, profiling

from .torch_scenarios import (firing_operands, one_torch_thread,  # noqa: F401 (autouse)
                              pattern_operands, scenario_inputs)

TOL_STATE = 1e-5
TOL_REWARD = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


K3_KERNELS = ("full_step", "full_step_threefry", "full_step_philox")


def _launches(*kernels):
    """The launches of `kernels` counted so far (utils/profiling.py)."""
    counts = profiling.counts()
    return sum(counts.get(k, 0) for k in kernels)


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
    launches = _launches(*K3_KERNELS)
    got = [o.cpu() for o in full.apply(*[a.cuda() for a in ins32])]
    assert _launches(*K3_KERNELS) == launches + 1
    assert (got[-1] == want[-1]).all() and (got[-2] == want[-2]).all()
    for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
        tol = TOL_REWARD if i == 7 else TOL_STATE
        assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True), i


@pytest.mark.cuda
@pytest.mark.parametrize("rng", [False, "threefry", "philox"], ids=["mem", "threefry", "philox"])
@pytest.mark.parametrize("batch", [1, 127, 65537])
@pytest.mark.parametrize("env_id,tableau,substeps,refine",
                         [("GoalContinuous2P-v0", "bs3", 1, 8),
                          ("DoNotCrashContinuous-v0", "dp5", 2, 12)])
def test_cuda_full_step_any_batch_matches_plain_twin(env_id, tableau, substeps, refine, batch,
                                                     rng):
    """K3, K3-tf and K3-hw at a batch of one lane, of less than a tile, and of
    a ragged last tile with no row 16-byte aligned after 512 whole tiles: flags and integer rows equal to the twin's on every lane
    (on 99.9% at 65537 lanes, where the ulps of rsqrtf/sinf/cosf may flip a
    grazing event, as in chip_smoke.py), floats within the tolerances on the
    lanes that agree."""
    _need_card()
    cfg = get_config(env_id)
    full = FullStep(cfg, substeps, refine, tableau, in_kernel_rng=rng)
    rows = pattern_operands(cfg, max(batch, 10), seed=batch)
    rows = [t[:, :batch].contiguous() for t in rows]
    if rng:
        rows[6] = key_words([0x600DF00D, batch])
    want = full.step_rows(*rows)
    launches = _launches(*K3_KERNELS)
    got = [o.cpu() for o in full.step_rows(*[t.cuda() for t in rows])]
    assert _launches(*K3_KERNELS) == launches + 1
    agree = (got[-1] == want[-1]).all(0) & (got[-2] == want[-2]).all(0)
    assert agree.all() if batch < 1000 else agree.float().mean() >= 0.999
    for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
        tol = TOL_REWARD if i == 7 else TOL_STATE
        assert torch.allclose(g[:, agree], w[:, agree], rtol=0, atol=tol, equal_nan=True), i
    if batch > 1:
        assert want[-1][2].any(), "some lane resets"


@pytest.mark.cuda
@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
def test_cuda_physics_matches_plain_twin(tableau, substeps, refine):
    _need_card()
    cfg, ins = scenario_inputs("GoalContinuous2P-v0", 64, seed=9)
    k1 = PhysicsStep(cfg, substeps, refine, tableau)
    y, a, p = (torch.as_tensor(v).float() for v in ins[:3])
    yw, tw = k1(y, a, p)
    launches = _launches("fused_step")
    yg, tg = k1(y.cuda(), a.cuda(), p.cuda())
    assert _launches("fused_step") == launches + 1
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
    launches = _launches("env_step")
    got = [o.cpu() for o in k2(*[v.cuda() for v in t])]
    assert _launches("env_step") == launches + 1
    assert (got[1] == want[1]).all() and want[1].any()
    assert torch.allclose(got[0], want[0], rtol=0, atol=TOL_STATE)
    assert torch.allclose(got[2], want[2], rtol=0, atol=TOL_STATE, equal_nan=True)
    assert torch.allclose(got[3], want[3], rtol=0, atol=TOL_REWARD, equal_nan=True)
    with pytest.raises(TypeError):
        k2(*[torch.as_tensor(v).cuda() for v in ins[:5]])  # float64


@pytest.mark.cuda
@pytest.mark.parametrize("tableau,substeps,refine", [("bs3", 1, 8), ("dp5", 2, 12)])
@pytest.mark.parametrize("env_id,batch", [("GoalContinuous2P-v0", 150001),
                                          ("KeplerRandomOrbits-v0", 333)])
def test_cuda_env_kernels_defer_firing_lanes(env_id, batch, tableau, substeps, refine):
    """K1 and K2 where three lanes in four fire, against the plain twins, and
    a second launch in equal bits.  At B=150001 (more lanes than the card
    holds at once) blocks walk two tiles or more, so their firing lanes are
    more than a block's list of deferred lanes holds: it fills and the rest
    refine in place."""
    _need_card()
    cfg = get_config(env_id)
    rows = firing_operands(cfg, batch, seed=7, device="cuda")
    for k, n_in in ((PhysicsStep(cfg, substeps, refine, tableau), 3),
                    (EnvStep(cfg, substeps, refine, tableau), 5)):
        got = [o.cpu() for o in k.step_rows(*rows[:n_in])]
        again = [o.cpu() for o in k.step_rows(*rows[:n_in])]
        want = k.plain_rows(*[r.cpu() for r in rows[:n_in]])
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, again))
        assert torch.equal(got[1], want[1]) and int(want[1].sum()) > batch // 2
        for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            tol = TOL_REWARD if g.shape[0] == 1 else TOL_STATE
            assert torch.allclose(g, w, rtol=0, atol=tol, equal_nan=True)


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
    by_mode = profiling.counts()
    got = keyed.apply(*t[:7], key.cuda())
    name = {"threefry": "full_step_threefry", "philox": "full_step_philox"}[mode]
    assert _launches(name) == by_mode.get(name, 0) + 1
    assert _launches("full_step") == by_mode.get("full_step", 0)
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


# ------------------------------------------------ the learner kernels K4, K5 --
SAC_HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)


def _bf16_close(got, want, K, name):
    """The bf16 mode against its plain version: an element may move by 2.5 lr
    per update where bf16 flips the sign of a near-zero gradient, 99% agree
    to 1e-4."""
    d = (got - want).abs()
    assert d.max().item() <= K * 2.5 * 3e-4, name
    assert (d <= 1e-4).float().mean().item() > 0.99, name


def _sac_case(h, K, B, lanes, obs_dim=13, rows=8, seed=3):
    """A learner state after one plain update, a ring, row indices with a
    repeated row, the same minibatches gathered, normals; all on the card."""
    ns = fused_sac.build(h)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    nets = [networks.TanhGaussianActor(obs_dim, 2, (h, h), generator=g)] + [
        networks.DoubleCritic(obs_dim, 2, (h, h), generator=g) for _ in range(2)]
    packed = fused_sac.PackedParams(
        *[x.cuda() for x in ns.pack_params(*nets, torch.tensor(-2.0))])

    def f32(a):
        return torch.as_tensor(a.astype(np.float32)).cuda()

    ring = pack_slab(Transition(
        obs=f32(rng.standard_normal((rows, lanes, obs_dim))),
        action=f32(rng.uniform(-1, 1, (rows, lanes, 2))),
        reward=f32(rng.standard_normal((rows, lanes))),
        next_obs=f32(rng.standard_normal((rows, lanes, obs_dim))),
        discount=f32(rng.random((rows, lanes)) > 0.1)), obs_dim, 2)
    idx = rng.integers(0, rows, K * B // lanes)
    idx[-1] = idx[0]
    row_idx = torch.as_tensor(idx).cuda()
    w = replay_cols(obs_dim, 2)[-1]
    batches = unpack_flat(ring[row_idx].transpose(1, 2).reshape(K, B, w), obs_dim, 2)
    noises = f32(rng.standard_normal((K, B, 2, 2)))
    packed, adam, _, _ = ns.update_k_reference(
        packed, ns.adam_init(packed), Transition(*[x[:1] for x in batches]), noises[:1],
        obs_dim, **SAC_HYPER)
    return ns, obs_dim, packed, adam, ring, row_idx, batches, noises


def _same_bits(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[0][:6], b[0][:6]))
            and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("h,K,B,lanes", [(256, 2, 4096, 2048), (512, 1, 2048, 1024),
                                         (128, 2, 1024, 512), (256, 2, 100, 50),
                                         (512, 2, 8192, 4096)])
def test_cuda_sac_update_kernels_match_the_plain_version(h, K, B, lanes):
    """K4 and K5, from the ring and from gathered minibatches, float32; B=100
    and ring lanes of 50 end in partial tiles, and at H=512 B=8192 has more
    tiles of 32 samples than the card has blocks, so K5 folds several tiles a
    block."""
    _need_card()
    ns, od, packed, adam, ring, row_idx, batches, noises = _sac_case(h, K, B, lanes)
    hyper = dict(SAC_HYPER, obs_dim=od, mm_bf16=False)
    want_p, want_ad, want_cl, want_al = ns.update_k_reference(packed, adam, batches, noises,
                                                              **hyper)
    outs = {}
    for fold, lib in ((False, "sac_update"), (True, "sac_update_fold")):
        for mode in ("ring", "batches"):
            runs = []
            for _ in range(2):
                f0 = ns.fused_init(packed, adam)
                before = _launches(lib)
                if mode == "ring":
                    out = ns.fused_update_k_wmat(f0, ring, row_idx, noises, fold=fold, **hyper)
                else:
                    out = ns.fused_update_k_wmat_batches(f0, batches, noises, fold=fold, **hyper)
                torch.cuda.synchronize()
                assert _launches(lib) == before + 1
                assert out[0].w is f0.w, "the state is updated in place"
                runs.append((out[0], out[1].clone(), out[2].clone()))
            assert _same_bits(*runs), "a second call gives the same bits"
            outs[(fold, mode)] = runs[0]
            got_p, got_ad = ns.fused_unpack(runs[0][0])
            assert got_ad.count == want_ad.count == adam.count + K
            assert torch.allclose(runs[0][1], want_cl, rtol=1e-4, atol=1e-5)
            assert torch.allclose(runs[0][2], want_al, rtol=1e-3, atol=1e-5)
            for f in fused_sac.PackedParams._fields:
                assert torch.allclose(getattr(got_p, f), getattr(want_p, f), rtol=2e-4,
                                      atol=2e-5), f
                assert torch.allclose(getattr(got_ad.m, f), getattr(want_ad.m, f), rtol=2e-3,
                                      atol=2e-5), f
                assert torch.allclose(getattr(got_ad.v, f), getattr(want_ad.v, f), rtol=2e-3,
                                      atol=2e-5), f
    first = outs[(False, "ring")]
    for mode in ("ring", "batches"):
        assert _same_bits(outs[(False, mode)], outs[(True, mode)]), "K5 = K4, bit for bit"
    if lanes % fused_sac.KERNEL_TILE[h] == 0:   # else each ring row ends in a tile of its own
        assert _same_bits(first, outs[(False, "batches")]), "ring = batches, bit for bit"
    # K updates in one launch equal K launches of one update: the grid barriers
    # inside a launch order memory as the end of a launch does
    rpb = B // lanes
    for fold in (False, True):
        f0 = ns.fused_init(packed, adam)
        cls, als = [], []
        for k in range(K):
            f0, cl, al = ns.fused_update_k_wmat(f0, ring, row_idx[k * rpb:(k + 1) * rpb],
                                                noises[k:k + 1], fold=fold, **hyper)
            cls.append(cl.clone())
            als.append(al.clone())
        assert _same_bits((f0, torch.cat(cls), torch.cat(als)), first)


@pytest.mark.cuda
def test_cuda_sac_update_bf16_mode_and_floor():
    """mm_bf16=True (the trainer's mode on the card) against the plain
    version's: an element may move by 2.5 lr per update where bf16 flips the
    sign of a near-zero gradient, 99% agree to 1e-4; alpha_floor clamps."""
    _need_card()
    ns, od, packed, adam, ring, row_idx, batches, noises = _sac_case(256, 2, 4096, 2048)
    hyper = dict(SAC_HYPER, obs_dim=od, mm_bf16=True, alpha_floor=0.5)
    want_p, _, want_cl, _ = ns.update_k_reference(packed, adam, batches, noises, **hyper)
    outs = []
    for fold in (False, True):
        f1, cl, _ = ns.fused_update_k_wmat(ns.fused_init(packed, adam), ring, row_idx, noises,
                                           fold=fold, **hyper)
        outs.append(f1)
        got_p, _ = ns.fused_unpack(f1)
        assert torch.allclose(cl, want_cl, rtol=1e-3)
        assert float(got_p.log_alpha) == pytest.approx(np.log(0.5), abs=1e-6)
        for f in ("a_w1", "a_w2", "c_w1", "c_w2"):
            d = (getattr(got_p, f) - getattr(want_p, f)).abs()
            assert d.max().item() <= 2 * 2.5 * SAC_HYPER["lr"], f
            assert (d <= 1e-4).float().mean().item() > 0.99, f
    assert all(torch.equal(a, b) for a, b in zip(outs[0][:6], outs[1][:6]))


@pytest.mark.cuda
def test_cuda_learner_kernels_use_the_tensor_cores():
    """K4, K5 and K6 run their bf16-mode products on the tensor cores: HMMA
    instructions in the SASS of their libraries."""
    _need_card()
    for name in ("sac_update", "sac_update_fold", "td3_update"):
        assert cuda_build.sass_count(name, "HMMA") > 0, name


@pytest.mark.cuda
def test_cuda_sac_entry_points_reject_what_the_kernels_do_not_take():
    _need_card()
    ns, od, packed, adam, ring, row_idx, batches, noises = _sac_case(256, 2, 4096, 2048)
    hyper = dict(SAC_HYPER, obs_dim=od)
    f0 = ns.fused_init(packed, adam)
    with pytest.raises(TypeError):      # the ring in float64
        ns.fused_update_k_wmat(f0, ring.double(), row_idx, noises, **hyper)
    # a batch that is no multiple of the kernel's tile: a partial tile, in bf16 mode
    b100, n100 = Transition(*[x[:, :100] for x in batches]), noises[:, :100].contiguous()
    want_p, _, want_cl, _ = ns.update_k_reference(packed, adam, b100, n100, mm_bf16=True,
                                                  **hyper)
    for fold in (False, True):
        f1, cl, _ = ns.fused_update_k_wmat_batches(ns.fused_init(packed, adam), b100, n100,
                                                   fold=fold, **hyper)
        got_p, _ = ns.fused_unpack(f1)
        assert torch.allclose(cl, want_cl, rtol=1e-3)
        for f in ("a_w1", "a_w2", "c_w1", "c_w2"):
            _bf16_close(getattr(got_p, f), getattr(want_p, f), 2, f)
    with pytest.raises(TypeError):      # row indices on the CPU
        ns.fused_update_k_wmat(f0, ring, row_idx.cpu(), noises, **hyper)
    with pytest.raises(ValueError, match="built for hidden widths"):   # a width not built
        SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                   SACConfig(hidden=(640, 640), fused_updates=True))


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True], ids=["k4", "k5"])
def test_cuda_trainer_launches_its_kernel_every_live_iteration(fold):
    _need_card()
    tr = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                    SACConfig(lanes=512, rollout_len=4, replay_rows=64, batch_size=1024,
                              updates_per_iter=4, warmup_rows=8, fused_updates=True,
                              fused_fold=fold))
    assert tr.device.type == "cuda"
    st = tr.init(0)
    g = tr.generator(1)
    lib = "sac_update_fold" if fold else "sac_update"
    before = _launches(lib)
    w0 = st.fused.w.clone()
    st, m = tr.train_iter(st, g)
    assert torch.equal(st.fused.w, w0) and _launches(lib) == before
    for _ in range(3):
        st, m = tr.train_iter(st, g)
    assert _launches(lib) == before + 3 and st.fused.count == 12
    assert not torch.equal(st.fused.w, w0)
    assert all(np.isfinite(float(v)) for v in m.values())
    # a batch that is no multiple of the lanes goes through the kernel's batches mode
    tr2 = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                     SACConfig(lanes=512, rollout_len=4, replay_rows=64, batch_size=768,
                               updates_per_iter=2, warmup_rows=4, fused_updates=True,
                               fused_fold=fold))
    st2, m2 = tr2.train_iter(tr2.init(0), tr2.generator(2))
    assert _launches(lib) == before + 4 and np.isfinite(float(m2["critic_loss"]))


# ----------------------------------------------------- the learner kernel K6 --
TD3_HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, smooth_std=0.2, smooth_clip=0.5)


def _td3_case(h, K, B, lanes, warm, delay, obs_dim=13, rows=8, seed=4):
    """A TD3 learner after `warm` plain updates (the kernel starts from that
    count), targets drawn apart from the online networks, a ring, row indices
    with a repeated row, the same minibatches gathered, normals; on the card."""
    ns = fused_td3.build(h)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    nets = [networks.DeterministicActor(obs_dim, 2, (h, h), generator=g) for _ in range(2)] + [
        networks.DoubleCritic(obs_dim, 2, (h, h), generator=g) for _ in range(2)]
    packed = fused_td3.PackedParams(*[x.cuda() for x in ns.pack_params(*nets)])

    def f32(a):
        return torch.as_tensor(a.astype(np.float32)).cuda()

    ring = pack_slab(Transition(
        obs=f32(rng.standard_normal((rows, lanes, obs_dim))),
        action=f32(rng.uniform(-1, 1, (rows, lanes, 2))),
        reward=f32(rng.standard_normal((rows, lanes))),
        next_obs=f32(rng.standard_normal((rows, lanes, obs_dim))),
        discount=f32(rng.random((rows, lanes)) > 0.1)), obs_dim, 2)
    idx = rng.integers(0, rows, K * B // lanes)
    idx[-1] = idx[0]
    row_idx = torch.as_tensor(idx).cuda()
    w = replay_cols(obs_dim, 2)[-1]
    batches = unpack_flat(ring[row_idx].transpose(1, 2).reshape(K, B, w), obs_dim, 2)
    noises = f32(rng.standard_normal((K, B, 2)))
    hyper = dict(TD3_HYPER, obs_dim=obs_dim, policy_delay=delay)
    first = Transition(*[x[:1].repeat(warm, *[1] * (x.dim() - 1)) for x in batches])
    packed, adam, _, _ = ns.update_k_reference(packed, ns.adam_init(packed), first,
                                               noises[:1].repeat(warm, 1, 1), **hyper)
    return ns, packed, adam, ring, row_idx, batches, noises, hyper


def _close_but_for_relu_flips(got, want, rtol, K, name):
    """Within rtol / atol 2e-5 of the plain version, but for what one ReLU
    flip does: over K * B samples and 1280 hidden units a pre-activation now
    and then lies within float32 rounding of zero, the kernel and the plain
    version (sums in another order) then disagree on that unit's mask for that
    sample, and Adam's division by sqrt(v) turns the one-sample difference in a
    column of gradients into a fraction of lr.  So as many elements as one
    column of the tensor holds (or 2) may miss the tolerance, none by more
    than lr per update."""
    d = (got - want).abs()
    bad = int((d > 2e-5 + rtol * want.abs()).sum())
    assert bad <= max(2, got.numel() // 256), (name, bad, d.max().item())
    assert d.max().item() <= TD3_HYPER["lr"] * K, (name, d.max().item())


def _same_td3(a, b):
    return _same_bits(a, b) and a[0][6:] == b[0][6:]


@pytest.mark.cuda
@pytest.mark.parametrize("h,K,B,lanes,warm,delay", [(256, 3, 4096, 2048, 1, 2),
                                                    (256, 4, 4096, 2048, 1, 3),
                                                    (512, 2, 2048, 1024, 2, 2),
                                                    (128, 3, 1024, 512, 3, 1),
                                                    (256, 2, 100, 50, 1, 2)])
def test_cuda_td3_update_kernel_matches_the_plain_version(h, K, B, lanes, warm, delay):
    """K6 from the ring and from gathered minibatches, float32, from an odd or
    even count with policy_delay 1, 2 and 3; B=100 and ring lanes of 50 end
    in partial tiles."""
    _need_card()
    ns, packed, adam, ring, row_idx, batches, noises, hyper = _td3_case(h, K, B, lanes, warm,
                                                                        delay)
    hyper = dict(hyper, mm_bf16=False)
    want_p, want_ad, want_cl, want_al = ns.update_k_reference(packed, adam, batches, noises,
                                                              **hyper)
    outs = {}
    for mode in ("ring", "batches"):
        runs = []
        for _ in range(2):
            f0 = ns.fused_init(packed, adam)
            before = _launches("td3_update")
            if mode == "ring":
                out = ns.fused_update_k_wmat(f0, ring, row_idx, noises, **hyper)
            else:
                out = ns.fused_update_k_wmat_batches(f0, batches, noises, **hyper)
            torch.cuda.synchronize()
            assert _launches("td3_update") == before + 1
            assert out[0].w is f0.w, "the state is updated in place"
            runs.append((out[0], out[1].clone(), out[2].clone()))
        assert _same_td3(*runs), "a second call gives the same bits"
        outs[mode] = runs[0]
        got_p, got_ad = ns.fused_unpack(runs[0][0])
        assert (got_ad.count, got_ad.count_a) == (want_ad.count, want_ad.count_a)
        assert got_ad.count == warm + K
        assert torch.allclose(runs[0][1], want_cl, rtol=1e-4, atol=1e-5)
        assert torch.allclose(runs[0][2], want_al, rtol=1e-3, atol=1e-5)
        for f in fused_td3.PackedParams._fields:
            _close_but_for_relu_flips(getattr(got_p, f), getattr(want_p, f), 2e-4, K, f)
            _close_but_for_relu_flips(getattr(got_ad.m, f), getattr(want_ad.m, f), 2e-3, K, f)
            _close_but_for_relu_flips(getattr(got_ad.v, f), getattr(want_ad.v, f), 2e-3, K, f)
    if lanes % fused_td3.KERNEL_TILE[h] == 0:   # else each ring row ends in a tile of its own
        assert _same_td3(outs["ring"], outs["batches"]), "ring = batches, bit for bit"
    # K updates in one launch equal K launches of one update, both counts carried on
    rpb = B // lanes
    f0 = ns.fused_init(packed, adam)
    cls, als = [], []
    for k in range(K):
        f0, cl, al = ns.fused_update_k_wmat(f0, ring, row_idx[k * rpb:(k + 1) * rpb],
                                            noises[k:k + 1], **hyper)
        cls.append(cl.clone())
        als.append(al.clone())
    assert _same_td3((f0, torch.cat(cls), torch.cat(als)), outs["ring"])


@pytest.mark.cuda
def test_cuda_td3_update_bf16_mode_and_rejections():
    """mm_bf16=True (the trainer's mode on the card, on the tensor cores)
    against the plain version's: an element may move by 2.5 lr per update
    where bf16 flips the sign of a near-zero gradient, 99% agree to 1e-4; a
    second call and K launches of one update give the bits of one launch of
    K.  Then a batch with a partial tile, and what the entry points do not
    take."""
    _need_card()
    ns, packed, adam, ring, row_idx, batches, noises, hyper = _td3_case(256, 2, 4096, 2048, 1, 2)
    want_p, _, want_cl, _ = ns.update_k_reference(packed, adam, batches, noises, mm_bf16=True,
                                                  **hyper)
    runs = [ns.fused_update_k_wmat(ns.fused_init(packed, adam), ring, row_idx, noises,
                                   mm_bf16=True, **hyper) for _ in range(2)]
    got_p, _ = ns.fused_unpack(runs[0][0])
    assert torch.allclose(runs[0][1], want_cl, rtol=1e-3)
    for f in ("a_w1", "a_w2", "ta_w2", "c_w1", "c_w2", "t_w2"):
        _bf16_close(getattr(got_p, f), getattr(want_p, f), 2, f)
    assert _same_td3(*runs), "a second call gives the same bits"
    # K launches of one update: each builds the bf16 shadow anew, so equal
    # bits show that one launch keeps every shadow row current
    rpb = 4096 // 2048
    f3, cls, als = ns.fused_init(packed, adam), [], []
    for k in range(2):
        f3, c3, a3 = ns.fused_update_k_wmat(f3, ring, row_idx[k * rpb:(k + 1) * rpb],
                                            noises[k:k + 1], mm_bf16=True, **hyper)
        cls.append(c3.clone())
        als.append(a3.clone())
    assert _same_td3((f3, torch.cat(cls), torch.cat(als)), runs[0]), \
        "K launches of one update give the bits of one launch of K"
    # a batch that is no multiple of the kernel's tile: a partial tile
    b100, n100 = Transition(*[x[:, :100] for x in batches]), noises[:, :100].contiguous()
    want_p, _, want_cl, _ = ns.update_k_reference(packed, adam, b100, n100, mm_bf16=True,
                                                  **hyper)
    f4, cl4, _ = ns.fused_update_k_wmat_batches(ns.fused_init(packed, adam), b100, n100,
                                                mm_bf16=True, **hyper)
    got_p, _ = ns.fused_unpack(f4)
    assert torch.allclose(cl4, want_cl, rtol=1e-3)
    for f in ("a_w1", "a_w2", "ta_w2", "c_w1", "c_w2", "t_w2"):
        _bf16_close(getattr(got_p, f), getattr(want_p, f), 2, f)
    f0 = ns.fused_init(packed, adam)
    with pytest.raises(TypeError):      # the ring in float64
        ns.fused_update_k_wmat(f0, ring.double(), row_idx, noises, **hyper)
    with pytest.raises(TypeError):      # row indices on the CPU
        ns.fused_update_k_wmat(f0, ring, row_idx.cpu(), noises, **hyper)
    with pytest.raises(ValueError, match="built for hidden widths"):   # a width not built
        TD3Trainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                   TD3Config(hidden=(640, 640), fused_updates=True))


@pytest.mark.cuda
def test_cuda_td3_trainer_launches_its_kernel_every_live_iteration():
    _need_card()
    tr = TD3Trainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                    TD3Config(lanes=512, rollout_len=4, replay_rows=64, batch_size=1024,
                              updates_per_iter=3, warmup_rows=8, fused_updates=True))
    assert tr.device.type == "cuda"
    st = tr.init(0)
    g = tr.generator(1)
    before = _launches("td3_update")
    w0 = st.fused.w.clone()
    st, m = tr.train_iter(st, g)
    assert torch.equal(st.fused.w, w0) and _launches("td3_update") == before
    for _ in range(3):
        st, m = tr.train_iter(st, g)
    assert _launches("td3_update") == before + 3
    assert (st.fused.count, st.fused.count_a, st.n_updates) == (9, 5, 9)
    assert not torch.equal(st.fused.w, w0)
    assert all(np.isfinite(float(v)) for v in m.values())
    want = tr._ft.unpack_actor(st.fused.w, st.fused.vec, tr.obs_dim)
    assert all(torch.equal(st.actor_params[k], want[k]) for k in want)
    # a batch that is no multiple of the lanes goes through the kernel's batches mode
    tr2 = TD3Trainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                     TD3Config(lanes=512, rollout_len=4, replay_rows=64, batch_size=768,
                               updates_per_iter=2, warmup_rows=4, fused_updates=True))
    st2, m2 = tr2.train_iter(tr2.init(0), tr2.generator(2))
    assert _launches("td3_update") == before + 4
    assert np.isfinite(float(m2["critic_loss"]))


def _same_leaves(a, b):
    from space_gym_torch.utils import checkpoint

    la, lb = checkpoint._flatten(a, []), checkpoint._flatten(b, [])
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("rng", [False, "threefry", "philox"], ids=["bulk", "threefry", "philox"])
@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalDiscrete3-v0"])
def test_cuda_captured_rollout_equals_the_eager_loop_bitwise(env_id, rng):
    """The rollout captured into one CUDA graph (`capture_rollout`) against
    the same steps run eagerly (`rollout`) and against the loop of `step`,
    from one generator state: every observation, reward and flag, the state
    after, the generator after; a second replay from the same state gives
    the same; a replay counts K3's launches once each (utils/profiling.py)."""
    _need_card()
    eng = EnvEngine(get_config(env_id), in_kernel_rng=rng)
    g = eng.generator(4)
    policy = eng.random_policy()
    state, obs = eng.init(1000, g)
    state = state._replace(steps=state.steps + get_config(env_id).max_episode_steps - 4)
    g0 = g.get_state()
    captured = eng.capture_rollout(policy, 8, g)
    runs = []
    for how in ("captured", "eager", "captured"):
        g.set_state(g0)
        out = (captured(state, obs) if how == "captured"
               else eng.rollout(state, obs, policy, 8, g))
        runs.append((*out, g.get_state()))
    g.set_state(g0)
    s, o, obs_l, ts_l = state, obs, [], []
    for _ in range(8):
        obs_l.append(o)
        s, ts = eng.step(s, policy(g, o), g)
        o = ts.obs
        ts_l.append(ts)
    for st, ob, traj, gen in runs:
        assert _same_leaves(st, s) and torch.equal(ob, o) and torch.equal(gen, g.get_state())
        assert torch.equal(traj.obs, torch.stack(obs_l))
        for name in ("reward", "terminated", "truncated", "done", "final_obs"):
            assert torch.equal(getattr(traj, name), torch.stack([getattr(t, name) for t in ts_l]))
    assert runs[0][2].truncated.any()
    name = {False: "full_step", "threefry": "full_step_threefry", "philox": "full_step_philox"}
    profiling.reset_counts()
    captured(state, obs)
    assert profiling.counts() == {name[rng]: 8}


@pytest.mark.cuda
def test_cuda_capture_needs_an_explicit_generator():
    _need_card()
    eng = EnvEngine(get_config("GoalContinuous2P-v0"))
    with pytest.raises(ValueError, match="explicit generator"):
        eng.capture_rollout(eng.random_policy(), 2, None)


@pytest.mark.cuda
def test_cuda_train_iter_spans_cover_the_iteration():
    """One documented-size SAC train_iter under profiling.tracing(): the device
    extents of its rollout, insert and update lie inside the iteration's and
    cover at least 95% of it."""
    _need_card()
    tr = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                    SACConfig(lanes=2048, rollout_len=8, replay_rows=2048, batch_size=8192,
                              updates_per_iter=32, warmup_rows=32, fused_updates=True))
    st, g = tr.init(0), tr.generator(1)
    for _ in range(5):  # past the warm-up gate, the graph captured
        st, _ = tr.train_iter(st, g)
    profiling.clear_spans()
    with profiling.tracing():
        st, _ = tr.train_iter(st, g)
    torch.cuda.synchronize()
    got = {s["name"]: s for s in profiling.spans()}
    it = got["sg.train_iter"]
    parts = [got[n] for n in ("sg.rollout", "sg.insert", "sg.update")]
    assert all(it["dev_start_ns"] <= p["dev_start_ns"] <= p["dev_end_ns"] <= it["dev_end_ns"]
               for p in parts), got
    covered = sum(p["dev_end_ns"] - p["dev_start_ns"] for p in parts)
    assert covered >= 0.95 * (it["dev_end_ns"] - it["dev_start_ns"]), got
    assert "sg.graph.capture" not in got and got["sg.graph.replay"]["dev_start_ns"] is not None
    profiling.clear_spans()


@pytest.mark.cuda
def test_cuda_span_stamps_follow_the_host_clock():
    """The device stamps lie on the host clock: a span opened on an idle
    device starts there within 1 ms of its host start, and one around a
    kernel that spins 20-40 ms lasts over 10 ms on the device and ends there
    after the host has left it; under the profiler the stamps are `span_stamp` kernels."""
    from torch.profiler import ProfilerActivity, profile

    _need_card()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda._sleep(1000)  # loaded before the timed block
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profiling.tracing():
        with profiling.span("idle", device=dev):
            pass
        with profiling.span("spin", device=dev):
            torch.cuda._sleep(40_000_000)  # 20-40 ms at 1-2 GHz
    idle, spin = profiling.spans()
    assert abs(idle["dev_start_ns"] - idle["host_start_ns"]) < 1_000_000, idle
    assert spin["dev_end_ns"] - spin["dev_start_ns"] > 10_000_000, spin
    assert spin["dev_end_ns"] > spin["host_end_ns"], spin
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("traced", device=dev):
            torch.ones(4, device=dev).sum()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert sum("span_stamp" in n for n in names) >= 2 and "sg.traced" in names
    assert profiling.spans()[-1]["dev_end_ns"] > profiling.spans()[-1]["dev_start_ns"]
    profiling.clear_spans()


@pytest.mark.cuda
def test_cuda_first_capture_inside_a_span():
    """A PolicyRollout that captures its graph for the first time inside a
    traced span raises nothing and records one `sg.graph.capture`, timed on
    the device, under the call's span; the next call captures nothing."""
    from space_gym_torch.engine import PolicyRollout

    _need_card()
    eng = EnvEngine(get_config("GoalContinuous2P-v0"))
    g = eng.generator(3)
    state, obs = eng.init(256, g)
    params = {"w": torch.full((2,), 0.5, device=eng.device)}
    held = PolicyRollout(eng, lambda p, gen, o: torch.tanh(o[:, :2] * p["w"]), 4)
    before = profiling.counts().get("graph.capture", 0)
    profiling.clear_spans()
    with profiling.tracing():
        with profiling.span("outer", device=eng.device):
            state, obs, _ = held(params, state, obs, g)
        state, obs, _ = held(params, state, obs, g)
    torch.cuda.synchronize()
    got = profiling.spans()
    caps = [s for s in got if s["name"] == "sg.graph.capture"]
    assert len(caps) == 1 and caps[0]["parent"] == "sg.graph.call"
    assert caps[0]["dev_end_ns"] > caps[0]["dev_start_ns"]
    assert [s["it"] for s in got if s["name"] == "sg.graph.call"] == [1, 2]
    assert profiling.counts().get("graph.capture", 0) == before + 1
    profiling.clear_spans()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(fuse="env"), dict(fuse="physics"), dict(physics="fixed")],
                         ids=["env", "physics", "fixed"])
def test_cuda_tail_tiers_roll_out_and_train_through_step(kw):
    """On the card the tail tiers loop over `step`: a rollout equals the
    loop of `step` from one generator state, what a trainer holds takes no
    graph, and a SAC train_iter and an evaluation on such an engine run."""
    from space_gym_torch.train import Evaluator

    _need_card()
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), **kw)
    g = eng.generator(2)
    policy = eng.random_policy()
    state, obs = eng.init(64, g)
    g0 = g.get_state()
    s1, o1, traj = eng.rollout(state, obs, policy, 3, g)
    g.set_state(g0)
    s2, o2 = state, obs
    for t in range(3):
        assert torch.equal(traj.obs[t], o2)
        s2, ts = eng.step(s2, policy(g, o2), g)
        o2 = ts.obs
    assert _same_leaves(s1, s2) and torch.equal(o1, o2)
    with pytest.raises(ValueError, match="captured rollout"):
        eng.capture_rollout(policy, 3, g)
    tr = SACTrainer(eng, SACConfig(lanes=64, rollout_len=4, replay_rows=8, batch_size=128,
                                   updates_per_iter=1, warmup_rows=4))
    assert tr.collect.graph is False
    st, m = tr.train_iter(tr.init(0), tr.generator(1))
    assert st.step == 1 and all(np.isfinite(float(v)) for v in m.values())
    total, n = Evaluator(tr, 8, tr.generator(3), lanes=16)(st.actor_params)
    assert np.isfinite(total) and n >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_cuda_unfused_updates_reach_the_captured_rollout(algo):
    """The unfused SAC and TD3 updates write the actor in place, and the
    rollout's graph reads it there: three train_iters on the captured
    rollout equal three on the eager loop, every state leaf, bit for bit."""
    _need_card()
    shape = dict(lanes=512, rollout_len=4, replay_rows=16, batch_size=1024, updates_per_iter=2,
                 warmup_rows=4)
    runs = []
    for graph in (True, False):
        eng = EnvEngine(get_config("GoalContinuous2P-v0"))
        tr = (SACTrainer(eng, SACConfig(**shape)) if algo == "sac"
              else TD3Trainer(eng, TD3Config(fused_updates=False, **shape)))
        tr.collect.graph = graph
        st, g = tr.init(0), tr.generator(1)
        actor0 = {k: v.clone() for k, v in st.actor_params.items()}
        for _ in range(3):
            st, m = tr.train_iter(st, g)
        assert not _same_leaves(actor0, st.actor_params)
        runs.append(st)
    assert _same_leaves(*runs)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ppo", "dqn"])
def test_cuda_onpolicy_and_dqn_train_iters_are_finite(algo):
    """A PPO and a DQN train_iter on the card over the captured rollout,
    finite, parameters moved, and one train_iter on the eager loop from the
    same state and generator state equal bit for bit."""
    from space_gym_torch.models.dqn import DQNConfig, DQNTrainer
    from space_gym_torch.models.ppo import PPOConfig, PPOTrainer

    _need_card()
    if algo == "ppo":
        tr = PPOTrainer(EnvEngine(get_config("GoalContinuous2P-v0")),
                        PPOConfig(lanes=512, rollout_len=8, epochs=2, minibatches=4))
    else:
        tr = DQNTrainer(EnvEngine(get_config("GoalDiscrete3-v0")),
                        DQNConfig(lanes=512, rollout_len=4, replay_rows=16, batch_size=1024,
                                  updates_per_iter=2, warmup_rows=4))
    st = tr.init(0)
    g = tr.generator(1)
    k0 = next(iter(st.params))
    p0 = st.params[k0].clone()
    st, m = tr.train_iter(st, g)
    assert all(np.isfinite(float(v)) for v in m.values()) and not torch.equal(p0, st.params[k0])
    params = {k: v.clone() for k, v in st.params.items()}
    g0 = g.get_state()
    captured, _ = tr.train_iter(st._replace(params={k: v.clone() for k, v in params.items()}), g)
    g.set_state(g0)
    tr.collect.graph = False
    eager, _ = tr.train_iter(st._replace(params={k: v.clone() for k, v in params.items()}), g)
    assert _same_leaves(captured.params, eager.params) and _same_leaves(captured.env_state,
                                                                         eager.env_state)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,physics", [("sac", "fixed"), ("td3", "kernel")])
def test_cuda_cli_trains_on_the_card(tmp_path, algo, physics):
    """`python -m space_gym_torch.train` on its default device, the card: two
    train_iters and an evaluation, on a tail tier (the step loop) and on the
    captured rollout with the fused TD3 kernel."""
    from .test_torch_train_cli import TINY, run_module

    _need_card()
    args = [a for a in TINY if a not in ("--device", "cpu")]
    lines = run_module("space_gym_torch.train",
                       args + ["--algo", algo, "--physics", physics], tmp_path)
    iters = [d for d in lines if "env_steps" in d]
    assert [d["iter"] for d in iters] == [1, 2]
    assert all(np.isfinite(d["mean_reward"]) for d in iters)
    assert any("eval_mean_return" in d for d in lines)


@pytest.mark.cuda
def test_cuda_adaptive_tier_matches_cpu():
    """physics="adaptive" on the card (no kernel of its own: plain PyTorch in
    float64) against the same engine on the CPU, fed the same uniforms:
    flags equal, states within 1e-10 over three steps."""
    _need_card()
    cfg = get_config("GoalContinuous2P-v0")
    eg = EnvEngine(cfg, physics="adaptive", dtype=torch.float64)
    ec = EnvEngine(cfg, physics="adaptive", dtype=torch.float64, device="cpu")
    assert eg.device.type == "cuda"
    rng = np.random.default_rng(5)
    B = 256
    sc, _ = ec.reset(B, u=torch.as_tensor(rng.random((B, ec.n_reset_rand))))
    y = sc.y.clone()  # one lane in 8 on a crash course into planet 0: Brent's method runs
    y[1::8, 0] = sc.planets_pos[1::8, 0, 0] + cfg.planet_radii[0] + 0.02
    y[1::8, 1] = sc.planets_pos[1::8, 0, 1]
    y[1::8, 3:5] = torch.tensor([-2.0, 0.0], dtype=torch.float64)
    sc = sc._replace(y=y)
    sg = state_from_numpy(state_to_numpy(sc), device="cuda", dtype=torch.float64)
    for _ in range(3):
        act = torch.as_tensor(rng.uniform(-1, 1, (B, 2)))
        u = torch.as_tensor(rng.random((B, ec.n_step_rand)))
        sg, tg = eg.step(sg, act.cuda(), u=u.cuda())
        sc, tc = ec.step(sc, act, u=u)
        if _ == 0:
            assert eg.solve_stats["brent_lanes"] >= B // 8 and tc.terminated[1::8].all()
        for k in ("terminated", "truncated", "done"):
            assert torch.equal(getattr(tg, k).cpu(), getattr(tc, k)), k
        assert torch.allclose(sg.y.cpu(), sc.y, rtol=0, atol=1e-10)
        assert torch.allclose(tg.obs.cpu(), tc.obs, rtol=0, atol=1e-10)
    assert eg.solve_stats["n_steps"].device.type == "cuda"


@pytest.mark.cuda
def test_cuda_make_runs_golden_steps():
    """make(...) on its default device, the card: three recorded steps from
    their pre-step states at the golden tier's atol 1e-10."""
    import os

    import space_gym_torch

    _need_card()
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "GoalContinuous2P-v0.npz"))
    env = space_gym_torch.make("GoalContinuous2P-v0")
    assert env.device.type == "cuda"
    env.seed(int(g["seed"]))
    env.reset()
    env.planets_pos = g["ep0_reset_planets"]
    for t in range(3):
        env._state_vec = g["ep0_pre_states"][t].copy()
        env.goal_pos = (g["ep0_reset_goal"] if t == 0 else g["ep0_goals"][t - 1]).copy()
        env._elapsed_steps = 0
        env.step(g["ep0_actions"][t])
        np.testing.assert_allclose(env._state_vec, g["ep0_post_states"][t], rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_cuda_parity_replay_of_a_golden_file():
    """The device parity tier on the card (parity/device_replay.py): one golden
    file through the parity engine, its tensors on the card and its exact ops
    through the host library, at chip_smoke's tolerance (flags equal on every
    step, errors <= 1e-10)."""
    from space_gym_torch.parity import device_replay

    _need_card()
    st = device_replay.replay("KeplerRandomOrbits-v0", "seed7")
    assert st["flag_match"] == st["steps"] == 177
    assert max(st["max_state_err"], st["max_obs_err"], st["max_reward_err"]) <= 1e-10, st
    assert st["host_round_trips"] > 0


@pytest.mark.cuda
def test_cuda_vector_env_launches_k3_once_a_step():
    import space_gym_torch

    _need_card()
    venv = space_gym_torch.VectorEnv("GoalContinuous2P-v0", num_envs=4096, physics="kernel")
    assert venv.engine.device.type == "cuda" and venv.engine.tier == "full"
    venv.reset()
    profiling.reset_counts()
    rng = np.random.default_rng(0)
    for _ in range(4):
        obs, rewards, dones, infos = venv.step(rng.uniform(-1, 1, (4096, 2)).astype(np.float32))
    assert _launches("full_step") == 4
    assert obs.shape == (4096, venv.config.obs_dim) and np.isfinite(obs).all()
    assert len(infos) == 4096 and all(("terminal_observation" in i) == d
                                      for i, d in zip(infos, dones))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["threefry", "philox"])
def test_cuda_keyed_full_step_at_a_lane_offset(mode):
    """K3-tf and K3-hw at lane0 (a rank's block of lanes split over ranks):
    every output bit for bit the same lanes of an offset-0 launch of the
    whole width, and within the usual tolerances of the plain twin at the
    same offset; the generator's block at the offset bit for bit its plain
    version's."""
    _need_card()
    cfg = get_config("GoalContinuous2P-v0")
    full = FullStep(cfg, 1, 8, "bs3", in_kernel_rng=mode)
    B, lane0 = 4099, 4097
    rows = [t.cuda() for t in pattern_operands(cfg, lane0 + B, seed=9)]
    key = key_words([0x5EED0003, 0x0000C0DE], "cuda")
    rows[6] = key
    wide = full.step_rows(*rows)
    block = [t[:, lane0:].contiguous() if t.dim() == 2 else t for t in rows]
    got = full.step_rows(*block, lane0=lane0)
    for w, g in zip(wide, got):
        assert torch.equal(w[:, lane0:], g)
    assert torch.equal(full.kernel_uniforms(key, B, lane0).cpu(),
                       full.plain_uniforms(key.cpu(), B, lane0))
    want = full.step_rows(*[t.cpu() for t in block], lane0=lane0)
    assert torch.equal(got[-1].cpu(), want[-1]) and torch.equal(got[-2].cpu(), want[-2])
    for i, (g, w) in enumerate(zip(got[:-2], want[:-2])):
        tol = TOL_REWARD if i == 7 else TOL_STATE
        assert torch.allclose(g.cpu(), w, rtol=0, atol=tol, equal_nan=True), i


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True], ids=["k4", "k5"])
def test_cuda_world_one_mesh_equals_the_unsharded_trainer(fold):
    """A fused SAC trainer under a one-rank mesh (no process group) on the
    card, its state made and placed as a sharded run does, equals the
    unsharded trainer after three train_iters, every leaf bit for bit: the
    gathered ring of the sampled rows gives the kernel what the ring and
    the row indices give it."""
    _need_card()
    from space_gym_torch.parallel import make_mesh, place, trainer_state_shardings
    from space_gym_torch.parallel.mesh import tree_map

    cfg = SACConfig(lanes=256, rollout_len=4, replay_rows=64, batch_size=1024,
                    updates_per_iter=2, warmup_rows=4, fused_updates=True, fused_fold=fold)
    states = []
    for mesh in (None, make_mesh()):
        tr = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0"), mesh=mesh), cfg)
        st = tr.init(0)
        if mesh is not None:
            st = place(st, trainer_state_shardings(st, mesh), mesh)
        g = tr.generator(1)
        for _ in range(3):
            st, _ = tr.train_iter(st, g)
        out = []
        tree_map(lambda x: out.append(x.cpu() if isinstance(x, torch.Tensor) else x), st)
        states.append(out)
    assert states[0][-1] == states[1][-1] and len(states[0]) == len(states[1])
    for a, b in zip(*states):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
