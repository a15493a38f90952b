"""The port's fused SAC learner (space_gym_torch/models/fused_sac.py) against
space_gym_tpu/models/fused_sac.py on the CPU.

Inputs come from a numpy seed and go to both packages.  The JAX side runs as
tests/test_fused_sac.py runs it: `update_k_reference`, and the Pallas kernels
with `interpret=True` in both schedules (`fold` False and True) and both data
modes (gathered minibatches, and rows of the replay ring).  The port's entry
points get CPU tensors, so they run its `update_k_reference`, the plain
version of its CUDA kernels.

Tolerances are those of tests/test_fused_sac.py:244-253 (float32 sums in
another order, through Adam's division by sqrt(v)): parameters rtol 2e-4 /
atol 2e-5, Adam m rtol 2e-3 / atol 2e-5, critic loss rtol 1e-4, actor loss
rtol 1e-3.  Packing is exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.models import SACConfig as JaxSACConfig
from space_gym_tpu.models import SACTrainer as JaxSACTrainer
from space_gym_tpu.models import fused_sac as jfs
from space_gym_tpu.models.replay import Transition as JaxTransition
from space_gym_tpu.models.replay import pack_slab as jax_pack_slab

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import SACConfig, SACTrainer, convert, fused_sac
from space_gym_torch.models.replay import Transition
from space_gym_torch.models.sac import AdamState
from space_gym_torch.utils import profiling

from .test_fused_sac import flax_update_with_noise
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"
HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, target_entropy=-2.0)
FIELDS = fused_sac.PackedParams._fields


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def jax_engine():
    """The learners read the engine's shapes and never step it: one substep
    and 8 refinements make its constructor's trace of the step shorter."""
    return JaxEngine(space_gym_tpu.get_config(ENV), substeps=1, refine_iters=8)


@functools.cache
def jax_learner(hidden):
    """The JAX trainer of a width, built once per module: its tracing is the
    cost; a fresh state of another seed costs milliseconds."""
    cfg = JaxSACConfig(lanes=16, rollout_len=4, replay_rows=8, batch_size=64,
                       updates_per_iter=1, warmup_rows=4, hidden=hidden)
    return JaxSACTrainer(jax_engine(), cfg)


def jax_trainer(hidden=(256, 256), seed=0):
    """The JAX trainer and a fresh state from `seed`."""
    tr = jax_learner(hidden)
    return tr, tr.init(jax.random.key(seed))


def packed_pair(h=256, seed=0):
    """The same fresh learner as PackedParams/PackedAdam of both packages."""
    tr, st = jax_trainer((h, h), seed)
    jns, tns = jfs.build(h), fused_sac.build(h)
    jp = jns.pack_params(st.actor_params, st.critic_params, st.target_critic_params,
                         st.log_alpha)
    tp = tns.pack_params(convert.params_from_flax(np_tree(st.actor_params), "actor"),
                         convert.params_from_flax(np_tree(st.critic_params), "critic"),
                         convert.params_from_flax(np_tree(st.target_critic_params), "critic"),
                         torch.as_tensor(np.asarray(st.log_alpha)))
    return tr.obs_dim, jns, tns, jp, jns.adam_init(jp), tp, tns.adam_init(tp)


def rand_batches(rng, lead, obs_dim):
    return dict(
        obs=rng.standard_normal(lead + (obs_dim,)).astype(np.float32),
        action=rng.uniform(-1, 1, lead + (2,)).astype(np.float32),
        reward=rng.standard_normal(lead).astype(np.float32),
        next_obs=rng.standard_normal(lead + (obs_dim,)).astype(np.float32),
        discount=(rng.random(lead) > 0.1).astype(np.float32),
    )


def to_jax(b):
    return JaxTransition(**{k: jnp.asarray(v) for k, v in b.items()})


def to_torch(b):
    return Transition(**{k: torch.as_tensor(v) for k, v in b.items()})


def assert_close(got_p, got_ad, got_cl, got_al, want_p, want_ad, want_cl, want_al, moments=True):
    np.testing.assert_allclose(got_cl.numpy(), np.asarray(want_cl), rtol=1e-4, atol=1e-5,
                               err_msg="critic loss")
    np.testing.assert_allclose(got_al.numpy(), np.asarray(want_al), rtol=1e-3, atol=1e-5,
                               err_msg="actor loss")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got_p, f).numpy(), np.asarray(getattr(want_p, f)),
                                   rtol=2e-4, atol=2e-5, err_msg=f"param {f}")
        if moments:
            np.testing.assert_allclose(getattr(got_ad.m, f).numpy(),
                                       np.asarray(getattr(want_ad.m, f)),
                                       rtol=2e-3, atol=2e-5, err_msg=f"adam m {f}")
    assert got_ad.count == int(want_ad.count)


@pytest.mark.parametrize("h", [256, 512])
def test_packing_equals_jax_exactly(h):
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(h, seed=4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    assert (tns.WROWS, tns.VROWS, tns.R_AWH) == (jns.WROWS, jns.VROWS, jns.R_AWH)
    assert (tns.R_CW1, tns.R_TW1, tns.V_MISC, tns.M_LA) == (jns.R_CW1, jns.R_TW1, jns.V_MISC,
                                                            jns.M_LA)
    jw, jv = jns.pack_wmat(jp)
    tw, tv = tns.pack_wmat(tp)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # inverses: wmat -> packed -> parameter dicts
    back = tns.unpack_wmat(tw, tv)
    jback = jns.unpack_wmat(jw, jv)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(jback, f)))
    jf, tf = jns.fused_init(jp, jad), tns.fused_init(tp, tad)
    for f in ("w", "vec", "mw", "mvec", "vw", "vvec"):
        np.testing.assert_array_equal(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)))
    p2, ad2 = tns.fused_unpack(tf)
    assert ad2.count == 0 and all(torch.equal(a, b) for a, b in zip(p2, tp))
    tr, st = jax_trainer((h, h), seed=4)
    actor, critic, target, la = tns.unpack_params(tp, obs_dim)
    jactor, jcritic, jtarget, jla = jns.unpack_params(jp, st.actor_params, st.critic_params)
    for mine, theirs, kind in ((actor, jactor, "actor"), (critic, jcritic, "critic"),
                               (target, jtarget, "critic")):
        want = convert.params_from_flax(np_tree(theirs), kind)
        assert set(mine) == set(want)
        for k in mine:
            np.testing.assert_array_equal(mine[k].numpy(), want[k].numpy(), err_msg=k)
    assert float(la) == float(jla)
    ua = tns.unpack_actor(tw, tv, obs_dim)
    assert all(torch.equal(ua[k], actor[k]) for k in actor)


def test_width_must_be_a_multiple_of_128():
    with pytest.raises(ValueError):
        fused_sac.build(192)
    assert fused_sac.build(256).WROWS == fused_sac.WROWS == 1928
    assert fused_sac.build(512).WROWS == 3208
    eng = EnvEngine(get_config(ENV), device="cpu")
    with pytest.raises(ValueError):
        SACTrainer(eng, SACConfig(hidden=(192, 192), fused_updates=True))
    with pytest.raises(ValueError):
        SACTrainer(eng, SACConfig(hidden=(256, 512), fused_updates=True))


@pytest.mark.parametrize("alpha_floor", [0.0, 0.2])
@pytest.mark.parametrize("h,K,B", [(256, 2, 64), (512, 1, 32)])
def test_reference_matches_jax_reference(h, K, B, alpha_floor):
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(h, seed=1)
    rng = np.random.default_rng(h + K)
    b = rand_batches(rng, (K, B), obs_dim)
    noises = rng.standard_normal((K, B, 2, 2)).astype(np.float32)
    want = jns.update_k_reference(jp, jad, to_jax(b), jnp.asarray(noises), obs_dim,
                                  alpha_floor=alpha_floor, **HYPER)
    got = tns.update_k_reference(tp, tad, to_torch(b), torch.as_tensor(noises), obs_dim,
                                 alpha_floor=alpha_floor, **HYPER)
    assert_close(*got, *want)
    if alpha_floor:  # init alpha 0.1 is under the floor: the clamp decides log_alpha
        assert float(got[0].log_alpha) == pytest.approx(np.log(alpha_floor), abs=1e-6)


@pytest.mark.parametrize("fold", [False, True], ids=["grid_k2t", "fold_k"])
@pytest.mark.parametrize("h,K,B", [(256, 2, 64), (512, 1, 32)])
def test_batches_entry_matches_interpret_kernel(h, K, B, fold):
    """`fused_update_k` of the port (CPU tensors) against the Pallas kernel in
    interpret mode: K=2 with two batch tiles at H=256, one update at H=512;
    parameters, moments and losses."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(h, seed=1)
    rng = np.random.default_rng(9)
    b = rand_batches(rng, (K, B), obs_dim)
    noises = rng.standard_normal((K, B, 2, 2)).astype(np.float32)
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["target_entropy"])
    want = jns.fused_update_k(jp, jad, to_jax(b), jnp.asarray(noises), *args, block=32,
                              interpret=True, mm_bf16=False, fold=fold)
    launches = profiling.counts()
    got = tns.fused_update_k(tp, tad, to_torch(b), torch.as_tensor(noises), *args, block=32,
                             mm_bf16=False, fold=fold)
    assert profiling.counts() == launches, "CPU tensors take the plain version"
    assert_close(*got, *want)


@pytest.mark.parametrize("fold", [False, True], ids=["grid_k2t", "fold_k"])
def test_ring_entry_matches_interpret_kernel(fold):
    """`fused_update_k_from_replay`: rows 8, lanes 64, B = 128 (two replay rows
    per minibatch), a repeated row index."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=3)
    rng = np.random.default_rng(21)
    K, R, L = 2, 8, 64
    B = 2 * L
    ring = np.asarray(jax_pack_slab(to_jax(rand_batches(rng, (R, L), obs_dim)), obs_dim, 2))
    row_idx = np.array([3, 6, 3, 0], np.int32)
    noises = rng.standard_normal((K, B, 2, 2)).astype(np.float32)
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["target_entropy"])
    want = jns.fused_update_k_from_replay(jp, jad, jnp.asarray(ring), jnp.asarray(row_idx),
                                          jnp.asarray(noises), *args, block=32, interpret=True,
                                          mm_bf16=False, fold=fold)
    got = tns.fused_update_k_from_replay(tp, tad, torch.as_tensor(ring.copy()),
                                         torch.as_tensor(row_idx), torch.as_tensor(noises),
                                         *args, block=32, mm_bf16=False, fold=fold)
    assert_close(*got, *want, moments=False)
    with pytest.raises(ValueError):
        tns.fused_update_k_from_replay(tp, tad, torch.as_tensor(ring.copy()),
                                       torch.as_tensor(row_idx[:3]), torch.as_tensor(noises),
                                       *args, block=32)
    with pytest.raises(ValueError):
        tns.fused_update_k_from_replay(tp, tad, torch.as_tensor(ring.copy())[:, :-8],
                                       torch.as_tensor(row_idx), torch.as_tensor(noises), *args)


def test_two_sequential_calls_track_the_interpret_kernel():
    """Two calls of K=2 each, four updates in all: parameters AND moments; the
    padded first-layer rows stay zero."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=5)
    rng = np.random.default_rng(17)
    K, B = 2, 64
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["target_entropy"])
    for _ in range(2):
        b = rand_batches(rng, (K, B), obs_dim)
        noises = rng.standard_normal((K, B, 2, 2)).astype(np.float32)
        jp, jad, _, _ = jns.fused_update_k(jp, jad, to_jax(b), jnp.asarray(noises), *args,
                                           block=32, interpret=True, mm_bf16=False)
        tp, tad, _, _ = tns.fused_update_k(tp, tad, to_torch(b), torch.as_tensor(noises), *args,
                                           block=32, mm_bf16=False)
    assert tad.count == int(jad.count) == 4
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=3e-4, atol=3e-5, err_msg=f"param {f}")
        np.testing.assert_allclose(getattr(tad.m, f).numpy(), np.asarray(getattr(jad.m, f)),
                                   rtol=3e-4, atol=3e-5, err_msg=f"adam.m {f}")
    for f in ("a_w1", "c_w1", "t_w1"):
        pad = getattr(tp, f)[..., obs_dim + (0 if f == "a_w1" else 2):, :]
        assert (pad == 0).all(), f


def test_bf16_mode_is_close_to_the_interpret_kernel_and_the_f32_reference():
    """mm_bf16=True of the port's plain version against the Pallas kernel's
    bf16 mode and against the float32 reference, with the bounds of
    tests/test_fused_sac.py:257-285: one Adam step moves a weight by about lr,
    and bf16 can flip the sign of a near-zero gradient, so any element may be
    off by 2.5 lr while 99% agree to 1e-4."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=2)
    rng = np.random.default_rng(11)
    B = 64
    b = rand_batches(rng, (1, B), obs_dim)
    noises = rng.standard_normal((1, B, 2, 2)).astype(np.float32)
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["target_entropy"])
    p_ref, _, cl_ref, _ = jns.update_k_reference(jp, jad, to_jax(b), jnp.asarray(noises), *args)
    p_k, _, cl_k, _ = jns.fused_update_k(jp, jad, to_jax(b), jnp.asarray(noises), *args, block=32,
                                         interpret=True, mm_bf16=True)
    got, _, cl, _ = tns.fused_update_k(tp, tad, to_torch(b), torch.as_tensor(noises), *args,
                                       block=32, mm_bf16=True)
    f32, _, _, _ = tns.fused_update_k(tp, tad, to_torch(b), torch.as_tensor(noises), *args,
                                      block=32, mm_bf16=False)
    assert not torch.equal(got.c_w2, f32.c_w2), "the option rounds something"
    lr = HYPER["lr"]
    for want_p, want_cl, rtol in ((p_k, cl_k, 1e-3), (p_ref, cl_ref, 0.05)):
        np.testing.assert_allclose(float(cl[0]), float(want_cl[0]), rtol=rtol)
        for f in ("a_w1", "c_w1", "c_w2", "log_alpha"):
            d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want_p, f)))
            assert d.max() <= 2.5 * lr, (f, d.max())
            assert (d <= 1e-4).mean() > 0.99, (f, (d <= 1e-4).mean())


def test_update_once_matches_flax_and_optax():
    """The port's unfused `_update_once` (torch.autograd and its own Adam)
    against the flax/optax update with the same batch and normals, over two
    sequential updates (tests/test_fused_sac.py:48-138)."""
    jtr, jst = jax_trainer(seed=0)
    obs_dim = jtr.obs_dim
    eng = EnvEngine(get_config(ENV), device="cpu")
    ttr = SACTrainer(eng, SACConfig(lanes=16, rollout_len=4, replay_rows=8, batch_size=64,
                                    updates_per_iter=1, warmup_rows=4))
    assert ttr.obs_dim == obs_dim and ttr.target_entropy == jtr.target_entropy
    tst = ttr.init(0)
    tst = tst._replace(
        actor_params=convert.params_from_flax(np_tree(jst.actor_params), "actor"),
        critic_params=convert.params_from_flax(np_tree(jst.critic_params), "critic"),
        target_critic_params=convert.params_from_flax(np_tree(jst.target_critic_params),
                                                      "critic"),
        log_alpha=torch.tensor(np.asarray(jst.log_alpha)),  # owned: updated in place
        actor_opt=convert.adam_from_optax(np_tree(jst.actor_opt), "actor"),
        critic_opt=convert.adam_from_optax(np_tree(jst.critic_opt), "critic"),
        alpha_opt=convert.adam_from_optax(np_tree(jst.alpha_opt), None),
    )
    rng = np.random.default_rng(7)
    for _ in range(2):
        b = rand_batches(rng, (64,), obs_dim)
        noise = rng.standard_normal((64, 2, 2)).astype(np.float32)
        jst, cl_j, al_j = flax_update_with_noise(jtr, jst, to_jax(b), jnp.asarray(noise),
                                                 jtr.cfg.lr)
        tst, m = ttr._update_once(tst, batch=to_torch(b), noise=torch.as_tensor(noise))
        np.testing.assert_allclose(float(m["critic_loss"]), float(cl_j), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(m["actor_loss"]), float(al_j), rtol=2e-4, atol=1e-5)
    for got, want, kind in ((tst.actor_params, jst.actor_params, "actor"),
                            (tst.critic_params, jst.critic_params, "critic"),
                            (tst.target_critic_params, jst.target_critic_params, "critic")):
        want = convert.params_from_flax(np_tree(want), kind)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=k)
    np.testing.assert_allclose(float(tst.log_alpha), float(jst.log_alpha), atol=1e-6)
    assert tst.critic_opt.count == int(jst.critic_opt[0].count) == 2
    mu = convert.adam_from_optax(np_tree(jst.critic_opt), "critic").mu
    assert isinstance(tst.critic_opt, AdamState)
    for k in mu:
        np.testing.assert_allclose(tst.critic_opt.mu[k].numpy(), mu[k].numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=k)
