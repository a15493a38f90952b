"""The port's fused TD3 learner (space_gym_torch/models/fused_td3.py) against
space_gym_tpu/models/fused_td3.py on the CPU.

Inputs come from a numpy seed and go to both packages.  The JAX side runs as
tests/test_fused_td3.py runs it: `update_k_reference`, and the Pallas kernel
with `interpret=True` in both data modes (gathered minibatches, and rows of
the replay ring).  The port's entry points get CPU tensors, so they run its
`update_k_reference`, the plain version of its CUDA kernel K6.

Tolerances are those of tests/test_fused_td3.py:160-170 (float32 sums in
another order, through Adam's division by sqrt(v)): parameters rtol 2e-4 /
atol 2e-5, Adam m rtol 2e-3 / atol 2e-5, critic loss rtol 1e-4, actor loss
rtol 1e-3; over two calls in a row rtol 3e-4 / atol 3e-5 (:321-324).  Packing
is exact, and so are the two step counts.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.models import TD3Config as JaxTD3Config
from space_gym_tpu.models import TD3Trainer as JaxTD3Trainer
from space_gym_tpu.models import fused_td3 as jft
from space_gym_tpu.models.replay import Transition as JaxTransition
from space_gym_tpu.models.replay import pack_slab as jax_pack_slab

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import TD3Config, TD3Trainer, convert, fused_td3
from space_gym_torch.models.replay import Transition
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"
HYPER = dict(gamma=0.99, tau=0.005, lr=3e-4, smooth_std=0.2, smooth_clip=0.5)
FIELDS = fused_td3.PackedParams._fields


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
    cfg = JaxTD3Config(lanes=16, rollout_len=4, replay_rows=8, batch_size=64,
                       updates_per_iter=1, warmup_rows=4, hidden=hidden)
    return JaxTD3Trainer(jax_engine(), cfg)


def jax_trainer(hidden=(256, 256), seed=0):
    """The JAX trainer and a fresh state from `seed`."""
    tr = jax_learner(hidden)
    return tr, tr.init(jax.random.key(seed))


def packed_pair(h=256, seed=0):
    """The same learner as PackedParams/PackedAdam of both packages.  A fresh
    TD3 learner's targets equal its online networks, so the targets come from
    a second draw: a mix-up of the two would show."""
    tr, st = jax_trainer((h, h), seed)
    _, st_t = jax_trainer((h, h), seed + 100)
    jns, tns = jft.build(h), fused_td3.build(h)
    trees = (st.actor_params, st_t.actor_params, st.critic_params, st_t.critic_params)
    jp = jns.pack_params(*trees)
    tp = tns.pack_params(*[convert.params_from_flax(np_tree(t), kind) for t, kind in
                           zip(trees, ("det_actor", "det_actor", "critic", "critic"))])
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


def assert_close(got_p, got_ad, got_cl, got_al, want_p, want_ad, want_cl, want_al, moments=True,
                 rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(got_cl.numpy(), np.asarray(want_cl), rtol=1e-4, atol=1e-5,
                               err_msg="critic loss")
    np.testing.assert_allclose(got_al.numpy(), np.asarray(want_al), rtol=1e-3, atol=1e-5,
                               err_msg="actor loss")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got_p, f).numpy(), np.asarray(getattr(want_p, f)),
                                   rtol=rtol, atol=atol, err_msg=f"param {f}")
        if moments:
            np.testing.assert_allclose(getattr(got_ad.m, f).numpy(),
                                       np.asarray(getattr(want_ad.m, f)),
                                       rtol=2e-3, atol=2e-5, err_msg=f"adam m {f}")
    assert got_ad.count == int(want_ad.count)
    assert got_ad.count_a == int(want_ad.count_a)


@pytest.mark.parametrize("h", [256, 512])
def test_packing_equals_jax_exactly(h):
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(h, seed=4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    assert FIELDS == jft.PackedParams._fields and len(FIELDS) == 24
    for name in ("WROWS", "VROWS", "R_AW1", "R_AW2", "R_TAW1", "R_TAW2", "R_CW1", "R_TW1", "R_AWH",
                 "R_TAWH", "V_AB1", "V_AB2", "V_TAB1", "V_TAB2", "V_CB1", "V_CB2", "V_TB1", "V_TB2",
                 "V_CW3", "V_TW3", "V_MISC", "M_ABH", "M_TABH", "M_CB3", "M_TB3"):
        assert getattr(tns, name) == getattr(jns, name), name
    assert tns.WROWS == {256: 2312, 512: 3848}[h] and tns.VROWS == 24
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
    assert (ad2.count, ad2.count_a) == (0, 0) and all(torch.equal(a, b) for a, b in zip(p2, tp))
    tr, st = jax_trainer((h, h), seed=4)
    mine = tns.unpack_params(tp, obs_dim)
    theirs = jns.unpack_params(jp, st.actor_params, st.critic_params)
    for got, tree, kind in zip(mine, theirs, ("det_actor", "det_actor", "critic", "critic")):
        want = convert.params_from_flax(np_tree(tree), kind)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    ua = tns.unpack_actor(tw, tv, obs_dim)
    assert all(torch.equal(ua[k], mine[0][k]) for k in mine[0])
    ja = convert.params_from_flax(np_tree(jns.unpack_actor(jw, jv, obs_dim, 2)), "det_actor")
    assert all(np.array_equal(ua[k].numpy(), ja[k].numpy()) for k in ja)
    # the actor's parameters are views: an in-place update of w shows in them
    tw[tns.R_AW2] += 1.0
    assert torch.equal(ua["mlp.layers.1.kernel"][0], tw[tns.R_AW2])


def test_width_and_shape_guards():
    with pytest.raises(ValueError):
        fused_td3.build(192)
    assert fused_td3.build(256).WROWS == fused_td3.WROWS == 2312
    eng = EnvEngine(get_config(ENV), device="cpu")
    with pytest.raises(ValueError):
        TD3Trainer(eng, TD3Config(hidden=(192, 192), fused_updates=True))
    with pytest.raises(ValueError):
        TD3Trainer(eng, TD3Config(hidden=(256, 512), fused_updates=True))
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=1)
    rng = np.random.default_rng(0)
    b = to_torch(rand_batches(rng, (2, 64), obs_dim))
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"])
    with pytest.raises(ValueError):   # SAC's (K, B, 2, 2) normals
        tns.fused_update_k(tp, tad, b, torch.zeros((2, 64, 2, 2)), *args)
    with pytest.raises(ValueError):   # a block that does not divide the batch
        tns.fused_update_k(tp, tad, b, torch.zeros((2, 64, 2)), *args, block=48)
    with pytest.raises(ValueError):
        tns.fused_update_k(tp, tad, b, torch.zeros((2, 64, 2)), *args, policy_delay=0)


@pytest.mark.parametrize("count,k,delay", [(c, k, d) for d in (1, 2, 3) for c in (0, 1, 3)
                                          for k in (1, 4)])
def test_applied_steps_counts_the_delayed_updates(count, k, delay):
    """The actor's count after a launch: the JAX formula (fused_td3.py:783-785)
    and a plain count of the multiples of the delay."""
    want = sum(1 for n in range(count, count + k) if n % delay == 0)
    assert fused_td3.applied_steps(count, k, delay) == want
    first = (-count) % delay
    assert want == max(0, (k - first + delay - 1) // delay)


@pytest.mark.parametrize("delay", [2, 3])
@pytest.mark.parametrize("h,K,B", [(256, 3, 64), (512, 1, 32)])
def test_reference_matches_jax_reference_over_two_calls(h, K, B, delay):
    """Two calls in a row: with K = 3 the second starts from an odd count, and
    with K = 1 the first is a delayed update and the second is not."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(h, seed=1)
    rng = np.random.default_rng(h + K + delay)
    hyper = dict(HYPER, policy_delay=delay)
    for call in range(2):
        b = rand_batches(rng, (K, B), obs_dim)
        noises = rng.standard_normal((K, B, 2)).astype(np.float32)
        jp, jad, jcl, jal = jns.update_k_reference(jp, jad, to_jax(b), jnp.asarray(noises),
                                                   obs_dim, **hyper)
        tp, tad, tcl, tal = tns.update_k_reference(tp, tad, to_torch(b), torch.as_tensor(noises),
                                                   obs_dim, **hyper)
        tol = dict(rtol=3e-4, atol=3e-5) if call else {}
        assert_close(tp, tad, tcl, tal, jp, jad, jcl, jal, **tol)
    assert tad.count == 2 * K
    assert tad.count_a == fused_td3.applied_steps(0, 2 * K, delay)
    for f in fused_td3.TACTOR_FIELDS + fused_td3.TARGET_FIELDS:   # targets take no Adam step
        assert (getattr(tad.m, f) == 0).all() and (getattr(tad.v, f) == 0).all()


def test_batches_entry_matches_interpret_kernel():
    """`fused_update_k` of the port (CPU tensors) against the Pallas kernel in
    interpret mode as tests/test_fused_td3.py runs it: K=4 (two delayed and two
    other updates), B=64 in two tiles; parameters, moments, losses, counts."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=1)
    rng = np.random.default_rng(9)
    K, B = 4, 64
    b = rand_batches(rng, (K, B), obs_dim)
    noises = rng.standard_normal((K, B, 2)).astype(np.float32)
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["smooth_std"],
            HYPER["smooth_clip"], 2)
    want = jns.fused_update_k(jp, jad, to_jax(b), jnp.asarray(noises), *args, block=32,
                              interpret=True, mm_bf16=False)
    launches = dict(fused_td3.LAUNCHES)
    got = tns.fused_update_k(tp, tad, to_torch(b), torch.as_tensor(noises), *args, block=32,
                             mm_bf16=False)
    assert fused_td3.LAUNCHES == launches, "CPU tensors take the plain version"
    assert_close(*got, *want)
    assert (got[1].count, got[1].count_a) == (4, 2)
    for f in ("a_w1", "ta_w1", "c_w1", "t_w1"):   # the padded first-layer rows stay zero
        pad = getattr(got[0], f)[..., obs_dim + (0 if "a_" in f else 2):, :]
        assert (pad == 0).all(), f


def test_ring_entry_matches_interpret_kernel():
    """`fused_update_k_from_replay`: rows 8, lanes 64, B = 128 (two replay rows
    per minibatch), a repeated row index, policy_delay 3."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=3)
    rng = np.random.default_rng(21)
    K, R, L = 2, 8, 64
    B = 2 * L
    ring = np.asarray(jax_pack_slab(to_jax(rand_batches(rng, (R, L), obs_dim)), obs_dim, 2))
    row_idx = np.array([3, 6, 3, 0], np.int32)
    noises = rng.standard_normal((K, B, 2)).astype(np.float32)
    kw = dict(HYPER, obs_dim=obs_dim, policy_delay=3)
    jf2, jcl, jal = jns.fused_update_k_wmat(
        jns.fused_init(jp, jad), jnp.asarray(ring), jnp.asarray(row_idx), jnp.asarray(noises),
        block=32, interpret=True, mm_bf16=False, **kw)
    want = (*jns.fused_unpack(jf2), jcl, jal)
    got = tns.fused_update_k_from_replay(tp, tad, torch.as_tensor(ring.copy()),
                                         torch.as_tensor(row_idx), torch.as_tensor(noises),
                                         block=32, mm_bf16=False, **kw)
    assert_close(*got, *want, moments=False)
    assert (got[1].count, got[1].count_a) == (2, 1)
    with pytest.raises(ValueError):
        tns.fused_update_k_from_replay(tp, tad, torch.as_tensor(ring.copy()),
                                       torch.as_tensor(row_idx[:3]), torch.as_tensor(noises),
                                       block=32, **kw)
    with pytest.raises(ValueError):
        tns.fused_update_k_from_replay(tp, tad, torch.as_tensor(ring.copy())[:, :-8],
                                       torch.as_tensor(row_idx), torch.as_tensor(noises), **kw)


def test_bf16_mode_is_close_to_the_interpret_kernel_and_the_f32_reference():
    """mm_bf16=True of the port's plain version against the Pallas kernel's
    bf16 mode and against the float32 reference, with the bounds of
    tests/test_fused_td3.py:250-285: one Adam step moves a weight by about lr,
    and bf16 can flip the sign of a near-zero gradient, so any element may be
    off by 2 lr per update while 99% of all elements agree to 1e-4."""
    obs_dim, jns, tns, jp, jad, tp, tad = packed_pair(256, seed=2)
    rng = np.random.default_rng(11)
    K, B = 2, 64
    b = rand_batches(rng, (K, B), obs_dim)
    noises = rng.standard_normal((K, B, 2)).astype(np.float32)
    args = (obs_dim, HYPER["gamma"], HYPER["tau"], HYPER["lr"], HYPER["smooth_std"],
            HYPER["smooth_clip"], 2)
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
        np.testing.assert_allclose(cl.numpy(), np.asarray(want_cl), rtol=rtol)
        all_d = []
        for f in FIELDS:
            d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want_p, f)))
            assert d.max() <= 2.0 * K * lr, (f, d.max())
            all_d.append(d.ravel())
        all_d = np.concatenate(all_d)
        assert (all_d <= 1e-4).mean() > 0.99, (all_d <= 1e-4).mean()
