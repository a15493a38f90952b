"""The port's TD3 trainer as a whole (space_gym_torch/models/td3.py) on the
CPU, sized as tests/test_fused_td3.py::test_trainer_fused_smoke: lanes 16,
rollout 4, replay rows 16, batch 32, K = 2 or 3, warm-up 4 or 8 rows.

The trainer's own run is checked for what must hold whatever the draws: the
warm-up gate, finite losses, the ring's cursor, the two step counts.  The
deterministic actor is held to the flax one on converted parameters (atol
1e-5), `_update_once` to the JAX trainer's update on the same batch and
smoothing normals over four updates (delayed and not), and `_update_fused` to
the JAX trainer's with the same replay contents, row indices and normals: the
JAX trainer draws them from a key, and the same draws are injected into the
port.  Tolerances as in tests/test_torch_fused_td3.py.
"""
import functools

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.models import TD3Config as JaxTD3Config
from space_gym_tpu.models import TD3Trainer as JaxTD3Trainer
from space_gym_tpu.models import networks as jnets
from space_gym_tpu.models import replay as jreplay

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import TD3Config, TD3Trainer, convert, fused_td3, networks
from space_gym_torch.models import replay as treplay
from space_gym_torch.models.sac import AdamState

from .test_fused_td3 import flax_update_with_noise
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"


@functools.cache
def jax_engine():
    """The JAX engine of ENV, built once per module (it holds no state).  The
    learners read its shapes and never step it: one substep and 8
    refinements make its constructor's trace of the step shorter."""
    return JaxEngine(space_gym_tpu.get_config(ENV), substeps=1, refine_iters=8)


SMALL = dict(lanes=16, rollout_len=4, replay_rows=16, batch_size=32, updates_per_iter=2,
             fused_block=32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def trainer(**kw):
    eng = EnvEngine(get_config(ENV), device="cpu")
    return TD3Trainer(eng, TD3Config(**{**SMALL, **kw}))


def learner_leaves(st):
    if st.fused is not None:
        return [t.clone() for t in st.fused[:6]]
    return [v.clone() for d in (st.actor_params, st.target_actor_params, st.critic_params,
                                st.target_critic_params) for v in d.values()]


@pytest.mark.parametrize("hidden", [(256, 256), (64, 32)])
def test_deterministic_actor_matches_flax(hidden):
    jactor = jnets.DeterministicActor(2, hidden)
    ap = jactor.init(jax.random.key(0), jnp.zeros((1, 13), jnp.float32))
    ap = jax.tree.map(lambda x: x + 0.01 if x.ndim == 1 else x, ap)   # biases off zero
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((32, 13)).astype(np.float32)
    tactor = networks.DeterministicActor(13, 2, hidden)
    tap = convert.params_from_flax(np_tree(ap), "det_actor")
    assert set(tap) == set(tactor.state_dict())
    assert all(v.shape == tap[k].shape for k, v in tactor.state_dict().items())
    got = functional_call(tactor, tap, (torch.as_tensor(obs),))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jactor.apply(ap, jnp.asarray(obs))),
                               rtol=0, atol=1e-5)
    assert (got.abs() <= 1).all()
    back = convert.params_to_flax(tap, "det_actor")
    assert jax.tree.structure(back) == jax.tree.structure(np_tree(ap))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree(ap))):
        np.testing.assert_array_equal(a, b)
    g = torch.Generator().manual_seed(0)
    fresh = networks.DeterministicActor(13, 2, hidden, generator=g).state_dict()
    assert all((v == 0).all() for k, v in fresh.items() if k.endswith("bias"))


def test_convert_carries_the_td3_tuples_with_both_counts():
    from space_gym_tpu.models import fused_td3 as jft

    jtr = JaxTD3Trainer(jax_engine(), JaxTD3Config(**SMALL))
    st = jtr.init(jax.random.key(0))
    packed = jft.pack_params(st.actor_params, st.target_actor_params, st.critic_params,
                             st.target_critic_params)
    adam = jft.adam_init(packed)._replace(count=jnp.asarray(5, jnp.int32),
                                          count_a=jnp.asarray(3, jnp.int32))
    tp = convert.packed_from_numpy(np_tree(packed), algo="td3")
    assert isinstance(tp, fused_td3.PackedParams)
    for f in fused_td3.PackedParams._fields:
        np.testing.assert_array_equal(getattr(convert.packed_to_numpy(tp), f),
                                      np.asarray(getattr(packed, f)))
    ta = convert.packed_adam_from_numpy(np_tree(adam), algo="td3")
    assert (ta.count, ta.count_a) == (5, 3)
    back = convert.packed_adam_to_numpy(ta)
    assert (int(back.count), int(back.count_a)) == (5, 3)
    jf = jft.fused_init(packed, adam)
    tf = convert.fused_from_numpy(np_tree(jf), algo="td3")
    assert isinstance(tf, fused_td3.FusedState) and (tf.count, tf.count_a) == (5, 3)
    back = convert.fused_to_numpy(tf)
    for f in ("w", "vec", "mw", "mvec", "vw", "vvec"):
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(jf, f)))
    assert (int(back.count), int(back.count_a)) == (5, 3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_trainer_runs_through_the_warmup_gate(fused):
    tr = trainer(fused_updates=fused, warmup_rows=8, updates_per_iter=3)
    assert tr.device.type == "cpu"
    st = tr.init(0)
    g = tr.generator(1)
    assert st.obs.shape == (16, tr.obs_dim) and st.replay.data.shape == (16, 40, 16)
    assert (st.fused is not None) == fused
    # the targets start as copies of the online networks, not as the same tensors
    assert all(torch.equal(st.actor_params[k], st.target_actor_params[k])
               for k in st.target_actor_params)
    launches = dict(fused_td3.LAUNCHES)

    before = learner_leaves(st)
    st, m = tr.train_iter(st, g)                 # 4 rows < warm-up 8: nothing moves
    assert (st.replay.cursor, st.replay.filled, st.step, st.n_updates) == (4, 4, 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, learner_leaves(st)))
    assert np.isnan(float(m["critic_loss"])) and np.isfinite(float(m["mean_reward"]))

    st, m = tr.train_iter(st, g)                 # 8 rows: the updates are live
    assert st.n_updates == 3
    assert not all(torch.equal(a, b) for a, b in zip(before, learner_leaves(st)))
    for _ in range(3):                            # the ring wraps at 16 rows
        st, m = tr.train_iter(st, g)
    assert (st.replay.cursor, st.replay.filled, st.step, st.n_updates) == (20, 16, 5, 12)
    # policy_delay 2: every other of the 12 updates moved the actor
    count_a = st.fused.count_a if fused else st.actor_opt.count
    count_c = st.fused.count if fused else st.critic_opt.count
    assert (count_c, count_a) == (12, 6)
    vals = {k: float(v) for k, v in m.items()}
    assert set(vals) == {"critic_loss", "actor_loss", "mean_reward", "episodes_done"}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert all(torch.isfinite(t).all() for t in learner_leaves(st))
    assert fused_td3.LAUNCHES == launches, "no kernel is launched for CPU tensors"
    if fused:  # the rollout's actor is the fused state's, not a stale copy
        want = tr._ft.unpack_actor(st.fused.w, st.fused.vec, tr.obs_dim)
        assert all(torch.equal(st.actor_params[k], want[k]) for k in want)
    st2, _ = tr.train_iters(st, g, 2)
    assert st2.step == 7
    a = tr.act(st2.actor_params, st2.obs, g)
    e = tr.eval_act(st2.actor_params, st2.obs)
    assert a.shape == e.shape == (16, 2) and (a.abs() <= 1).all() and (e.abs() <= 1).all()
    eps = torch.ones((16, 2))
    np.testing.assert_allclose(tr.act(st2.actor_params, st2.obs, eps=eps).numpy(),
                               torch.clamp(e + tr.cfg.explore_std, -1, 1).numpy(), atol=1e-7)


def test_trainer_options_and_errors():
    with pytest.raises(ValueError):
        TD3Trainer(EnvEngine(get_config("GoalDiscrete2-v0"), device="cpu"))
    eng = EnvEngine(get_config(ENV), device="cpu")
    with pytest.raises(ValueError):
        TD3Trainer(eng, TD3Config(**SMALL), device="cuda")
    with pytest.raises(ValueError):
        TD3Trainer(eng, TD3Config(hidden=(64, 64), fused_updates=True))
    # batch not a multiple of lanes: gathered minibatches, still the fused entry
    tr = trainer(fused_updates=True, batch_size=24, warmup_rows=4, policy_delay=3)
    st = tr.init(3)
    st, m = tr.train_iter(st, tr.generator(0))
    assert (st.fused.count, st.fused.count_a) == (2, 1) and np.isfinite(float(m["critic_loss"]))
    assert TD3Config._fields == JaxTD3Config._fields
    assert TD3Config() == tuple(JaxTD3Config())
    # an unfused trainer of a shape the packed layout does not fit has no bridge
    with pytest.raises(ValueError):
        trainer(hidden=(64, 64))._update_fused(st)


def jax_and_torch_learners(cfg):
    """A JAX trainer's fresh state and the port's trainer holding the same
    learner, with targets drawn apart from the online networks."""
    jtr = JaxTD3Trainer(jax_engine(), JaxTD3Config(**cfg))
    jst = jtr.init(jax.random.key(0))
    other = jtr.init(jax.random.key(7))
    jst = jst._replace(target_actor_params=other.actor_params,
                       target_critic_params=other.critic_params)
    if jst.fused is not None:
        ft = jtr._ft
        packed = ft.pack_params(jst.actor_params, jst.target_actor_params, jst.critic_params,
                                jst.target_critic_params)
        jst = jst._replace(fused=ft.fused_init(packed, ft.adam_init(packed)))
    ttr = trainer(**{k: v for k, v in cfg.items() if k not in SMALL or SMALL[k] != v})
    tst = ttr.init(0)._replace(
        actor_params=convert.params_from_flax(np_tree(jst.actor_params), "det_actor"),
        target_actor_params=convert.params_from_flax(np_tree(jst.target_actor_params),
                                                     "det_actor"),
        critic_params=convert.params_from_flax(np_tree(jst.critic_params), "critic"),
        target_critic_params=convert.params_from_flax(np_tree(jst.target_critic_params),
                                                      "critic"),
        actor_opt=convert.adam_from_optax(np_tree(jst.actor_opt), "det_actor"),
        critic_opt=convert.adam_from_optax(np_tree(jst.critic_opt), "critic"),
    )
    return jtr, jst, ttr, tst


@pytest.mark.parametrize("delay", [2, 3])
def test_update_once_matches_flax_and_optax(delay):
    """The port's unfused `_update_once` (torch.autograd and its own Adam)
    against the flax/optax update with the same batch and smoothing normals,
    over four updates: delayed ones (0, 2 or 0, 3) and the others."""
    jtr, jst, ttr, tst = jax_and_torch_learners({**SMALL, "batch_size": 64, "policy_delay": delay})
    obs_dim = jtr.obs_dim
    assert ttr.obs_dim == obs_dim
    rng = np.random.default_rng(7)
    for k in range(4):
        b = dict(obs=rng.standard_normal((64, obs_dim)).astype(np.float32),
                 action=rng.uniform(-1, 1, (64, 2)).astype(np.float32),
                 reward=rng.standard_normal(64).astype(np.float32),
                 next_obs=rng.standard_normal((64, obs_dim)).astype(np.float32),
                 discount=(rng.random(64) > 0.1).astype(np.float32))
        noise = rng.standard_normal((64, 2)).astype(np.float32)
        actor_before = {k_: v.clone() for k_, v in tst.actor_params.items()}
        jst, cl_j, al_j = flax_update_with_noise(
            jtr, jst, jreplay.Transition(**{k_: jnp.asarray(v) for k_, v in b.items()}),
            jnp.asarray(noise), jtr.cfg.lr)
        tst, m = ttr._update_once(
            tst, batch=treplay.Transition(**{k_: torch.as_tensor(v) for k_, v in b.items()}),
            noise=torch.as_tensor(noise))
        np.testing.assert_allclose(float(m["critic_loss"]), float(cl_j), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(m["actor_loss"]), float(al_j), rtol=2e-4, atol=1e-5)
        moved = any(not torch.equal(actor_before[k_], tst.actor_params[k_]) for k_ in actor_before)
        assert moved == (k % delay == 0)
    for got, want, kind in ((tst.actor_params, jst.actor_params, "det_actor"),
                            (tst.target_actor_params, jst.target_actor_params, "det_actor"),
                            (tst.critic_params, jst.critic_params, "critic"),
                            (tst.target_critic_params, jst.target_critic_params, "critic")):
        want = convert.params_from_flax(np_tree(want), kind)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=k)
    assert tst.n_updates == int(jst.n_updates) == 4
    assert tst.critic_opt.count == int(jst.critic_opt[0].count) == 4
    assert tst.actor_opt.count == int(jst.actor_opt[0].count) == 2
    assert isinstance(tst.actor_opt, AdamState)
    for opt, jopt, kind in ((tst.critic_opt, jst.critic_opt, "critic"),
                            (tst.actor_opt, jst.actor_opt, "det_actor")):
        mu = convert.adam_from_optax(np_tree(jopt), kind).mu
        for k in mu:
            np.testing.assert_allclose(opt.mu[k].numpy(), mu[k].numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=k)


def test_update_fused_matches_the_jax_trainer_on_the_same_draws():
    cfg = {**SMALL, "warmup_rows": 4, "fused_updates": True, "updates_per_iter": 3}
    jtr, jst, ttr, tst = jax_and_torch_learners(cfg)
    obs_dim = jtr.obs_dim

    # the same 12 rows of transitions in both rings
    rng = np.random.default_rng(5)
    slab = dict(
        obs=rng.standard_normal((12, 16, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (12, 16, 2)).astype(np.float32),
        reward=rng.standard_normal((12, 16)).astype(np.float32),
        next_obs=rng.standard_normal((12, 16, obs_dim)).astype(np.float32),
        discount=(rng.random((12, 16)) > 0.1).astype(np.float32),
    )
    jrep, trep = jst.replay, tst.replay
    for i in range(3):
        part = {k: v[4 * i:4 * i + 4] for k, v in slab.items()}
        jrep = jreplay.replay_add_slab(jrep, jreplay.Transition(
            **{k: jnp.asarray(v) for k, v in part.items()}))
        trep = treplay.replay_add_slab(trep, treplay.Transition(
            **{k: torch.as_tensor(v) for k, v in part.items()}))
    np.testing.assert_array_equal(trep.data.numpy(), np.asarray(jrep.data))
    jst = jst._replace(replay=jrep)

    def port_state():
        return ttr._refresh_from_fused(tst._replace(
            replay=trep, fused=convert.fused_from_numpy(np_tree(jst.fused), algo="td3")))

    # what the JAX trainer draws from a key off the TPU (td3.py:233-268):
    # whole rows by replay_sample_rows, normals up front.  Two calls in a row
    # with K = 3: the second starts from an odd count.
    w = trep.data.shape[1]
    t1 = port_state()
    for call in range(2):
        key = jax.random.key(42 + call)
        k_samp, k_noise = jax.random.split(key)
        row_idx = np.asarray(jax.random.randint(k_samp, (3 * 32 // 16,), 0, 12))
        noises = np.asarray(jax.random.normal(k_noise, (3, 32, 2), jnp.float32))
        before = t1
        jst2, jm = jtr._update_fused(jst, key)
        t2, tm = ttr._update_fused(t1, row_idx=torch.as_tensor(row_idx.copy()),
                                   noises=torch.as_tensor(noises.copy()))
        assert (t2.fused.count, t2.fused.count_a) == (int(jst2.fused.count),
                                                      int(jst2.fused.count_a))
        assert t2.n_updates == int(jst2.n_updates) == 3 * (call + 1)
        np.testing.assert_allclose(float(tm["critic_loss"]), float(jm["critic_loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["actor_loss"]), float(jm["actor_loss"]), rtol=1e-3,
                                   atol=1e-5)
        for f, rtol in (("w", 3e-4), ("vec", 3e-4), ("mw", 2e-3), ("mvec", 2e-3)):
            np.testing.assert_allclose(getattr(t2.fused, f).numpy(),
                                       np.asarray(getattr(jst2.fused, f)), rtol=rtol, atol=3e-5,
                                       err_msg=f)
        want = convert.params_from_flax(np_tree(jst2.actor_params), "det_actor")
        for k in want:
            np.testing.assert_allclose(t2.actor_params[k].numpy(), want[k].numpy(), rtol=3e-4,
                                       atol=3e-5, err_msg=k)
        # injected gathered minibatches take the batches entry to the same result
        flat = trep.data[torch.as_tensor(row_idx.copy())].transpose(1, 2).reshape(3, 32, w)
        t3, _ = ttr._update_fused(before, batches=treplay.unpack_flat(flat, obs_dim, 2),
                                  noises=torch.as_tensor(noises.copy()))
        assert all(torch.equal(a, b) for a, b in zip(t3.fused[:6], t2.fused[:6]))
        assert t3.fused[6:] == t2.fused[6:]
        jst, t1 = jst2, t2
    assert (t1.fused.count, t1.fused.count_a) == (6, 3)


def test_migrate_then_rehydrate_is_the_identity():
    tr = trainer(fused_updates=False, warmup_rows=4, updates_per_iter=3)
    st = tr.init(2)
    g = tr.generator(3)
    st, _ = tr.train_iter(st, g)
    assert (st.critic_opt.count, st.actor_opt.count, st.n_updates) == (3, 2, 3)
    assert st.fused is None
    mig = tr.migrate_to_fused(st)
    assert (mig.fused.count, mig.fused.count_a, mig.n_updates) == (3, 2, 3)
    assert mig.fused.w.shape == (fused_td3.WROWS, 256)
    back = tr.rehydrate_from_fused(mig)
    assert back.fused is None and back.n_updates == 3
    for name in ("actor_params", "target_actor_params", "critic_params", "target_critic_params"):
        a, b = getattr(st, name), getattr(back, name)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), name
    for name in ("actor_opt", "critic_opt"):
        a, b = getattr(st, name), getattr(back, name)
        assert a.count == b.count
        assert all(torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k]) for k in a.mu)
    # a fused trainer resumes from the migrated state at the odd count 3, and
    # an unfused one from what it rehydrates: the same trajectory
    ftr = trainer(fused_updates=True, warmup_rows=4, updates_per_iter=3)
    fst = ftr._refresh_from_fused(mig)
    w = st.replay.data.shape[1]
    rng = np.random.default_rng(0)
    row_idx = torch.as_tensor(rng.integers(0, st.replay.filled, 3 * 2))
    noises = torch.as_tensor(rng.standard_normal((3, 32, 2)).astype(np.float32))
    fst, m = ftr._update_fused(fst, row_idx=row_idx, noises=noises)
    assert (fst.fused.count, fst.fused.count_a) == (6, 3) and np.isfinite(float(m["actor_loss"]))
    flat = st.replay.data[row_idx].transpose(1, 2).reshape(3, 32, w)
    batches = treplay.unpack_flat(flat, tr.obs_dim, 2)
    ust = back
    for k in range(3):
        ust, _ = tr._update_once(ust, batch=treplay.Transition(*[x[k] for x in batches]),
                                 noise=noises[k])
    assert (ust.critic_opt.count, ust.actor_opt.count) == (6, 3)
    again = tr.rehydrate_from_fused(fst)
    for name in ("actor_params", "target_actor_params", "critic_params", "target_critic_params"):
        for k, v in getattr(ust, name).items():
            np.testing.assert_allclose(getattr(again, name)[k].numpy(), v.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{name} {k}")
    with pytest.raises(ValueError):
        trainer(hidden=(64, 64)).migrate_to_fused(st)
