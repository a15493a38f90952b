"""The port's SAC trainer as a whole (space_gym_torch/models/sac.py) on the
CPU, sized as tests/test_fused_sac.py::test_trainer_fused_smoke: lanes 16,
rollout 4, replay rows 16, batch 32, K = 2, warm-up 4 rows, alpha_floor 1e-3.

The trainer's own run is checked for what must hold whatever the draws: the
warm-up gate, finite losses, the ring's cursor.  The fused update is held to
the JAX trainer's `_update_fused` with the same replay contents, row indices
and normals: the JAX trainer draws them from a key, and the same draws are
injected into the port.  Tolerances as in tests/test_torch_fused_sac.py.
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
from space_gym_tpu.models import replay as jreplay

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import SACConfig, SACTrainer, convert, fused_sac
from space_gym_torch.models import replay as treplay
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"


@functools.cache
def jax_engine():
    """The JAX engine of ENV, built once per module (it holds no state).  The
    learners read its shapes and never step it: one substep and 8
    refinements make its constructor's trace of the step shorter."""
    return JaxEngine(space_gym_tpu.get_config(ENV), substeps=1, refine_iters=8)


SMALL = dict(lanes=16, rollout_len=4, replay_rows=16, batch_size=32, updates_per_iter=2,
             fused_block=32, alpha_floor=1e-3)


def trainer(**kw):
    eng = EnvEngine(get_config(ENV), device="cpu")
    return SACTrainer(eng, SACConfig(**{**SMALL, **kw}))


def learner_leaves(st):
    if st.fused is not None:
        return [t.clone() for t in st.fused[:6]] + [st.log_alpha.clone()]
    return ([v.clone() for d in (st.actor_params, st.critic_params, st.target_critic_params)
             for v in d.values()] + [st.log_alpha.clone()])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_trainer_runs_through_the_warmup_gate(fused):
    tr = trainer(fused_updates=fused, warmup_rows=8)
    assert tr.device.type == "cpu"
    st = tr.init(0)
    g = tr.generator(1)
    assert st.obs.shape == (16, tr.obs_dim) and st.replay.data.shape == (16, 40, 16)
    assert (st.fused is not None) == fused
    launches = dict(fused_sac.LAUNCHES)

    before = learner_leaves(st)
    st, m = tr.train_iter(st, g)                 # 4 rows < warm-up 8: nothing moves
    assert (st.replay.cursor, st.replay.filled, st.step) == (4, 4, 1)
    assert all(torch.equal(a, b) for a, b in zip(before, learner_leaves(st)))
    assert np.isnan(float(m["critic_loss"])) and np.isfinite(float(m["mean_reward"]))
    count = (lambda s: s.fused.count) if fused else (lambda s: s.critic_opt.count)
    assert count(st) == 0

    st, m = tr.train_iter(st, g)                 # 8 rows: the updates are live
    after = learner_leaves(st)
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert count(st) == 2
    for _ in range(3):                            # the ring wraps at 16 rows
        st, m = tr.train_iter(st, g)
    assert (st.replay.cursor, st.replay.filled, st.step) == (20, 16, 5)
    assert count(st) == 8
    vals = {k: float(v) for k, v in m.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert vals["alpha"] >= 1e-3 - 1e-9
    assert all(torch.isfinite(t).all() for t in learner_leaves(st))
    assert fused_sac.LAUNCHES == launches, "no kernel is launched for CPU tensors"
    if fused:  # the rollout's actor is the fused state's, not a stale copy
        want = tr._fs.unpack_actor(st.fused.w, st.fused.vec, tr.obs_dim)
        assert all(torch.equal(st.actor_params[k], want[k]) for k in want)
        assert float(st.log_alpha) == float(st.fused.vec[tr._fs.V_MISC, tr._fs.M_LA])
    st2, _ = tr.train_iters(st, g, 2)
    assert st2.step == 7
    a = tr.act(st2.actor_params, st2.obs, g)
    e = tr.eval_act(st2.actor_params, st2.obs)
    assert a.shape == e.shape == (16, 2) and (a.abs() <= 1).all() and (e.abs() <= 1).all()


def test_trainer_options_and_errors():
    with pytest.raises(RuntimeError):
        EnvEngine(get_config(ENV))  # the card by default, and there is none here
    with pytest.raises(ValueError):
        SACTrainer(EnvEngine(get_config("GoalDiscrete2-v0"), device="cpu"))
    eng = EnvEngine(get_config(ENV), device="cpu")
    with pytest.raises(ValueError):
        SACTrainer(eng, SACConfig(**SMALL), device="cuda")
    # batch not a multiple of lanes: gathered minibatches, still the fused entry
    tr = trainer(fused_updates=True, batch_size=24, warmup_rows=4, n_step=3, reward_scale=0.5)
    st = tr.init(3)
    st, m = tr.train_iter(st, tr.generator(0))
    assert st.fused.count == 2 and np.isfinite(float(m["critic_loss"]))
    assert SACConfig._fields == JaxSACConfig._fields
    assert SACConfig() == tuple(JaxSACConfig())


@pytest.mark.parametrize("fold", [False, True], ids=["grid_k2t", "fold_k"])
def test_update_fused_matches_the_jax_trainer_on_the_same_draws(fold):
    cfg = {**SMALL, "warmup_rows": 4, "fused_updates": True, "fused_fold": fold}
    jtr = JaxSACTrainer(jax_engine(), JaxSACConfig(**cfg))
    jst = jtr.init(jax.random.key(0))
    ttr = trainer(**{k: v for k, v in cfg.items() if k not in SMALL})
    tst = ttr.init(0)
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
    tst = ttr._refresh_from_fused(tst._replace(
        replay=trep, fused=convert.fused_from_numpy(jax.tree.map(np.asarray, jst.fused))))

    # what the JAX trainer draws from this key off the TPU (sac.py:277-312):
    # whole rows by replay_sample_rows, normals up front
    key = jax.random.key(42)
    k_samp, k_noise = jax.random.split(key)
    row_idx = np.asarray(jax.random.randint(k_samp, (2 * 32 // 16,), 0, 12))
    noises = np.asarray(jax.random.normal(k_noise, (2, 32, 2, 2), jnp.float32))

    jst2, jm = jtr._update_fused(jst, key)
    tst2, tm = ttr._update_fused(tst, row_idx=torch.as_tensor(row_idx.copy()),
                                 noises=torch.as_tensor(noises.copy()))
    assert tst2.fused.count == int(jst2.fused.count) == 2
    np.testing.assert_allclose(float(tm["critic_loss"]), float(jm["critic_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["actor_loss"]), float(jm["actor_loss"]), rtol=1e-3,
                               atol=1e-5)
    for f, rtol in (("w", 2e-4), ("vec", 2e-4), ("mw", 2e-3), ("mvec", 2e-3)):
        np.testing.assert_allclose(getattr(tst2.fused, f).numpy(),
                                   np.asarray(getattr(jst2.fused, f)), rtol=rtol, atol=2e-5,
                                   err_msg=f)
    want = convert.params_from_flax(jax.tree.map(np.asarray, jst2.actor_params), "actor")
    for k in want:
        np.testing.assert_allclose(tst2.actor_params[k].numpy(), want[k].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(tst2.log_alpha), float(jst2.log_alpha), rtol=2e-4, atol=2e-5)
    assert not np.array_equal(np.asarray(jst2.fused.w), np.asarray(jst.fused.w))

    # injected gathered minibatches take the batches entry to the same result
    w = trep.data.shape[1]
    flat = trep.data[torch.as_tensor(row_idx.copy())].transpose(1, 2).reshape(2, 32, w)
    tst3 = ttr._refresh_from_fused(tst._replace(
        fused=convert.fused_from_numpy(jax.tree.map(np.asarray, jst.fused))))
    tst3, _ = ttr._update_fused(tst3, batches=treplay.unpack_flat(flat, obs_dim, 2),
                                noises=torch.as_tensor(noises.copy()))
    assert all(torch.equal(a, b) for a, b in zip(tst3.fused[:6], tst2.fused[:6]))


def test_migrate_then_rehydrate_is_the_identity():
    tr = trainer(fused_updates=False, warmup_rows=4)
    st = tr.init(2)
    g = tr.generator(3)
    for _ in range(2):
        st, _ = tr.train_iter(st, g)
    assert st.critic_opt.count == 4 and st.fused is None
    mig = tr.migrate_to_fused(st)
    assert mig.fused.count == 4 and mig.fused.w.shape == (fused_sac.WROWS, 256)
    back = tr.rehydrate_from_fused(mig)
    assert back.fused is None
    for name in ("actor_params", "critic_params", "target_critic_params"):
        a, b = getattr(st, name), getattr(back, name)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), name
    assert torch.equal(st.log_alpha, back.log_alpha)
    for name in ("actor_opt", "critic_opt"):
        a, b = getattr(st, name), getattr(back, name)
        assert a.count == b.count
        assert all(torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k]) for k in a.mu)
    assert torch.equal(st.alpha_opt.mu, back.alpha_opt.mu)
    assert torch.equal(st.alpha_opt.nu, back.alpha_opt.nu)
    # and a fused trainer resumes from the migrated state
    ftr = trainer(fused_updates=True, warmup_rows=4)
    fst = ftr._refresh_from_fused(mig)
    fst, m = ftr.train_iter(fst, g)
    assert fst.fused.count == 6 and np.isfinite(float(m["actor_loss"]))
    with pytest.raises(ValueError):
        trainer(hidden=(64, 64)).migrate_to_fused(st)
