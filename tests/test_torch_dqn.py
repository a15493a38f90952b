"""The port's double DQN (space_gym_torch/models/dqn.py) against the JAX
trainer (space_gym_tpu/models/dqn.py) on the CPU.

The Q network is the flax MLP of docs/dqn_goaldiscrete3_best.npz
(GoalDiscrete3-v0, obs 15, hidden 256, 6 actions), carried into the port
through models/convert.py; the target network is a second, perturbed copy,
so that the double-DQN target reads both.  Batches are what the JAX
trainer's `_update_once` samples from its ring with the same key, injected
into the port.  Tolerances as tests/test_torch_ppo.py states them: rtol
1e-5 (float32 on both sides), with 1e-5 of the array's largest magnitude
(of 1 for the loss) as an absolute floor where a sum cancels; the
exploration rate exactly.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.models import dqn as jdqn
from space_gym_tpu.models import replay as jreplay

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import convert
from space_gym_torch.models.dqn import DQNConfig, DQNTrainer
from space_gym_torch.models.replay import Transition
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalDiscrete3-v0"
FILE = "docs/dqn_goaldiscrete3_best.npz"
SMALL = dict(lanes=32, rollout_len=4, replay_rows=16, batch_size=64, updates_per_iter=2,
             warmup_rows=8, target_sync_every=3)
RTOL = 1e-5


@functools.cache
def jax_trainer():
    """The JAX trainer, built once per module (its engine at one substep and
    8 refinements, which the learner never steps here)."""
    eng = JaxEngine(space_gym_tpu.get_config(ENV), substeps=1, refine_iters=8)
    return jdqn.DQNTrainer(eng, jdqn.DQNConfig(**SMALL))


def trainer(env_id=ENV, **kw):
    return DQNTrainer(EnvEngine(get_config(env_id), device="cpu"), DQNConfig(**{**SMALL, **kw}))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def states():
    """(JAX state, port state): the file's network, a perturbed target, a
    fresh Adam, and (JAX) a ring of 8 rows of random transitions."""
    params, _, meta = convert.load_learner_npz(FILE)
    assert meta["kind"] == "dqn" and str(meta["env_id"]) == ENV
    rng = np.random.default_rng(0)
    target = {k: (v + torch.as_tensor(rng.normal(0, 0.02, v.shape).astype(np.float32)))
              for k, v in params.items()}
    jtr = jax_trainer()
    jst = jtr.init(jax.random.key(0))
    jp, jt = (jax.tree.map(jnp.asarray, convert.params_to_flax(p, "dqn")) for p in (params, target))
    T, L = 8, SMALL["lanes"]
    slab = jreplay.Transition(
        obs=jnp.asarray(rng.normal(0, 0.5, (T, L, 15)), jnp.float32),
        action=jnp.asarray(rng.integers(0, 6, (T, L, 1)), jnp.float32),
        reward=jnp.asarray(rng.normal(size=(T, L)), jnp.float32),
        next_obs=jnp.asarray(rng.normal(0, 0.5, (T, L, 15)), jnp.float32),
        discount=jnp.asarray(rng.random((T, L)) > 0.1, jnp.float32))
    jst = jst._replace(params=jp, target_params=jt, opt=jtr.optim.init(jp),
                       replay=jreplay.replay_add_slab(jst.replay, slab))
    st = trainer().init(0)._replace(params=params, target_params=target)
    return jst, st


def fresh_port_state(st):
    """A copy whose tensors the in-place updates may write."""
    copy = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return st._replace(params=copy(st.params), target_params=copy(st.target_params),
                       opt=st.opt._replace(mu=copy(st.opt.mu), nu=copy(st.opt.nu)))


def batch_of(jst, key):
    """What the JAX `_update_once` samples with `key`, as the port's Transition."""
    b = jreplay.replay_sample(jst.replay, key, SMALL["batch_size"])
    return Transition(*[torch.tensor(np.asarray(x)) for x in b])


def close(got, want, name, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def test_network_from_the_flax_file_matches_flax():
    jst, st = states()
    obs = np.random.default_rng(1).normal(0, 0.5, (200, 15)).astype(np.float32)
    tr = trainer()
    got = torch.func.functional_call(tr.qnet, st.params, (torch.as_tensor(obs),))
    close(got.detach().numpy(), jax_trainer().qnet.apply(jst.params, jnp.asarray(obs)), "Q")
    assert torch.equal(tr.eval_act(st.params, torch.as_tensor(obs)),
                       torch.tensor(np.asarray(jax_trainer().eval_act(jst.params, obs))))


def test_loss_and_double_dqn_target_match_jax():
    jst, st = states()
    key = jax.random.key(7)
    b = batch_of(jst, key)
    jb = jreplay.replay_sample(jst.replay, key, SMALL["batch_size"])
    jtr, tr = jax_trainer(), trainer()
    # the JAX trainer's target, written out as its `_loss` computes it
    next_a = jnp.argmax(jtr.qnet.apply(jst.params, jb.next_obs), axis=-1)
    next_q = jnp.take_along_axis(jtr.qnet.apply(jst.target_params, jb.next_obs),
                                 next_a[:, None], axis=-1)[:, 0]
    close(tr._td_target(st.params, st.target_params, b).numpy(),
          jb.reward + jtr.cfg.gamma * jb.discount * next_q, "target")
    jloss, jgrads = jax.value_and_grad(jtr._loss)(jst.params, jst, jb)
    p = {k: v.clone().requires_grad_(True) for k, v in st.params.items()}
    loss = tr._loss(p, st.target_params, b)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    close(loss.item(), jloss, "loss", scale=1.0)
    want = convert.params_from_flax(np_tree(jgrads), "dqn")
    for k in want:
        close(grads[k].numpy(), want[k].numpy(), f"d loss / d {k}")


@pytest.mark.parametrize("n_updates", [0, 2], ids=["no-sync", "sync"])
def test_update_once_matches_jax(n_updates):
    """One update with the JAX trainer's batch injected: the parameters, the
    Adam moments and, when the count reaches target_sync_every, the hard
    target sync."""
    jst, st = states()
    jst = jst._replace(n_updates=jnp.asarray(n_updates, jnp.int32))
    st = fresh_port_state(st)._replace(n_updates=n_updates)
    key = jax.random.key(11)
    jst2, jm = jax_trainer()._update_once(jst, key)
    st2, m = trainer()._update_once(st, batch=batch_of(jst, key))
    close(m["loss"].item(), jm["loss"], "loss", scale=1.0)
    assert st2.n_updates == int(jst2.n_updates) == n_updates + 1
    for field in ("params", "target_params"):
        want = convert.params_from_flax(np_tree(getattr(jst2, field)), "dqn")
        for k in want:
            close(getattr(st2, field)[k].numpy(), want[k].numpy(), f"{field} {k}")
    synced = n_updates + 1 == SMALL["target_sync_every"]
    assert all(torch.equal(st2.params[k], st2.target_params[k]) for k in want) == synced
    adam = jst2.opt[0]
    assert st2.opt.count == int(adam.count) == 1
    for mine, theirs, name in ((st2.opt.mu, adam.mu, "mu"), (st2.opt.nu, adam.nu, "nu")):
        theirs = convert.params_from_flax(np_tree(theirs), "dqn")
        for k in theirs:
            close(mine[k].numpy(), theirs[k].numpy(), f"{name} {k}")


def test_epsilon_schedule_matches_jax():
    jtr, tr = jax_trainer(), trainer()
    for step in (0, 1, 37, 100, 199, 200, 201, 1000):
        want = np.asarray(jtr._epsilon(jnp.asarray(step, jnp.int32)))
        got = tr._epsilon(step)
        assert got.dtype == torch.float32 and got.numpy() == want, step


def test_target_sync_and_warmup_gate():
    """Nothing learns before the ring holds warmup_rows rows (the loss reads
    NaN); then `updates_per_iter` updates an iteration, and the target takes
    the parameters at every third update and only then."""
    tr = trainer("DoNotCrashDiscrete-v0")
    st = tr.init(0)
    g = tr.generator(1)
    p0 = {k: v.clone() for k, v in st.params.items()}
    st, m = tr.train_iter(st, g)                  # 4 rows < 8
    assert (st.replay.filled, st.n_updates, st.step, st.opt.count) == (4, 0, 1, 0)
    assert np.isnan(float(m["loss"])) and float(m["epsilon"]) == 1.0
    assert all(torch.equal(p0[k], st.params[k]) for k in p0)
    seen = []
    for _ in range(3):                            # updates 1-2, 3-4, 5-6
        st, m = tr.train_iter(st, g)
        seen.append((st.n_updates, all(torch.equal(st.params[k], st.target_params[k])
                                       for k in p0)))
        assert np.isfinite(float(m["loss"]))
    assert seen == [(2, False), (4, False), (6, True)]
    # between syncs the target holds the parameters of update 3
    st = tr._update_once(st, g)[0]
    assert st.n_updates == 7 and not any(torch.equal(st.params[k], st.target_params[k])
                                         for k in p0)


def test_trainer_smoke():
    """tests/test_models.py::test_trainer_smoke[dqn] on the port."""
    tr = trainer("DoNotCrashDiscrete-v0", lanes=32, rollout_len=4, replay_rows=16,
                 batch_size=64, updates_per_iter=2, warmup_rows=4, target_sync_every=32)
    st = tr.init(0)
    g = tr.generator(1)
    p0 = st.params["layers.0.kernel"].clone()
    for _ in range(4):
        st, m = tr.train_iter(st, g)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["mean_reward"]))
    assert not torch.allclose(p0, st.params["layers.0.kernel"])
    a = tr.eval_act(st.params, st.obs)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < 6
    with pytest.raises(ValueError, match="discrete"):
        DQNTrainer(EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu"))
