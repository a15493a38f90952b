"""The port's PPO (space_gym_torch/models/ppo.py) against the JAX trainer
(space_gym_tpu/models/ppo.py) on the CPU.

The learner is the flax network of docs/goal2p_ppo_feat_best.npz (obs 43:
GoalContinuous2P-v0 with the goal features, hidden 64), carried into the
port through models/convert.py.  Inputs are made from a numpy seed and handed
to both packages; the JAX trainer's minibatch loss is its own `loss_fn`,
caught where `_update_epoch` hands it to `jax.value_and_grad`.  Tolerances:
GAE and `gaussian_logp` atol 1e-6; the network, the loss and its gradients,
and one epoch of minibatch updates with the JAX permutation injected, rtol
1e-5 (float32 on both sides, sums taken in other orders).  Where a value is
a sum that cancels (a gradient element near 0 beside others of 1e-2, the
policy loss, a mean of terms near +-1), its rounding is relative to the
terms and not to the sum: `close` then also takes 1e-5 of the array's
largest magnitude, or of 1 for the losses, as an absolute floor.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import space_gym_tpu
from space_gym_tpu.engine import EnvEngine as JaxEngine
from space_gym_tpu.models import networks as jnetworks
from space_gym_tpu.models import ppo as jppo

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import convert, networks
from space_gym_torch.models.ppo import PPOConfig, PPOTrainer
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"
FILE = "docs/goal2p_ppo_feat_best.npz"
# 256 lanes x 2 steps = 4 lane tiles, 2 minibatches of 2 tiles
SMALL = dict(lanes=256, rollout_len=2, epochs=1, minibatches=2)
RTOL = 1e-5


@functools.cache
def jax_trainer():
    """The JAX trainer, built once per module: one substep and 8 refinements
    make its engine's trace shorter; the learner never steps it here."""
    eng = JaxEngine(space_gym_tpu.get_config(ENV), substeps=1, refine_iters=8,
                    obs_features="goal")
    return jppo.PPOTrainer(eng, jppo.PPOConfig(**SMALL))


def trainer(**kw):
    eng = EnvEngine(get_config(ENV), device="cpu", obs_features="goal")
    return PPOTrainer(eng, PPOConfig(**{**SMALL, **kw}))


def file_params():
    """(the port's parameter dict, the flax tree as jax arrays)."""
    params, _, meta = convert.load_learner_npz(FILE)
    assert meta["kind"] == "ppo" and int(meta["obs_dim"]) == 43
    return params, jax.tree.map(jnp.asarray, convert.params_to_flax(params, "ppo"))


def epoch_data(seed=0):
    """(T * L / 128, 128, ...) lane tiles of obs, actions, old log-probs a
    little off the file's policy (so that the ratio clips somewhere),
    advantages and returns, as numpy."""
    rng = np.random.default_rng(seed)
    n_tiles = SMALL["lanes"] * SMALL["rollout_len"] // 128
    obs = rng.normal(0, 0.5, (n_tiles, 128, 43)).astype(np.float32)
    params, _ = file_params()
    net = networks.GaussianActorValue(43, 2, (64, 64))
    mean, log_std, _ = torch.func.functional_call(net, params, (torch.as_tensor(obs),))
    action = (mean + torch.exp(log_std) * torch.as_tensor(
        rng.normal(size=mean.shape).astype(np.float32))).detach()
    logp = networks.gaussian_logp(action, mean, log_std).detach().numpy()
    return {
        "obs": obs, "action": action.numpy(),
        "logp": (logp + rng.normal(0, 0.3, logp.shape)).astype(np.float32),
        "adv": rng.normal(size=(n_tiles, 128)).astype(np.float32),
        "ret": rng.normal(0, 10, (n_tiles, 128)).astype(np.float32),
    }


def close(got, want, name, rtol=RTOL, scale=None):
    """rtol, with rtol times `scale` (default: the largest |want|) as the
    absolute floor."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def test_gae_matches_the_jax_trainer():
    """The arrays of tests/test_models.py::test_ppo_gae_matches_numpy: a
    termination (no bootstrap) and a truncation (bootstraps final_value)."""
    T, L = 6, 3
    rng = np.random.default_rng(0)
    reward, value, fval = (rng.normal(size=(T, L)).astype(np.float32) for _ in range(3))
    term = np.zeros((T, L), np.float32)
    done = np.zeros((T, L), np.float32)
    term[2, 0] = done[2, 0] = 1.0
    done[4, 1] = 1.0
    data = {"reward": reward, "value": value, "final_value": fval, "nonterm": 1.0 - term,
            "nondone": 1.0 - done}
    want_adv, want_ret = jax.jit(jax_trainer()._gae)(jax.tree.map(jnp.asarray, data))
    adv, ret = trainer()._gae({k: torch.as_tensor(v) for k, v in data.items()})
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=0, atol=1e-6)


def test_gaussian_logp_matches_flax_twin():
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(64, 2)).astype(np.float32)
    log_std = rng.uniform(-2, 1, (64, 2)).astype(np.float32)
    # samples of the policy, as the rollout draws them
    a = (mean + np.exp(log_std) * rng.normal(size=(64, 2))).astype(np.float32)
    got = networks.gaussian_logp(*map(torch.as_tensor, (a, mean, log_std)))
    want = jnetworks.gaussian_logp(*map(jnp.asarray, (a, mean, log_std)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_network_from_the_flax_file_matches_flax():
    params, jparams = file_params()
    obs = np.random.default_rng(2).normal(0, 0.5, (300, 43)).astype(np.float32)
    net = networks.GaussianActorValue(43, 2, (64, 64))
    got = torch.func.functional_call(net, params, (torch.as_tensor(obs),))
    want = jax_trainer().net.apply(jparams, jnp.asarray(obs))
    for g, w, name in zip(got, want, ("mean", "log_std", "value")):
        close(g.detach().numpy(), w, name)
    value = PPOTrainer._value(trainer(), params, torch.as_tensor(obs))
    close(value.detach().numpy(), want[2], "value tower")
    close(convert.params_to_flax(params, "ppo")["params"]["log_std"],
          jparams["params"]["log_std"], "log_std round trip", rtol=0, scale=0)


def test_loss_and_gradients_match_the_jax_loss(monkeypatch):
    """The JAX trainer's own minibatch loss_fn, caught where _update_epoch
    hands it to jax.value_and_grad, against the port's `_loss` and
    torch.autograd on the same minibatch."""
    params, jparams = file_params()
    data = epoch_data()
    jtr = jax_trainer()
    caught = []
    real = jax.value_and_grad

    def spy(fn, *a, **k):
        caught.append(fn)
        return real(fn, *a, **k)

    monkeypatch.setattr(jax, "value_and_grad", spy)
    jtr._update_epoch(jparams, jtr.opt.init(jparams), jax.tree.map(jnp.asarray, data),
                      jax.random.key(3))
    monkeypatch.undo()
    loss_fn = caught[0]
    mb = {k: v[:2].reshape(256, *v.shape[2:]) for k, v in data.items()}
    (jloss, (jpg, jvf)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, mb))

    tr = trainer()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, pg, vf = tr._loss(p, {k: torch.as_tensor(v) for k, v in mb.items()})
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    close(loss.item(), jloss, "loss", scale=1.0)
    close(pg.item(), jpg, "policy loss", scale=1.0)
    close(vf.item(), jvf, "value loss", scale=1.0)
    want = convert.params_from_flax(jax.tree.map(np.asarray, jgrads), "ppo")
    for k in want:
        close(grads[k].numpy(), want[k].numpy(), f"d loss / d {k}")


def test_update_epoch_matches_the_jax_trainer():
    """One epoch (two minibatches: clip by global norm, Adam) from the file's
    parameters with the JAX trainer's permutation injected."""
    params, jparams = file_params()
    data = epoch_data(seed=4)
    jtr = jax_trainer()
    key = jax.random.key(5)
    jp, jopt, jpg, jvf = jax.jit(jtr._update_epoch)(
        jparams, jtr.opt.init(jparams), jax.tree.map(jnp.asarray, data), key)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, 4)))

    tr = trainer()
    st = tr.init(0)._replace(params=params)
    opt, pg, vf = tr._update_epoch(st.params, st.opt,
                                   {k: torch.as_tensor(v) for k, v in data.items()}, perm=perm)
    close(pg.item(), jpg, "policy loss", scale=1.0)
    close(vf.item(), jvf, "value loss", scale=1.0)
    want = convert.params_from_flax(jax.tree.map(np.asarray, jp), "ppo")
    for k in want:  # the parameters were written in place
        close(st.params[k].numpy(), want[k].numpy(), k)
    adam = jopt[1][0]
    assert opt.count == int(adam.count) == 2
    for mine, theirs, name in ((opt.mu, adam.mu, "mu"), (opt.nu, adam.nu, "nu")):
        theirs = convert.params_from_flax(jax.tree.map(np.asarray, theirs), "ppo")
        for k in theirs:
            close(mine[k].numpy(), theirs[k].numpy(), f"{name} {k}")


def test_trainer_smoke():
    """tests/test_models.py::test_ppo_trainer_smoke on the port."""
    tr = trainer(lanes=128, rollout_len=8, epochs=2, minibatches=4)
    st = tr.init(0)
    g = tr.generator(1)
    p0 = st.params["torso.layers.0.kernel"].clone()
    for _ in range(3):
        st, m = tr.train_iter(st, g)
    assert st.step == 3
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.allclose(p0, st.params["torso.layers.0.kernel"])
    a = tr.eval_act(st.params, st.obs)
    assert a.shape == (128, 2) and (a.abs() <= 1).all()


def test_rollout_keeps_the_unclipped_sample_and_its_logp():
    """The rollout's data: the unclipped sample, its log-probability under
    the policy that drew it, the value, and the value of each final
    observation from the value tower."""
    tr = trainer(lanes=128, rollout_len=4)
    st = tr.init(0)
    _, _, data, dones = tr._rollout(st, tr.generator(2))
    mean, log_std, value = torch.func.functional_call(tr.net, st.params, (data["obs"],))
    torch.testing.assert_close(data["logp"], networks.gaussian_logp(data["action"], mean, log_std))
    torch.testing.assert_close(data["value"], value)
    assert (data["action"].abs() > 1).any()  # kept unclipped
    assert data["final_value"].shape == (4, 128) and dones.shape == (4, 128)


def test_checks_of_the_jax_trainer():
    with pytest.raises(ValueError, match="continuous"):
        PPOTrainer(EnvEngine(get_config("GoalDiscrete3-v0"), device="cpu"))
    with pytest.raises(ValueError, match="128-lane tiles"):
        trainer(lanes=128, rollout_len=1, minibatches=2)
