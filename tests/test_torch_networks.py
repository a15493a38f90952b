"""The port's SAC networks and the hand-off of parameters
(space_gym_torch/models/{networks,convert}.py) against the flax networks.

flax parameters go through models/convert.py into the port's parameter dicts;
the same float32 inputs then give the same outputs at atol 1e-6 (float32
products summed in another order), the conversion's round trip is exact, and
the fused-layout learner file docs/goal2p_sac_best.npz gives the same
deterministic actions through both packages at atol 1e-5.
"""
import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
import optax

from space_gym_tpu.models import fused_sac as jfs
from space_gym_tpu.models import networks as jnets

from space_gym_torch.models import convert, fused_sac, networks
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_DIM, ACT_DIM = 13, 2


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flax_nets(hidden, seed=0):
    actor = jnets.TanhGaussianActor(ACT_DIM, hidden)
    critic = jnets.DoubleCritic(hidden)
    ka, kc = jax.random.split(jax.random.key(seed))
    obs = jnp.zeros((1, OBS_DIM), jnp.float32)
    act = jnp.zeros((1, ACT_DIM), jnp.float32)
    return actor, critic, actor.init(ka, obs), critic.init(kc, obs, act)


@pytest.mark.parametrize("hidden", [(256, 256), (64, 32)])
def test_actor_critic_and_sample_match_flax(hidden):
    jactor, jcritic, ap, cp = flax_nets(hidden)
    # biases start at zero in both packages: move them off it
    ap = jax.tree.map(lambda x: x + 0.01 if x.ndim == 1 else x, ap)
    cp = jax.tree.map(lambda x: x - 0.02 if x.ndim == 1 else x, cp)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((32, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-1, 1, (32, ACT_DIM)).astype(np.float32)
    eps = rng.standard_normal((32, ACT_DIM)).astype(np.float32)

    tactor = networks.TanhGaussianActor(OBS_DIM, ACT_DIM, hidden)
    tcritic = networks.DoubleCritic(OBS_DIM, ACT_DIM, hidden)
    tap = convert.params_from_flax(np_tree(ap), "actor")
    tcp = convert.params_from_flax(np_tree(cp), "critic")
    assert set(tap) == set(tactor.state_dict()) and set(tcp) == set(tcritic.state_dict())
    for k, v in tactor.state_dict().items():
        assert v.shape == tap[k].shape, k

    mean_j, ls_j = jactor.apply(ap, jnp.asarray(obs))
    mean_t, ls_t = functional_call(tactor, tap, (torch.as_tensor(obs),))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ls_t.numpy(), np.asarray(ls_j), rtol=0, atol=1e-6)
    q_j = jcritic.apply(cp, jnp.asarray(obs), jnp.asarray(act))
    q_t = functional_call(tcritic, tcp, (torch.as_tensor(obs), torch.as_tensor(act)))
    for a, b in zip(q_t, q_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)

    # the same eps through both samplers (the JAX one draws its own: restate it)
    std = jnp.exp(ls_j)
    pre = mean_j + std * eps
    logp_j = -0.5 * (eps**2 + 2 * ls_j + jnp.log(2 * jnp.pi))
    logp_j = (logp_j - 2 * (jnp.log(2.0) - pre - jax.nn.softplus(-2 * pre))).sum(-1)
    a_t, logp_t = networks.sample_tanh_gaussian(mean_t, ls_t, torch.as_tensor(eps))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(jnp.tanh(pre)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), rtol=0, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    a_g, _ = networks.sample_tanh_gaussian(mean_t, ls_t, generator=g)
    assert a_g.shape == a_t.shape and (a_g.abs() <= 1).all()


def test_jax_sampler_equals_its_restatement():
    """sample_tanh_gaussian of the JAX package with the eps it draws equals
    the port's sampler on the same eps: the formula above is the JAX one."""
    rng = np.random.default_rng(2)
    mean = rng.standard_normal((16, 2)).astype(np.float32)
    ls = rng.uniform(-3, 1, (16, 2)).astype(np.float32)
    key = jax.random.key(5)
    a_j, lp_j = jnets.sample_tanh_gaussian(key, jnp.asarray(mean), jnp.asarray(ls))
    eps = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    a_t, lp_t = networks.sample_tanh_gaussian(torch.as_tensor(mean), torch.as_tensor(ls),
                                              torch.as_tensor(eps))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0, atol=1e-5)


def test_fresh_networks_are_drawn_like_flax():
    """Dense draws LeCun-normal kernels (variance 1 / fan-in, cut at two
    sigma) and zero biases, as flax does."""
    g = torch.Generator().manual_seed(0)
    net = networks.TanhGaussianActor(OBS_DIM, ACT_DIM, (256, 256), generator=g)
    sd = net.state_dict()
    w = sd["mlp.layers.1.kernel"]
    assert w.shape == (256, 256) and abs(w.var().item() * 256 - 1) < 0.05
    assert w.abs().max().item() <= 2 / np.sqrt(256) / 0.87962566103423978 + 1e-6
    assert all((v == 0).all() for k, v in sd.items() if k.endswith("bias"))
    _, _, ap, _ = flax_nets((256, 256))
    wj = np.asarray(ap["params"]["MLP_0"]["Dense_1"]["kernel"])
    assert abs(wj.var() * 256 - 1) < 0.05 and abs(np.abs(wj).max() - w.abs().max().item()) < 0.02


def test_convert_round_trips_exactly():
    _, _, ap, cp = flax_nets((128, 128), seed=3)
    for tree, kind in ((ap, "actor"), (cp, "critic")):
        back = convert.params_to_flax(convert.params_from_flax(np_tree(tree), kind), kind)
        assert jax.tree.structure(back) == jax.tree.structure(np_tree(tree))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree(tree))):
            np.testing.assert_array_equal(a, b)
    # an optax Adam state after one step
    opt = optax.adam(3e-4)
    st = opt.init(ap)
    _, st = opt.update(jax.tree.map(jnp.ones_like, ap), st)
    mine = convert.adam_from_optax(np_tree(st), "actor")
    assert mine.count == 1
    back = convert.adam_to_optax(mine, "actor")
    assert int(back["count"]) == 1
    for a, b in zip(jax.tree.leaves(back["mu"]), jax.tree.leaves(np_tree(st[0].mu))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(back["nu"]), jax.tree.leaves(np_tree(st[0].nu))):
        np.testing.assert_array_equal(a, b)
    la = opt.init(jnp.asarray(0.5))
    mine = convert.adam_from_optax(np_tree(la), None)
    assert mine.count == 0 and mine.mu.shape == ()
    assert convert.adam_to_optax(mine, None)["mu"].shape == ()

    # packed tuples and the fused state
    packed = jfs.pack_params(*flax_nets((256, 256))[2:], flax_nets((256, 256))[3],
                             jnp.asarray(-1.0))
    adam = jfs.adam_init(packed)
    tp = convert.packed_from_numpy(np_tree(packed))
    for f in fused_sac.PackedParams._fields:
        np.testing.assert_array_equal(getattr(convert.packed_to_numpy(tp), f),
                                      np.asarray(getattr(packed, f)))
    ta = convert.packed_adam_from_numpy(np_tree(adam))
    assert ta.count == 0 and int(convert.packed_adam_to_numpy(ta).count) == 0
    jf = jfs.fused_init(packed, adam)
    tf = convert.fused_from_numpy(np_tree(jf))
    back = convert.fused_to_numpy(tf)
    for f in ("w", "vec", "mw", "mvec", "vw", "vvec"):
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(jf, f)))
    assert tf.count == 0


def test_learner_file_gives_the_same_actions_in_both_packages():
    path = os.path.join(ROOT, "docs", "goal2p_sac_best.npz")
    fused, log_alpha, meta = convert.load_learner_npz(path)
    obs_dim = int(meta["obs_dim"])
    assert fused.w.shape == (fused_sac.WROWS, 256) and fused.count > 0
    assert str(meta["env_id"]) == "GoalContinuous2P-v0"
    assert float(log_alpha) == float(fused.vec[fused_sac.V_MISC, fused_sac.M_LA])

    z = np.load(path)
    jparams = jfs.unpack_actor(jnp.asarray(z["w"]), jnp.asarray(z["vec"]), obs_dim, 2)
    tparams = fused_sac.unpack_actor(fused.w, fused.vec, obs_dim, 2)
    for (path_j, name) in convert._ACTOR_LAYERS:
        node = jparams["params"]
        for p in path_j:
            node = node[p]
        np.testing.assert_array_equal(tparams[name + ".kernel"].numpy(), np.asarray(node["kernel"]))
        np.testing.assert_array_equal(tparams[name + ".bias"].numpy(), np.asarray(node["bias"]))

    rng = np.random.default_rng(3)
    obs = rng.standard_normal((64, obs_dim)).astype(np.float32)
    mean_j, _ = jnets.TanhGaussianActor(2, (256, 256)).apply(jparams, jnp.asarray(obs))
    want = np.asarray(jnp.tanh(mean_j))
    tactor = networks.TanhGaussianActor(obs_dim, 2, (256, 256))
    with torch.no_grad():
        got = torch.tanh(functional_call(tactor, tparams, (torch.as_tensor(obs),))[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1
