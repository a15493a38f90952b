"""The port's scale-out (space_gym_torch/parallel/) without a process group.

* The split tables: for every leaf of the SAC (fused and unfused), TD3, PPO
  and DQN states the port's spec equals the spec JAX's tables
  (space_gym_tpu/parallel/mesh.py: `_spec_env`, `_spec_replay`,
  `_spec_param` by `_PARAM_FIELDS`, `_ENV_FIELDS`, `_REPLAY_FIELDS`) give an
  array of the same shape, at model_parallel 1 and 2.
* `local_lane_slice`, `make_mesh` and `init_distributed` outside a cluster,
  and their ValueErrors.
* World 1: every trainer under a one-rank mesh (no process group) equals
  the same trainer without a mesh, every leaf bit for bit, after three
  train_iters; `place` is then the identity.
* A rank's lanes: an engine on rank 1 of a (2, 1) grid steps the second half
  of the lanes; its draws are the one-process run's, so its states equal the
  one-process run's second half (the in-kernel generators through their
  lane offset, the bulk draw sliced), within 1e-6 (the plain twins'
  position-dependent vector maths; equal bits where it does not differ).

The two-process runs are tests/test_torch_distributed.py's.
"""
import numpy as np
import pytest
import torch

from space_gym_tpu.parallel import mesh as jmesh

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import SACConfig, SACTrainer, TD3Config, TD3Trainer
from space_gym_torch.models.dqn import DQNConfig, DQNTrainer
from space_gym_torch.models.ppo import PPOConfig, PPOTrainer
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.rng_plain import key_words
from space_gym_torch.parallel import (distributed, init_distributed, local_lane_slice,
                                      make_mesh, place, state_shardings,
                                      trainer_state_shardings)
from space_gym_torch.parallel.mesh import Mesh, P, tree_map
from .torch_scenarios import one_torch_thread, pattern_operands  # noqa: F401 (autouse)

ENV = "GoalContinuous2P-v0"
SMALL = dict(lanes=16, rollout_len=4, replay_rows=16, batch_size=32, warmup_rows=4)
TRAINERS = {
    "sac_fused_ring": lambda e: SACTrainer(e, SACConfig(**SMALL, updates_per_iter=2,
                                                        hidden=(128, 128),
                                                        fused_updates=True)),
    "sac_fused_rows": lambda e: SACTrainer(e, SACConfig(
        **dict(SMALL, lanes=32, batch_size=96), updates_per_iter=2, hidden=(128, 128),
        fused_updates=True, fused_block=24)),
    "sac": lambda e: SACTrainer(e, SACConfig(**SMALL, updates_per_iter=2, hidden=(64, 64))),
    "td3_fused": lambda e: TD3Trainer(e, TD3Config(**SMALL, updates_per_iter=3,
                                                   hidden=(128, 128), fused_updates=True)),
    "td3": lambda e: TD3Trainer(e, TD3Config(**SMALL, updates_per_iter=2, hidden=(64, 64))),
    "ppo": lambda e: PPOTrainer(e, PPOConfig(lanes=128, rollout_len=2, epochs=1,
                                             minibatches=2)),
    "dqn": lambda e: DQNTrainer(e, DQNConfig(**SMALL, updates_per_iter=2, hidden=(64, 64))),
}


def engine(mesh=None, env=ENV, **kw):
    return EnvEngine(get_config(env), device="cpu", substeps=1, refine_iters=8, mesh=mesh, **kw)


def make(name, mesh=None):
    env = "GoalDiscrete3-v0" if name == "dqn" else ENV
    return TRAINERS[name](engine(mesh, env))


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def jax_spec(field, x, model_parallel):
    """JAX's spec of a leaf of `field` (its tables on an array of the leaf's
    shape)."""
    arr = np.zeros(tuple(x.shape) if isinstance(x, torch.Tensor) else ())
    if field in jmesh._ENV_FIELDS:
        spec = jmesh._spec_env(arr)
    elif field in jmesh._REPLAY_FIELDS:
        spec = jmesh._spec_replay(arr)
    elif field in jmesh._PARAM_FIELDS:
        spec = jmesh._spec_param(model_parallel)(arr)
    else:
        spec = jmesh.P()
    return tuple(spec)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_split_tables_equal_jax(name):
    from space_gym_torch.parallel import mesh as tmesh

    assert (tmesh._PARAM_FIELDS, tmesh._ENV_FIELDS, tmesh._REPLAY_FIELDS) == (
        jmesh._PARAM_FIELDS, jmesh._ENV_FIELDS, jmesh._REPLAY_FIELDS)
    tr = make(name)
    state = tr.init(0)
    mesh = make_mesh()
    n_split = {1: 0, 2: 0}
    for mp in (1, 2):
        specs = trainer_state_shardings(state, mesh, mp)
        for field in state._fields:
            got = leaves(getattr(specs, field))
            vals = leaves(getattr(state, field))
            assert len(got) == len(vals), field
            for x, spec in zip(vals, got):
                assert isinstance(spec, P)
                assert tuple(spec) == jax_spec(field, x, mp), (field, getattr(x, "shape", ()))
                n_split[mp] += "model" in spec
    # the tables are exercised: model_parallel 2 splits parameter columns, 1 none
    assert n_split[1] == 0 and n_split[2] > 0
    env_specs = state_shardings((state.env_state, state.obs), mesh)
    for x, spec in zip(leaves((state.env_state, state.obs)), leaves(env_specs)):
        assert tuple(spec) == tuple(jmesh._spec_env(np.zeros(tuple(getattr(x, "shape", ())))))


def test_lane_slice_mesh_and_init_outside_a_cluster(monkeypatch):
    for k in distributed._CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 0 and init_distributed(num_processes=1) == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2)
    assert local_lane_slice(32) == slice(0, 32)
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    assert local_lane_slice(32) == slice(16, 24)
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        local_lane_slice(30)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        make_mesh(3, model_parallel=2)
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(2)
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
    t = torch.arange(6.0)
    assert mesh.all_gather(t, "data") is t


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_world_one_equals_the_unsharded_trainer(name):
    tr0, tr1 = make(name), make(name, make_mesh())
    st0 = tr0.init(0)
    st1 = tr1.init(0)
    placed = place(st1, trainer_state_shardings(st1, tr1.mesh), tr1.mesh)
    assert all(a is b for a, b in zip(leaves(placed), leaves(st1)))  # nothing split
    g0, g1 = tr0.generator(1), tr1.generator(1)
    for _ in range(3):
        st0, m0 = tr0.train_iter(st0, g0)
        placed, m1 = tr1.train_iter(placed, g1)
    for a, b in zip(leaves(st0), leaves(placed)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert {k: float(v) for k, v in m0.items()} == pytest.approx(
        {k: float(v) for k, v in m1.items()}, nan_ok=True, rel=0, abs=0)
    assert torch.equal(g0.get_state(), g1.get_state())


def rank_mesh(index, size=2):
    """Rank `index` of a (size, 1) grid with no process group: what a rank
    computes without its collectives."""
    return Mesh(shape=(size, 1), axis_names=("data", "model"), rank=index,
                coords=(index, 0), groups={"data": None, "model": None})


@pytest.mark.parametrize("rng", [False, "threefry", "philox"], ids=["bulk", "threefry", "philox"])
def test_a_rank_steps_its_block_of_the_global_lanes(rng):
    B, steps = 48, 3
    one = engine(in_kernel_rng=rng)
    half = engine(rank_mesh(1), in_kernel_rng=rng)
    state, obs = one.reset(B, one.generator(0))
    # every third lane truncates in the second step: its reset reads the
    # step's uniforms too
    count = state.steps.clone()
    count[::3] = one.config.max_episode_steps - 2
    state = state._replace(steps=count)
    blk = slice(B // 2, B)
    lstate = tree_map(lambda x: x[blk] if isinstance(x, torch.Tensor) else x, state)
    pol = one.random_policy()
    g0, g1 = one.generator(5), half.generator(5)
    s0, o0, t0 = one.rollout(state, obs, pol, steps, g0)
    s1, o1, t1 = half.rollout(lstate, obs[blk], half.random_policy(), steps, g1)
    assert torch.equal(t1.done, t0.done[:, blk])
    torch.testing.assert_close(t1.reward, t0.reward[:, blk], rtol=0, atol=1e-6)
    torch.testing.assert_close(o1, o0[blk], rtol=0, atol=1e-6)
    torch.testing.assert_close(s1.y, s0.y[blk], rtol=0, atol=1e-6)
    assert t0.done[:, blk].sum() >= B // 6
    assert torch.equal(g0.get_state(), g1.get_state())


@pytest.mark.parametrize("rng", ["threefry", "philox"])
def test_lane_offset_equals_the_same_lanes_of_a_wider_launch(rng):
    """K3-tf's and K3-hw's plain twins at lane0: the lanes lane0.. of an
    offset-0 step of twice the width, every output bit for bit."""
    cfg = get_config(ENV)
    full = FullStep(cfg, 1, 8, "bs3", in_kernel_rng=rng)
    B = 40
    rows = pattern_operands(cfg, 2 * B, seed=7, raw_action=True)
    rows[6] = key_words([0x5EED0001, 0x0000C0DE])
    wide = full.step_rows(*rows)
    right = FullStep.lane_block(rows, B)
    got = full.step_rows(*right, lane0=B)
    for w, g in zip(wide, got):
        assert torch.equal(w[:, B:], g)
    assert torch.equal(full.plain_uniforms(rows[6], B, B),
                       full.plain_uniforms(rows[6], 2 * B)[:, B:])
    with pytest.raises(ValueError, match="lane offset"):
        FullStep(cfg, 1, 8, "bs3").step_rows(
            *FullStep.lane_block(pattern_operands(cfg, 2 * B, 7, raw_action=True), 0, B), lane0=B)
