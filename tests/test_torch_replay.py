"""The port's replay ring (space_gym_torch/models/replay.py) against
space_gym_tpu/models/replay.py: same inputs from a numpy seed, results equal
exactly (atol 0): the functions only move, add and multiply the same float32
values in the same order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from space_gym_tpu.models import replay as jr

from space_gym_torch.models import replay as tr
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


def rand_slab(rng, t, lanes, obs_dim, act_dim):
    return dict(
        obs=rng.standard_normal((t, lanes, obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (t, lanes, act_dim)).astype(np.float32),
        reward=rng.standard_normal((t, lanes)).astype(np.float32),
        next_obs=rng.standard_normal((t, lanes, obs_dim)).astype(np.float32),
        discount=(rng.random((t, lanes)) > 0.2).astype(np.float32),
    )


def both(slab):
    return (jr.Transition(**{k: jnp.asarray(v) for k, v in slab.items()}),
            tr.Transition(**{k: torch.as_tensor(v) for k, v in slab.items()}))


def assert_transition_equal(got, want):
    for name in tr.Transition._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("obs_dim", range(7, 18))
@pytest.mark.parametrize("act_dim", [2, 6])
def test_layout_and_pack_unpack(obs_dim, act_dim):
    assert tr.replay_cols(obs_dim, act_dim) == jr.replay_cols(obs_dim, act_dim)
    assert tr.replay_ones_row(obs_dim, act_dim) == jr.replay_ones_row(obs_dim, act_dim)
    rng = np.random.default_rng(obs_dim * 10 + act_dim)
    js, ts = both(rand_slab(rng, 3, 8, obs_dim, act_dim))
    packed_j = np.asarray(jr.pack_slab(js, obs_dim, act_dim))
    packed_t = tr.pack_slab(ts, obs_dim, act_dim)
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    flat = np.array(packed_j.transpose(0, 2, 1))
    assert_transition_equal(tr.unpack_flat(torch.as_tensor(flat), obs_dim, act_dim),
                            jr.unpack_flat(jnp.asarray(flat), obs_dim, act_dim))


def test_add_slab_wraps_the_ring_and_samples_rows():
    obs_dim, act_dim, rows, lanes, t = 13, 2, 8, 16, 4
    rng = np.random.default_rng(0)
    sj = jr.replay_init(rows, lanes, obs_dim, act_dim, jnp.float32)
    st = tr.replay_init(rows, lanes, obs_dim, act_dim)
    for i in range(3):  # the third slab wraps onto the first
        js, ts = both(rand_slab(rng, t, lanes, obs_dim, act_dim))
        sj = jr.replay_add_slab(sj, js)
        st = tr.replay_add_slab(st, ts)
        assert (st.cursor, st.filled) == (int(sj.cursor), int(sj.filled)) == (t * (i + 1),
                                                                              min(t * (i + 1), rows))
        np.testing.assert_array_equal(st.data.numpy(), np.asarray(sj.data))
    one = {k: v[0] for k, v in rand_slab(rng, 1, lanes, obs_dim, act_dim).items()}
    with pytest.raises(ValueError):
        tr.replay_add_slab(st, tr.Transition(*[torch.as_tensor(v)[None].repeat(
            3, *[1] * v.ndim) for v in (one["obs"], one["action"], one["reward"],
                                         one["next_obs"], one["discount"])]))

    # the same row indices give the same minibatch as the JAX row gather
    idx = np.array([5, 0, 5, 7])
    want = jr.unpack_flat(jnp.swapaxes(sj.data[idx], 1, 2).reshape(4 * lanes, -1), obs_dim, act_dim)
    assert_transition_equal(
        tr.replay_sample_rows(st, None, 4 * lanes, row_idx=torch.as_tensor(idx)), want)
    with pytest.raises(ValueError):
        tr.replay_sample_rows(st, None, lanes + 1)
    # and the same (row, lane) pairs the same transitions
    rows_i, lanes_i = rng.integers(0, rows, 32), rng.integers(0, lanes, 32)
    want = jr.unpack_flat(sj.data[rows_i, :, lanes_i], obs_dim, act_dim)
    assert_transition_equal(
        tr.replay_sample(st, None, 32, torch.as_tensor(rows_i), torch.as_tensor(lanes_i)), want)
    # drawn indices stay inside the filled region
    part = tr.replay_add_slab(tr.replay_init(rows, lanes, obs_dim, act_dim),
                              both(rand_slab(rng, t, lanes, obs_dim, act_dim))[1])
    g = torch.Generator().manual_seed(0)
    got = tr.replay_sample_rows(part, g, 8 * lanes)
    assert got.obs.shape == (8 * lanes, obs_dim) and (got.obs.abs().sum(1) > 0).all()


def test_replay_add_is_a_one_row_slab():
    rng = np.random.default_rng(4)
    slab = rand_slab(rng, 1, 8, 9, 2)
    js, ts = both({k: v[0] for k, v in slab.items()})
    sj = jr.replay_add(jr.replay_init(4, 8, 9, 2, jnp.float32), js)
    st = tr.replay_add(tr.replay_init(4, 8, 9, 2), ts)
    np.testing.assert_array_equal(st.data.numpy(), np.asarray(sj.data))
    assert (st.cursor, st.filled) == (1, 1)


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_slab(n):
    rng = np.random.default_rng(7)
    slab = rand_slab(rng, 6, 8, 7, 2)
    dones = rng.random((6, 8)) < 0.25
    js, ts = both(slab)
    want = jr.nstep_slab(js, jnp.asarray(dones), 0.99, n)
    got = tr.nstep_slab(ts, torch.as_tensor(dones), 0.99, n)
    assert dones.any()
    assert_transition_equal(got, want)
