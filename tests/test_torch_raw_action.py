"""K3's action operand is the policy's raw action (ops/full_step.py): the plain
twin and `EnvEngine` on fuse="full" translate it as `_translate_action`
does, bit for bit, on edge values (outside [-1, 1], infinite, NaN, -0.0, and
an a0 whose a0 + 1 needs 25 mantissa bits); the engine agrees with the JAX
engine on them, at the tolerances of tests/test_torch_engine.py; a discrete
config's table rows pass through as they did.

The reference for the bits is the operand path K3 had before it took the raw
action: `_translate_action` in PyTorch, and a K3 that passes its action rows
as they are, which is K3 of the same config with `continuous=False`.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import space_gym_tpu
from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine, state_from_numpy
from space_gym_torch.ops.full_step import FullStep

from .torch_scenarios import (EDGE_ACTIONS, bits, edge_actions,  # noqa: F401 (autouse)
                              one_torch_thread, pattern_operands)

B = 2 * len(EDGE_ACTIONS)


def same_bits(got, want):
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def leaves(state):
    """An EnvState's tensors, the tiling's included."""
    return [*state[:4], *(state.tiling or ()), state.steps]


def operand_path(eng):
    """`eng` stepped as before K3 took the raw action: the action translated
    in PyTorch, then a K3 that passes it through."""
    full = eng.full
    eng.full = FullStep(dataclasses.replace(eng.config, continuous=False), full.n_substeps,
                        full.refine_iters, full.tableau)
    eng._kernel_action = lambda raw: eng._translate_action(raw).contiguous()
    return eng


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "KeplerRandomOrbits-v0",
                                    "DoNotCrashContinuous-v0"])
def test_plain_twin_translates_raw_actions_bit_for_bit(env_id):
    cfg = get_config(env_id)
    rows = pattern_operands(cfg, B, seed=21, raw_action=True)
    rows[1] = edge_actions(21)
    got = FullStep(cfg, 1, 8, "bs3").step_rows(*rows)
    passes = FullStep(dataclasses.replace(cfg, continuous=False), 1, 8, "bs3")
    translated = EnvEngine(cfg, device="cpu")._translate_action(rows[1])
    want = passes.step_rows(rows[0], translated, *rows[2:])
    assert same_bits(got, want)
    assert got[-1].dtype == torch.bool and got[-1][2].any()
    assert torch.isnan(got[0]).any(), "a NaN action reaches the state"


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalDiscrete3-v0"])
def test_engine_step_and_rollout_keep_the_operand_paths_bits(env_id):
    """`step` and `rollout` on raw edge actions (a discrete config: indices,
    one out of the table) against the same engine on the old operand path:
    every state row, observation, reward, flag and sum."""
    cfg = get_config(env_id)
    kw = dict(tableau="bs3", substeps=1, refine_iters=8, device="cpu")
    eng, ref = EnvEngine(cfg, **kw), operand_path(EnvEngine(cfg, **kw))
    if cfg.continuous:
        act = edge_actions(22)
    else:
        act = torch.arange(B, dtype=torch.int32) % (cfg.n_actions + 1)
    g = eng.generator(5)
    state, obs = eng.init(B, g)
    state = state._replace(steps=state.steps + cfg.max_episode_steps - 2)
    u = torch.rand((B, eng.n_step_rand), generator=g)
    (s1, t1), (s2, t2) = eng.step(state, act, u=u), ref.step(state, act, u=u)
    assert same_bits(leaves(s1), leaves(s2))
    assert same_bits(t1, t2) and t1.done.dtype == torch.bool

    def policy(generator, obs):
        return act

    runs = []
    for e in (eng, ref):
        g.manual_seed(6)
        runs.append(e.rollout(state, obs, policy, 3, g))
    (sa, oa, ta), (sb, ob, tb) = runs
    assert same_bits(leaves(sa) + [oa], leaves(sb) + [ob])
    for name in ("obs", "reward", "terminated", "truncated", "done", "final_obs", "reward_sum",
                 "done_sum"):
        assert torch.equal(bits(getattr(ta, name)), bits(getattr(tb, name))), name
    assert ta.done_sum.dtype == torch.int64 and int(ta.done_sum) == int(ta.done.sum()) > 0


@functools.cache
def _jax_engine(env_id):
    import jax.numpy as jnp
    from space_gym_tpu.engine import EnvEngine as JaxEngine

    return JaxEngine(space_gym_tpu.get_config(env_id), physics="fixed", dtype=jnp.float32)


@pytest.mark.parametrize("env_id", ["GoalContinuous2P-v0", "GoalDiscrete3-v0"])
def test_engine_on_raw_actions_matches_jax_fixed_path(env_id):
    """The port's default engine (K3's plain twin) against the JAX engine's
    fixed path on the edge actions, as
    test_torch_engine.py::test_step_matches_jax_fixed_path_on_live_lanes
    compares them: done flags equal, live lanes that did not reach their
    goal within its tolerances (a NaN on both sides agrees)."""
    import jax

    cfg = get_config(env_id)
    jeng = _jax_engine(env_id)
    eng = EnvEngine(cfg, device="cpu")
    state, _ = jeng.init(jax.random.key(7), B)
    if cfg.continuous:
        act = edge_actions(23).numpy()
    else:
        act = (np.arange(B) % cfg.n_actions).astype(np.int32)
    sx, tx = jeng.step(state, jax.numpy.asarray(act), jax.random.key(8))
    u = torch.rand((B, eng.n_step_rand), generator=torch.Generator().manual_seed(9))
    st, tp = eng.step(state_from_numpy(jax.tree.map(np.asarray, state)), torch.as_tensor(act),
                      u=u)
    done_x = np.asarray(tx.done)
    np.testing.assert_array_equal(tp.done.numpy(), done_x)
    reached = np.linalg.norm(np.asarray(state.goal_pos) - np.asarray(sx.y[:, :2]),
                             axis=-1) < cfg.goal_radius
    m = ~done_x & ~reached
    assert m.sum() >= B // 2
    np.testing.assert_allclose(st.y.numpy()[m], np.asarray(sx.y)[m], rtol=0, atol=2e-5)
    np.testing.assert_allclose(tp.final_obs.numpy()[m], np.asarray(tx.final_obs)[m], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tp.reward.numpy()[m], np.asarray(tx.reward)[m], rtol=1e-3,
                               atol=1e-4)


def test_wrapper_takes_the_action_lane_major():
    """`step_rows` wants the (B, 2) action; `apply` and `to_rows` keep it so;
    `lane_block` cuts it along the lanes like the rows."""
    cfg = get_config("GoalContinuous2P-v0")
    full = FullStep(cfg, 1, 8, "bs3")
    rows = pattern_operands(cfg, B, seed=24, raw_action=True)
    assert tuple(rows[1].shape) == (B, 2)
    with pytest.raises(ValueError, match=r"a: want shape \(24, 2\)"):
        full.step_rows(rows[0], rows[1].t().contiguous(), *rows[2:])
    block = FullStep.lane_block(rows, 5, 9)
    assert torch.equal(block[1], rows[1][5:9]) and torch.equal(block[0], rows[0][:, 5:9])
    want = [o[:, 5:9] for o in full.step_rows(*rows)]
    assert same_bits(full.step_rows(*block), want)
    assert full.bytes_per_lane() == 4 * (sum(full.in_rows()) + sum(full.out_rows()) - 3) + 3
