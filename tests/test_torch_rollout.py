"""The port's rollout (space_gym_torch/engine/core.py::EnvEngine.rollout) on
the CPU: under fuse="full" it carries K3's (rows, B) operands from step to
step (`RowCarry`, `step_carry`), and must give what the loop of `step` gives
from the same generator, bit for bit: every observation, reward, flag and
final observation, the state after the last step, and the generator's
state.  Each of the three sources of K3's uniforms, on four env families,
T=8 steps of B=257 lanes (no multiple of a tile).  On the card
`capture_rollout` runs the same steps as one captured CUDA graph;
tests/test_torch_cuda.py holds it to this loop there.  `PolicyRollout`,
which the trainers hold, captures again only when its parameters or
generator are other tensors.
"""
import numpy as np
import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.engine.core import PolicyRollout, RowCarry
from space_gym_torch.models import SACConfig, SACTrainer
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ENVS = ["GoalContinuous2P-v0", "KeplerRandomOrbits-v0", "DoNotCrashContinuous-v0",
        "GoalDiscrete3-v0"]
T, B = 8, 257


def step_loop(eng, state, obs, policy, n, g):
    obs_in, traj = [], []
    for _ in range(n):
        obs_in.append(obs)
        state, ts = eng.step(state, policy(g, obs), g)
        traj.append(ts)
        obs = ts.obs
    return state, obs, obs_in, traj


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def same_state(a, b):
    return (all(same(x, y) for x, y in zip(a[:4], b[:4])) and same(a.steps, b.steps)
            and (a.tiling is None) == (b.tiling is None)
            and (a.tiling is None or all(same(x, y) for x, y in zip(a.tiling, b.tiling))))


@pytest.mark.parametrize("rng", [False, "threefry", "philox"], ids=["bulk", "threefry", "philox"])
@pytest.mark.parametrize("env_id", ENVS)
def test_carried_rollout_equals_the_step_loop_bitwise(env_id, rng):
    eng = EnvEngine(get_config(env_id), device="cpu", in_kernel_rng=rng)
    g = eng.generator(3)
    policy = eng.random_policy()
    state, obs = eng.init(B, g)
    # lanes near the TimeLimit, so that truncations reset lanes in the window
    state = state._replace(steps=state.steps + get_config(env_id).max_episode_steps - 3)
    g0 = g.get_state()
    s1, o1, traj = eng.rollout(state, obs, policy, T, g)
    g1 = g.get_state()
    g.set_state(g0)
    s2, o2, obs_in, ts = step_loop(eng, state, obs, policy, T, g)
    assert torch.equal(g.get_state(), g1)
    assert same_state(s1, s2) and same(o1, o2)
    assert same(traj.obs, torch.stack(obs_in))
    for name in ("reward", "terminated", "truncated", "done", "final_obs"):
        assert same(getattr(traj, name), torch.stack([getattr(t, name) for t in ts])), name
    assert traj.truncated.any() and traj.done.any()
    assert traj.kept["action"].shape[:2] == (T, B)
    assert same(traj.reward_sum, traj.reward.sum(0).sum())
    assert int(traj.done_sum) == int(traj.done.sum())
    # without a trajectory: the same state and sums from the same draws
    g.set_state(g0)
    s3, o3, bare = eng.rollout(state, obs, policy, T, g, trajectory=False)
    assert same_state(s3, s1) and same(o3, o1) and bare.obs is None
    assert same(bare.reward_sum, traj.reward_sum) and same(bare.done_sum, traj.done_sum)


@pytest.mark.parametrize("env_id", ENVS + ["GoalContinuous4P-v0"])
def test_carry_round_trip_is_exact(env_id):
    """to_carry -> from_carry gives the state back; from_carry of K3's
    outputs is the state `step` returns."""
    eng = EnvEngine(get_config(env_id), device="cpu")
    g = eng.generator(0)
    state, _ = eng.init(33, g)
    carry = eng.to_carry(state)
    assert all(t.is_contiguous() and t.shape[1] == 33 for t in carry)
    assert carry.tili.dtype == torch.int32
    assert tuple(t.shape[0] for t in carry) == tuple(
        r for i, r in enumerate(eng.full.in_rows()) if i not in (1, 6))
    assert same_state(eng.from_carry(carry), state)


def test_rollout_with_obs_features_and_a_tuple_policy():
    """The augmented observation reaches the policy at every step; what the
    policy keeps is stacked over time."""
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu", obs_features="goal")
    g = eng.generator(1)
    state, obs = eng.init(B, g)
    seen = []

    def policy(gen, o):
        seen.append(o.shape)
        a = torch.rand((o.shape[0], 2), generator=gen) * 2 - 1
        return a, {"norm": o.norm(dim=1)}

    g0 = g.get_state()
    s1, o1, traj = eng.rollout(state, obs, policy, 3, g)
    assert seen == [(B, eng.obs_dim)] * 3 and o1.shape == (B, eng.obs_dim)
    assert traj.kept["norm"].shape == (3, B)
    torch.testing.assert_close(traj.kept["norm"], traj.obs.norm(dim=2), rtol=0, atol=0)
    g.set_state(g0)
    s2, o2, obs_in, _ = step_loop(eng, state, obs, lambda gen, o: policy(gen, o)[0], 3, g)
    assert same_state(s1, s2) and same(o1, o2)
    assert same(traj.obs, torch.stack(obs_in))


@pytest.mark.parametrize("kw", [dict(fuse="env"), dict(physics="fixed")], ids=["env", "fixed"])
def test_tail_tiers_roll_out_through_step(kw):
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu", **kw)
    g = eng.generator(2)
    policy = eng.random_policy()
    state, obs = eng.init(16, g)
    g0 = g.get_state()
    s1, o1, traj = eng.rollout(state, obs, policy, 2, g)
    g.set_state(g0)
    s2, o2, obs_in, ts = step_loop(eng, state, obs, policy, 2, g)
    assert same_state(s1, s2) and same(o1, o2) and same(traj.obs, torch.stack(obs_in))
    with pytest.raises(ValueError, match="captured rollout"):
        eng.capture_rollout(policy, 2, g)
    # what a trainer holds loops over `step` on a tail tier, on the card too
    eng.device = torch.device("cuda")
    held = PolicyRollout(eng, lambda p, gen, o: policy(gen, o), 2)
    eng.device = torch.device("cpu")
    assert held.graph is False
    g.set_state(g0)
    s3, o3, traj3 = held({}, state, obs, g)
    assert same_state(s3, s2) and same(o3, o2) and same(traj3.obs, traj.obs)


def test_a_captured_rollout_needs_the_card():
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu")
    g = eng.generator(0)
    state, obs = eng.init(8, g)
    with pytest.raises(ValueError, match="captured rollout"):
        eng.capture_rollout(eng.random_policy(), 2, g)
    assert PolicyRollout(eng, lambda p, gen, o: o[:, :2], 2).graph is False
    held = PolicyRollout(eng, lambda p, gen, o: o[:, :2], 2)
    held.graph = True
    with pytest.raises(ValueError, match="captured rollout"):
        held({}, state, obs, g)


def test_policy_rollout_captures_again_only_for_other_tensors():
    """The graph a PolicyRollout holds is captured once for its parameters
    and generator: an in-place update keeps it, other parameter tensors or
    another generator make a new one (counted here through a stand-in for
    `capture_rollout`, which needs the card)."""
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu")
    captures = []

    def capture(policy_fn, n_steps, generator, trajectory=True):
        captures.append(generator)
        return lambda s, o: eng.rollout(s, o, policy_fn, n_steps, generator, trajectory)

    eng.capture_rollout = capture
    held = PolicyRollout(eng, lambda p, gen, o: torch.tanh(o[:, :2] * p["w"]), 2)
    held.graph = True
    g = eng.generator(0)
    state, obs = eng.init(8, g)
    params = {"w": torch.ones(2)}
    s1, o1, traj1 = held(params, state, obs, g)
    params["w"].mul_(0.5)
    s2, o2, traj2 = held(params, state, obs, g)
    assert len(captures) == 1
    assert not same(traj1.kept["action"], traj2.kept["action"])  # read where it lives
    other = {"w": params["w"].clone()}
    held(other, state, obs, g)
    held(other, state, obs, g)
    assert len(captures) == 2
    g2 = eng.generator(0)
    held(other, state, obs, g2)
    assert captures == [g, g, g2]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_offpolicy_rollout_is_the_act_loop(fused):
    """The SAC trainer's rollout: `act` on each observation, the step, the
    slab's fields, from one generator, against a loop of `act` and `step`."""
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu")
    tr = SACTrainer(eng, SACConfig(lanes=B, rollout_len=4, replay_rows=8, batch_size=257,
                                   fused_updates=fused, fused_block=257))
    st = tr.init(0)
    g = tr.generator(5)
    g0 = g.get_state()
    env_state, obs, slab, rewards, dones = tr._rollout(st, g)
    g.set_state(g0)
    s2, o2, obs_in, ts = step_loop(eng, st.env_state, st.obs,
                                   lambda gen, o: tr.act(st.actor_params, o, gen), 4, g)
    assert same_state(env_state, s2) and same(obs, o2)
    assert same(slab.obs, torch.stack(obs_in))
    assert same(slab.next_obs, torch.stack([t.final_obs for t in ts]))
    assert same(rewards, torch.stack([t.reward for t in ts]))
    assert same(slab.discount, 1.0 - torch.stack([t.terminated for t in ts]).float())
    assert same(dones, torch.stack([t.done for t in ts]))
    assert np.isfinite(slab.action.numpy()).all() and (slab.action.abs() <= 1).all()
    assert isinstance(eng.to_carry(env_state), RowCarry)
