"""The frozen reference against the port at tiny sizes on the CPU, both in
float64: every lane's state, observation, reward and flags agree to rounding,
through goal reaches, TimeLimit truncations and resets."""
import json
import os

import pytest
import torch

from benchmark.modes.collect import lanes_of, lanes_off
from benchmark.reference.goal_env import GoalEnv

from .conftest import BENCH

STEPS = 24
B = 64


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["goal2p", "goal4p"])
def test_reference_follows_the_port(name):
    from space_gym_torch import get_config
    from space_gym_torch.engine import EnvEngine

    c = config(name)
    eng_cfg = c["engine"]
    eng = EnvEngine(get_config(c["env"]["env_id"]), dtype=torch.float64,
                    substeps=eng_cfg["substeps"], refine_iters=eng_cfg["refine_iters"],
                    tableau=eng_cfg["tableau"], device="cpu")
    ref = GoalEnv(c, torch.float64)
    assert ref.n_uniforms == eng.n_step_rand
    g = torch.Generator().manual_seed(5)
    state, _ = eng.reset(B, g)
    # a quarter of the lanes near the time limit, a quarter on their goal
    steps = state.steps.clone()
    steps[: B // 4] = c["env"]["max_episode_steps"] - 3
    goal = state.goal_pos.clone()
    goal[B // 4: B // 2] = state.y[B // 4: B // 2, :2]
    state = state._replace(steps=steps, goal_pos=goal)
    idx = torch.arange(B)
    lanes = lanes_of(state, idx, torch.float64)
    ended = reached = 0
    for _ in range(STEPS):
        action = torch.rand((B, 2), generator=g, dtype=torch.float64) * 2 - 1
        u = torch.rand((eng.n_step_rand, B), generator=g, dtype=torch.float64)
        state, ts = eng.step(state, action, u=u.t())
        st = ref.step(lanes, action, u)
        lanes = st.lanes
        got = lanes_of(state, idx, torch.float64)
        assert not lanes_off(got, list(ts.obs.t()), lanes, st.obs).any()
        torch.testing.assert_close(ts.reward, st.reward, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(ts.final_obs.t(), torch.stack(st.final_obs), rtol=1e-9,
                                   atol=1e-9)
        assert torch.equal(ts.terminated, st.terminated)
        assert torch.equal(ts.truncated, st.truncated)
        for a, b in zip(got.y + got.planets + got.goal + got.col_shift,
                        lanes.y + lanes.planets + lanes.goal + lanes.col_shift):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
        ended += int((ts.terminated | ts.truncated).sum())
        reached += int((st.reward > 4).sum())
    assert ended >= B // 4 and reached >= B // 8  # resets and resamples were exercised


def test_lanes_off_sees_each_field():
    """A lane departs when any integer row differs, or any float by more
    than the tolerance; the angle is compared on the circle."""
    c = config("goal2p")
    ref = GoalEnv(c, torch.float64)
    g = torch.Generator().manual_seed(1)
    u = torch.rand((ref.n_uniforms, 8), generator=g, dtype=torch.float64)
    from benchmark.reference.goal_env import Uniforms
    lanes = ref.reset(Uniforms(u))
    obs = ref.observe(lanes.y, lanes.planets[0::2], lanes.planets[1::2], *lanes.goal)
    assert not lanes_off(lanes, obs, lanes, obs).any()
    bumped = lanes._replace(steps=lanes.steps.clone())
    bumped.steps[3] += 1
    assert lanes_off(bumped, obs, lanes, obs).tolist() == [i == 3 for i in range(8)]
    y = [r.clone() for r in lanes.y]
    y[0][5] += 0.01
    assert lanes_off(lanes._replace(y=y), obs, lanes, obs).tolist() == [i == 5 for i in range(8)]
    y = [r.clone() for r in lanes.y]
    y[2][1] = 0.0
    y[2][2] = 2 * torch.pi - 1e-6
    same = [r.clone() for r in y]
    same[2][2] = 0.0
    assert not lanes_off(lanes._replace(y=y), obs, lanes._replace(y=same), obs).any()
