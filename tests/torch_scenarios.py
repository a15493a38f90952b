"""Shared inputs of the port's tests: numpy-seeded env states in which lanes
are live, truncating, crashing and reaching the goal, so every branch of the
step runs (`scenario_inputs` at B >= 8 in float64, `pattern_operands` at any
B in float32, `firing_operands` with most lanes' events firing); and
`one_torch_thread`, the autouse fixture every port test module imports."""
import numpy as np
import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.ops.full_step import FullStep
from space_gym_torch.ops.full_step_plain import count_uniform_rows


# Raw continuous actions (a0, a1) at the edges of K3's translation: outside
# [-1, 1], infinite, NaN, -0.0, and 1 - 2**-24, whose a0 + 1 needs 25
# mantissa bits and rounds.
EDGE_ACTIONS = ((-1.5, 1.5), (3.0, -7.0), (float("inf"), float("-inf")),
                (float("-inf"), float("inf")), (float("nan"), 0.3), (0.2, float("nan")),
                (-0.0, -0.0), (0.0, 0.0), (1 - 2**-24, 0.5), (-(1 - 2**-24), -(1 - 2**-24)),
                (1.0, -1.0), (-1.0, 1.0))


def bits(t):
    """A float tensor's bits as int32, so that NaNs compare by their bits; any
    other tensor as it is."""
    return t.view(torch.int32) if t.is_floating_point() else t


def edge_actions(seed, n=2 * len(EDGE_ACTIONS)):
    """(n, 2) float32 raw actions: the edge pairs again and again, every
    other block of them uniform in [-1, 1] from a numpy seed."""
    rng = np.random.default_rng(seed)
    edge = np.asarray(EDGE_ACTIONS)
    blocks = [edge if i % 2 == 0 else rng.uniform(-1, 1, edge.shape)
              for i in range(-(-n // len(edge)))]
    return torch.as_tensor(np.concatenate(blocks)[:n].astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one thread while a module of the port's tests runs, then as
    it was.  Their tensors are small, and under pytest-xdist the intra-op
    threads of every worker oversubscribe the cores: four workers running one
    module each took 2.2 times as long with PyTorch's default threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario_inputs(env_id, B, seed, raw_action=False):
    """(B, rows) numpy operands of one full step (B >= 8), made from a numpy
    seed: lanes 0-1 live, 2-3 truncating, 4-5 crashing into planet 0, 6-7
    reaching the goal (Goal) or leaving the world; Goal lanes 1, 3, 5, 7
    carry a known goal tile.  Returns (config, operands in the JAX kernel's
    `apply` order): the action translated, as the JAX kernels and K1/K2 take
    it, or with `raw_action` the raw action it is translated from, as
    FullStep.apply takes it."""
    cfg = get_config(env_id)
    rng = np.random.default_rng(seed)
    eng = EnvEngine(cfg, dtype=torch.float64, device="cpu")
    state, _ = eng.reset(B, u=torch.as_tensor(rng.random((B, eng.n_reset_rand))))
    y = state.y.numpy().copy()
    p = state.planets_pos.numpy().copy()
    g = state.goal_pos.numpy().copy()
    steps = np.full(B, 3, np.int32)
    steps[2:4] = cfg.max_episode_steps - 1
    # crash: just outside planet 0's surface, heading into it fast
    for lane in (4, 5):
        r0 = cfg.planet_radii[0]
        y[lane, 0:2] = p[lane, 0] + np.array([r0 + 0.02, 0.0])
        y[lane, 3:5] = [-2.0, 0.0]
    if cfg.task == "goal":
        for lane in (6, 7):  # sit on the goal, at rest
            y[lane, 0:2] = g[lane]
            y[lane, 3:6] = 0.0
        steps[7] = cfg.max_episode_steps - 1  # reached and truncated at once
    else:
        for lane in (6, 7):  # leave the world through the border
            y[lane, 0:2] = [cfg.world_size / 2 - 0.01, 0.0]
            y[lane, 3:5] = [3.0, 0.0]
    action = rng.uniform(-1, 1, (B, 2))
    action_b = np.stack([(action[:, 0] + 1) / 2, action[:, 1]], 1)
    if cfg.task == "goal":
        ts = state.tiling
        tili = np.concatenate([
            ts.free.numpy(), ts.ship_tile.numpy()[:, None], ts.goal_tile.numpy()[:, None],
            steps[:, None], ts.case_b.numpy()[:, None], ts.flip_xy.numpy()[:, None],
        ], 1).astype(np.int32)
        # a subsequent goal on some lanes: the goal tile is known
        tili[1::2, cfg.tiling.n_tiles + 1] = (tili[1::2, cfg.tiling.n_tiles] + 1) % cfg.tiling.n_tiles
        cs = ts.col_shift.numpy()
    else:
        tili = np.stack([steps, np.zeros(B, np.int32), np.zeros(B, np.int32)], 1)
        cs = np.zeros((B, 1))
    u = rng.random((B, count_uniform_rows(cfg)))
    return cfg, (y, action if raw_action else action_b, p, g, state.ref_orbit.numpy(), cs, tili, u)


def pattern_operands(cfg, B, seed, device="cpu", raw_action=False):
    """Component-major float32 operands of one step in the kernels' order,
    at any B, made from a numpy seed: lane % 10 == 0 truncates, 1 crashes
    into planet 0, 2 reaches its goal (Goal) or leaves the world, 3 carries a
    known goal tile (Goal); the rest are fresh episodes.  The action is the
    translated (2, B) rows K1 and K2 take (their operands are the first three
    and five), or with `raw_action` K3's: the raw action, lane-major (B, 2)
    (FullStep.step_rows)."""
    rng = np.random.default_rng(seed)
    eng = EnvEngine(cfg, device="cpu")
    state, _ = eng.reset(B, u=torch.as_tensor(rng.random((B, eng.n_reset_rand),
                                                         dtype=np.float32)))
    y = state.y.clone()
    p, g = state.planets_pos, state.goal_pos
    lane = torch.arange(B)
    steps = torch.full((B,), 3, dtype=torch.int32)
    steps[lane % 10 == 0] = cfg.max_episode_steps - 1
    crash = lane % 10 == 1
    y[crash, 0] = p[crash, 0, 0] + cfg.planet_radii[0] + 0.02
    y[crash, 1] = p[crash, 0, 1]
    y[crash, 3], y[crash, 4] = -2.0, 0.0
    special = lane % 10 == 2
    ts = state.tiling
    if cfg.task == "goal":
        y[special, 0:2] = g[special]
        y[special, 3:6] = 0.0
        known = lane % 10 == 3
        goal_tile = ts.goal_tile.clone()
        goal_tile[known] = ((ts.ship_tile[known] + 1) % cfg.tiling.n_tiles).to(torch.int32)
        ts = ts._replace(goal_tile=goal_tile)
    else:
        y[special, 0], y[special, 1] = cfg.world_size / 2 - 0.01, 0.0
        y[special, 3], y[special, 4] = 3.0, 0.0
    action = torch.as_tensor(rng.uniform(-1, 1, (B, 2)).astype(np.float32))
    u = torch.as_tensor(rng.random((B, eng.n_step_rand), dtype=np.float32))
    state = state._replace(y=y, steps=steps, tiling=ts)
    rows = FullStep.to_rows(*eng.kernel_operands(state, action, u))
    if not raw_action:
        rows[1] = eng._translate_action(action).t().contiguous()
    return [t.to(device) for t in rows]


def firing_operands(cfg, B, seed, device="cpu", raw_action=False):
    """`pattern_operands` in which three lanes of every four sit just outside
    planet 0's surface heading into it: their events fire, more of them
    than a block's list of deferred lanes in K1, K2 and K3 holds (128 lanes
    where a block walks two tiles or more).  `raw_action`: as for
    `pattern_operands` (K3's action)."""
    rows = pattern_operands(cfg, B, seed, device, raw_action=raw_action)
    y, p = rows[0], rows[2]
    crash = torch.arange(B, device=device) % 4 != 3
    y[0, crash] = p[0, crash] + cfg.planet_radii[0] + 0.02
    y[1, crash] = p[1, crash]
    y[3, crash], y[4, crash] = -2.0, 0.0
    return rows
