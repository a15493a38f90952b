"""Shared inputs of the port's tests: numpy-seeded env states in which lanes
are live, truncating, crashing and reaching the goal, so every branch of the
step runs."""
import numpy as np
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.ops.full_step_plain import count_uniform_rows


def scenario_inputs(env_id, B, seed):
    """(B, rows) numpy operands of one full step (B >= 8), made from a numpy
    seed: lanes 0-1 live, 2-3 truncating, 4-5 crashing into planet 0, 6-7
    reaching the goal (Goal) or leaving the world; Goal lanes 1, 3, 5, 7
    carry a known goal tile.  Returns (config, operands in FullStep.apply
    order)."""
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
    return cfg, (y, action_b, p, g, state.ref_orbit.numpy(), cs, tili, u)
