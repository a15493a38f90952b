"""Batched hexagonal-tiling sampler: the reset path's layout and goal draws.

Twin of space_gym_tpu/tiling/device.py (itself a distribution-equivalent
rewrite of gym_space/hexagonal_tiling.py:53-134), written with the lane axis
spelled out instead of `vmap`.  It consumes the RandSource in the same order,
so the same uniforms give the same layout lane for lane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.maths import onehot_take
from ..utils.randvec import RandSource
from .geometry import DIAGONAL_CASES, MAX_GOAL_CANDIDATES, TilingGeometry

# Free tiles are kept as per-tile entry counts, capped at MAX_FREE_DUP (see
# space_gym_tpu/tiling/device.py for why the reference's list can hold
# duplicates).
MAX_FREE_DUP = MAX_GOAL_CANDIDATES


class TilingState(NamedTuple):
    """Per-lane tiling state, lane axis first."""

    free: torch.Tensor       # (B, n_tiles) int32 free-list entry count per tile
    ship_tile: torch.Tensor  # (B,) int32
    goal_tile: torch.Tensor  # (B,) int32, -1 until the first goal is placed
    case_b: torch.Tensor     # (B,) bool (hexagonal_tiling.py:69)
    flip_xy: torch.Tensor    # (B,) bool
    col_shift: torch.Tensor  # (B, cols) cumulative random column shifts


def _coords(geom: TilingGeometry, device) -> torch.Tensor:
    return torch.tensor(geom.tiles_coord, dtype=torch.int32, device=device)


def tile_center_pos(geom: TilingGeometry, ts: TilingState, tile_nr: torch.Tensor) -> torch.Tensor:
    """Centre of tile `tile_nr` under each lane's case/flip/shift
    (hexagonal_tiling.py:136-158).  tile_nr: (B,) or (B, M) -> (..., 2)."""
    dt = ts.col_shift.dtype
    rc = onehot_take(_coords(geom, tile_nr.device), tile_nr)
    row = rc[..., 0].to(dt)
    col = rc[..., 1]
    colf = col.to(dt)
    extra = (1,) * (tile_nr.dim() - 1)
    case_b = ts.case_b.reshape(ts.case_b.shape + extra)
    flip = ts.flip_xy.reshape(ts.flip_xy.shape + extra)

    zero_x = -geom.world_size / 2 + geom.hex_width / 2
    zero_y = geom.world_size / 2 - geom.hex_height / 2
    zy = torch.tensor([zero_y, zero_y - geom.hex_height / 2], dtype=dt, device=rc.device)
    zero_y = torch.where(case_b, zy[1], zy[0])
    # onehot_take(col_shift, col) per lane: col_shift is (B, cols)
    oh = col[..., None] == torch.arange(geom.cols, dtype=col.dtype, device=col.device)
    cs = ts.col_shift.reshape(ts.col_shift.shape[:1] + extra + ts.col_shift.shape[1:])
    shift = torch.where(oh, cs, torch.zeros((), dtype=dt, device=cs.device)).sum(-1, dtype=dt)
    x = zero_x + colf * 1.5 * geom.a + shift
    y_cols = -(col % 2).to(dt) * geom.hex_height / 2
    y_cols = torch.where(case_b, -y_cols, y_cols)
    y = zero_y - row * geom.hex_height + y_cols
    pos = torch.stack([x, y], dim=-1)
    return torch.where(flip[..., None], pos.flip(-1), pos)


def _disk_sample(geom, ts, rs: RandSource, tile_nr, radius, dtype):
    """Disc position inside a tile: centre + uniform-disk noise of radius
    hex_height/2 - obj_radius (hexagonal_tiling.py:130-134)."""
    center = tile_center_pos(geom, ts, tile_nr).to(dtype)
    noise_radius = torch.tensor(geom.hex_height / 2, dtype=dtype, device=radius.device) - radius
    return center + rs.disk(noise_radius).to(dtype)


def tiling_reset(geom: TilingGeometry, rs: RandSource, dtype=torch.float32):
    """Sample the episode layout + ship/planet positions for every lane.

    Returns (TilingState, ship_pos (B, 2), planets_pos (B, n_planets, 2)).
    Reference flow: hexagonal_tiling.py:53-93.
    """
    dev = rs.u.device
    n = geom.n_tiles
    n_obj = geom.n_planets + 1  # ship + planets; goal placed separately

    cf = rs.take(2) < 0.5
    case_b, flip_xy = cf[:, 0], cf[:, 1]
    raw = rs.take(geom.cols).to(dtype)
    cum = torch.cumsum(raw, dim=1)
    free_x_space = geom.world_size - geom.tiling_width
    col_shift = cum * (free_x_space / cum[:, -1:])

    tiles = rs.permutation(n)[:, :n_obj]
    if geom.n_planets == 2:
        # 25% forced diagonal layouts (hexagonal_tiling.py:75-87).
        use_diag = rs.bernoulli(0.25)
        case = rs.randint(len(DIAGONAL_CASES))
        diag = onehot_take(torch.tensor(DIAGONAL_CASES, dtype=torch.int32, device=dev), case)
        tiles = torch.where(use_diag[:, None], diag, tiles)

    iota = torch.arange(n, dtype=torch.int32, device=dev)
    free = (~(iota[None, :, None] == tiles[:, None, :]).any(dim=2)).to(torch.int32)
    B = tiles.shape[0]
    ts = TilingState(
        free=free,
        ship_tile=tiles[:, 0],
        goal_tile=torch.full((B,), -1, dtype=torch.int32, device=dev),
        case_b=case_b,
        flip_xy=flip_xy,
        col_shift=col_shift,
    )
    radii = torch.tensor(
        [geom.ship_radius] + geom.n_planets * [geom.planets_radius], dtype=dtype, device=dev
    )
    positions = _disk_sample(geom, ts, rs, tiles, radii, dtype)
    return ts, positions[:, 0], positions[:, 1:]


def find_new_goal(geom: TilingGeometry, ts: TilingState, rs: RandSource, dtype=torch.float32):
    """Place a (new) goal on every lane; returns (TilingState, goal_pos (B, 2)).

    Reference flow (hexagonal_tiling.py:95-128): on subsequent goals the ship
    logically moves into the old goal tile; with p=0.25 the goal shares the
    ship tile, otherwise it is the taxi-farthest of <= MAX_GOAL_CANDIDATES
    uniformly drawn free-list entries.
    """
    dev = ts.free.device
    coords = _coords(geom, dev)
    iota = torch.arange(geom.n_tiles, dtype=torch.int32, device=dev)

    subsequent = ts.goal_tile >= 0
    bumped = torch.clamp(ts.free + (iota[None] == ts.ship_tile[:, None]).to(torch.int32),
                         max=MAX_FREE_DUP)
    free = torch.where(subsequent[:, None], bumped, ts.free)
    ship_tile = torch.where(subsequent, ts.goal_tile, ts.ship_tile)

    same = rs.bernoulli(0.25)
    B = free.shape[0]
    scores = rs.scores(geom.n_tiles * MAX_FREE_DUP).reshape(B, geom.n_tiles, MAX_FREE_DUP)
    dup = torch.arange(MAX_FREE_DUP, device=dev)
    entry_valid = dup[None, None, :] < free[:, :, None]
    masked = torch.where(entry_valid, scores, -1.0).reshape(B, -1)
    k_cand = min(MAX_GOAL_CANDIDATES, geom.n_tiles * MAX_FREE_DUP)
    # k_cand sequential masked max/argmax passes (descending, ties to the
    # lower index: torch.argmax returns the first maximum).
    entry_iota = torch.arange(masked.shape[1], dtype=torch.int32, device=dev)
    work = masked
    tv, tf = [], []
    for _ in range(k_cand):
        tv.append(work.max(dim=1).values)
        tf.append(torch.argmax(work, dim=1).to(torch.int32))
        work = torch.where(entry_iota[None] == tf[-1][:, None], -2.0, work)
    top_vals, top_flat = torch.stack(tv, 1), torch.stack(tf, 1)
    top_idx = torch.div(top_flat, MAX_FREE_DUP, rounding_mode="floor").to(torch.int32)
    valid = top_vals >= 0

    ship_rc = onehot_take(coords, ship_tile)          # (B, 2)
    cand_rc = onehot_take(coords, top_idx)            # (B, k, 2)
    taxi = (cand_rc - ship_rc[:, None, :]).abs().sum(-1, dtype=torch.int32)
    taxi = torch.where(valid, taxi, -1)
    pick = torch.argmax(taxi, dim=1, keepdim=True)
    best = torch.gather(top_idx, 1, pick)[:, 0]

    goal_tile = torch.where(same, ship_tile, best)
    free = torch.where(same[:, None], free,
                       free - (iota[None] == best[:, None]).to(torch.int32))

    new_ts = TilingState(
        free=free,
        ship_tile=ship_tile,
        goal_tile=goal_tile,
        case_b=ts.case_b,
        flip_xy=ts.flip_xy,
        col_shift=ts.col_shift,
    )
    goal_pos = _disk_sample(
        geom, new_ts, rs, goal_tile,
        torch.tensor(geom.goal_radius, dtype=dtype, device=dev), dtype,
    )
    return new_ts, goal_pos
