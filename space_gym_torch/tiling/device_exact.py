"""Sequential-exact twin of the hexagonal-tiling sampler (parity tier).

Counterpart of space_gym_tpu/tiling/device_exact.py, on lane-first `(B, ...)`
tensors.  The production sampler (tiling/device.py) is a branchless,
distribution-equivalent rewrite: right for throughput, useless as a bitwise
oracle.  This module is the reference sampler's arithmetic
(gym_space/hexagonal_tiling.py:53-158) as fixed-shape tensor ops whose float
operations happen in the reference's order, so that the recorded MT19937
DRAWS reproduce the reference's ship, planet and goal positions bit for bit.

A "draw" in the feed is the direct output of one reference RNG call: float
uniforms verbatim (case/flip, column shifts, the p=0.25 gates, disk radius
fractions), range-scaled uniforms as RandomState.uniform(0, 2pi) returns
them (disk angles), and the integer outputs of randint and choice without
replacement, which cannot be reproduced from float uniforms.  Everything
downstream of the draws (column-shift normalisation, tile centres, the
uniform-disk assembly, the ordered free list, the taxi-distance argmax) runs
here, on the engine's device.

The free list is the reference's ORDERED python list: `TilingState.free`
holds it as a `(B, cap)` int32 tensor of tile numbers, -1 past the end,
where the production sampler keeps `(B, n_tiles)` counts per tile in the
same field.  Run it inside ops/exact.py's `parity()`: its cos, sin and sqrt
are then libm's and its divisions true divisions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import exact
from .device import TilingState
from .geometry import DIAGONAL_CASES, MAX_GOAL_CANDIDATES, TilingGeometry

# Free-list capacity headroom above n_tiles: the reference's free list grows
# by one entry per goal-reuse draw (find_new_goal appends the old ship tile
# unconditionally and pops only on the non-reuse branch,
# hexagonal_tiling.py:104,128).  Golden episodes reach the goal a handful of
# times; the feed builder asserts the true episode never exceeds this.
FREE_CAP_EXTRA = 48


class ExactTilingConsts(NamedTuple):
    """Static per-config constants, computed on the HOST with the numpy
    expressions of tiling/host.py (itself the bitwise oracle of
    hexagonal_tiling.py:136-158), so every static subexpression is bit-equal
    by construction."""

    static_x: tuple          # per tile: col * 1.5 * a
    cy_case_a: tuple         # per tile: full y centre, case A
    cy_case_b: tuple         # per tile: full y centre, case B
    tzx: float               # tile-zero x
    free_x_space: float      # world_size - tiling_width
    nr2_reset: tuple         # (hex_height/2 - radius)**2 per reset object
    nr2_goal: float          # the goal's, by python pow (host.py's goal call)
    col_of: tuple            # per tile: column index
    coords: tuple            # (row, col) per tile
    cap: int                 # free-list buffer size


def make_exact_consts(geom: TilingGeometry) -> ExactTilingConsts:
    coords = np.asarray(geom.tiles_coord)
    row_nrs = coords[:, 0]
    col_nrs = coords[:, 1]
    # hexagonal_tiling.py:136-158 expression order, numpy float64
    static_x = col_nrs * 1.5 * geom.a
    tile_zero_pos_x = -geom.world_size / 2 + geom.hex_width / 2
    tile_zero_pos_y = geom.world_size / 2 - geom.hex_height / 2
    y_shifts_due_rows = -row_nrs * geom.hex_height
    y_shifts_due_cols = -(col_nrs % 2) * geom.hex_height / 2
    cy_case_a = tile_zero_pos_y + (y_shifts_due_rows + y_shifts_due_cols)
    cy_case_b = (tile_zero_pos_y - geom.hex_height / 2) + (
        y_shifts_due_rows + y_shifts_due_cols * -1
    )
    # reset path: noise_radius is a numpy ARRAY, so ** 2 is numpy's square;
    # goal path: python floats, so ** is libm pow
    radii = np.array([geom.ship_radius] + geom.n_planets * [geom.planets_radius])
    nr2_reset = (geom.hex_height / 2 - radii) ** 2
    nr2_goal = (geom.hex_height / 2 - geom.goal_radius) ** 2
    return ExactTilingConsts(
        static_x=tuple(static_x.tolist()),
        cy_case_a=tuple(cy_case_a.tolist()),
        cy_case_b=tuple(cy_case_b.tolist()),
        tzx=float(tile_zero_pos_x),
        free_x_space=float(geom.world_size - geom.tiling_width),
        nr2_reset=tuple(nr2_reset.tolist()),
        nr2_goal=float(nr2_goal),
        col_of=tuple(int(c) for c in col_nrs),
        coords=tuple((int(r), int(c)) for r, c in coords),
        cap=geom.n_tiles + FREE_CAP_EXTRA,
    )


def tile_center_exact(consts: ExactTilingConsts, ts: TilingState, tile_nr):
    """Centre of tile(s) under each lane's case/flip/shift, float ops in the
    hexagonal_tiling.py:136-158 order (two adds for x; y static per case).
    tile_nr: (B,) or (B, M) integers -> (..., 2)."""
    dt, dev = ts.col_shift.dtype, ts.col_shift.device
    tile_nr = tile_nr.long()
    sx = torch.tensor(consts.static_x, dtype=dt, device=dev)[tile_nr]
    col = torch.tensor(consts.col_of, device=dev)[tile_nr]
    shift = torch.gather(ts.col_shift, 1, col.reshape(col.shape[0], -1)).reshape(col.shape)
    cx = consts.tzx + (sx + shift)
    extra = (1,) * (tile_nr.dim() - 1)
    cy = torch.where(ts.case_b.reshape(ts.case_b.shape + extra),
                     torch.tensor(consts.cy_case_b, dtype=dt, device=dev)[tile_nr],
                     torch.tensor(consts.cy_case_a, dtype=dt, device=dev)[tile_nr])
    pos = torch.stack([cx, cy], dim=-1)
    return torch.where(ts.flip_xy.reshape(ts.flip_xy.shape + extra + (1,)), pos.flip(-1), pos)


def _disk_noise(angle, r_u, nr2):
    """uniform_disk_distribution's tail (helpers.py:48-53 via
    hexagonal_tiling.py:130-134): `angle` the range-scaled draw, `r_u` the
    raw radius fraction, `nr2` the host-computed noise_radius**2."""
    r = exact.sqrt(r_u * nr2)
    return r[..., None] * torch.stack([exact.cos(angle), exact.sin(angle)], dim=-1)


# ------------------------------------------------------- ordered free list --
# The reference keeps free tiles as an ORDERED python list; candidate draws
# index into it and pop() shifts it.  Twin: (B, cap) int32, tile numbers,
# -1 past the end.

def _freelist_count(fl):
    return (fl >= 0).sum(1, dtype=torch.int32)


def _freelist_append(fl, x):
    idx = torch.arange(fl.shape[1], dtype=torch.int32, device=fl.device)
    return torch.where(idx[None] == _freelist_count(fl)[:, None], x[:, None].to(fl.dtype), fl)


def _freelist_pop(fl, pos):
    """Remove each lane's entry at index `pos`, shifting the tail left
    (list.pop)."""
    shifted = torch.cat([fl[:, 1:], torch.full_like(fl[:, :1], -1)], dim=1)
    idx = torch.arange(fl.shape[1], device=fl.device)
    return torch.where(idx[None] < pos[:, None], fl, shifted)


def reset_exact(geom: TilingGeometry, consts: ExactTilingConsts, rs, dtype):
    """hexagonal_tiling.py:53-93 from recorded draws.

    Draw slots consumed (in feed order): u_case(2), u_cols(cols),
    [n_planets==2: u_diag(1), diag_idx(1)], tiles(n_planets+1),
    disk angles(n_obj, range-scaled), disk radius fractions(n_obj).
    Returns (TilingState, positions (B, n_obj, 2)), ship first, like the
    reference."""
    n_obj = geom.n_planets + 1
    u_case = rs.take(2)
    case_b = u_case[:, 0] < 0.5
    flip_xy = u_case[:, 1] < 0.5
    dev = u_case.device

    u_cols = rs.take(geom.cols).to(dtype)
    # numpy's cumsum is sequential: a chain of adds reproduces it
    acc = u_cols[:, 0]
    cs = [acc]
    for j in range(1, geom.cols):
        acc = acc + u_cols[:, j]
        cs.append(acc)
    cs = torch.stack(cs, dim=1)
    col_shift = cs * exact.rdivc(consts.free_x_space, cs[:, -1:])

    if geom.n_planets == 2:
        u_diag = rs.take(1)[:, 0]
        diag_idx = rs.take(1)[:, 0].long()
        tiles_feed = rs.take(n_obj).long()
        diag = torch.tensor(DIAGONAL_CASES, device=dev)[diag_idx]
        tiles = torch.where((u_diag < 0.25)[:, None], diag, tiles_feed)
    else:
        tiles = rs.take(n_obj).long()

    # the ordered ascending free list (reference: [i for i in range(n_tiles)
    # if i not in tiles_nrs], hexagonal_tiling.py:92): a stable sort puts the
    # free tiles first, in order
    iota = torch.arange(geom.n_tiles, device=dev)
    taken = (iota[None, :, None] == tiles[:, None, :]).any(dim=2)
    order = torch.sort(taken.to(torch.int32), dim=1, stable=True).indices
    B = tiles.shape[0]
    freelist = torch.full((B, consts.cap), -1, dtype=torch.int32, device=dev)
    freelist[:, :geom.n_tiles] = torch.where(
        iota[None] < (~taken).sum(1, keepdim=True), order, -1).to(torch.int32)

    ts = TilingState(
        free=freelist,
        ship_tile=tiles[:, 0].to(torch.int32),
        goal_tile=torch.full((B,), -1, dtype=torch.int32, device=dev),
        case_b=case_b,
        flip_xy=flip_xy,
        col_shift=col_shift,
    )
    angles = rs.take(n_obj).to(dtype)   # range-scaled uniform(0, 2pi, n)
    r_u = rs.take(n_obj).to(dtype)
    centers = tile_center_exact(consts, ts, tiles).to(dtype)
    nr2 = torch.tensor(consts.nr2_reset, dtype=dtype, device=dev)
    return ts, centers + _disk_noise(angles, r_u, nr2)


def find_new_goal_exact(geom: TilingGeometry, consts: ExactTilingConsts, ts: TilingState, rs,
                        dtype):
    """hexagonal_tiling.py:95-128 from recorded draws.

    Draw slots consumed: u_reuse(1), candidate free-list indices(3, choice
    outputs padded with 0: only the first min(3, len(free)) are live), goal
    disk angle(1, range-scaled), goal disk radius fraction(1).
    Returns (TilingState, goal_pos (B, 2))."""
    fl = ts.free
    dev = fl.device
    subsequent = ts.goal_tile >= 0
    # "ship inherits the old goal tile, old ship tile returns to the free
    # list" (hexagonal_tiling.py:102-105)
    fl = torch.where(subsequent[:, None], _freelist_append(fl, ts.ship_tile), fl)
    ship_tile = torch.where(subsequent, ts.goal_tile, ts.ship_tile)
    count = _freelist_count(fl)

    u_reuse = rs.take(1)[:, 0]
    cand = rs.take(MAX_GOAL_CANDIDATES).long()
    k = torch.clamp(count, max=MAX_GOAL_CANDIDATES)

    coords = torch.tensor(consts.coords, dtype=torch.int32, device=dev)
    ship_rc = coords[ship_tile.long()]
    # the reference's scan: the first strictly greater taxi distance wins
    # (hexagonal_tiling.py:112-121); -1 plays -inf (distances are >= 0)
    best_d = torch.full_like(count, -1)
    best_pos = torch.zeros_like(cand[:, 0])
    for j in range(MAX_GOAL_CANDIDATES):
        # past the live candidates the entry may be -1: clamped, then masked
        tile_j = torch.gather(fl, 1, cand[:, j:j + 1])[:, 0].clamp(min=0)
        taxi_j = (coords[tile_j.long()] - ship_rc).abs().sum(-1, dtype=torch.int32)
        take = (j < k) & (taxi_j > best_d)
        best_d = torch.where(take, taxi_j, best_d)
        best_pos = torch.where(take, cand[:, j], best_pos)

    reuse = u_reuse < 0.25
    goal_tile = torch.where(reuse, ship_tile, torch.gather(fl, 1, best_pos[:, None])[:, 0])
    fl = torch.where(reuse[:, None], fl, _freelist_pop(fl, best_pos))

    new_ts = ts._replace(free=fl, ship_tile=ship_tile, goal_tile=goal_tile)
    g_angle = rs.take(1).to(dtype)   # uniform(0, 2pi, size=1)
    g_ru = rs.take(1).to(dtype)
    center = tile_center_exact(consts, new_ts, goal_tile).to(dtype)
    # host.py's goal call goes through the size-1 vector path, then squeeze
    nr2 = torch.tensor(consts.nr2_goal, dtype=dtype, device=dev)
    return new_ts, center + _disk_noise(g_angle, g_ru, nr2)[:, 0]
