"""Closed-form hexagonal-tiling geometry (host-side, static per config).

The reference derives a hexagonal tiling of the square world that guarantees a
collision-free placement of ship + planets + goal
(gym_space/hexagonal_tiling.py; closed form derived in
notebooks/hexagonal_tiling.ipynb).  Everything here is a pure function of the
env config, computed once on the host and kept in the static EnvConfig.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# gym_space/hexagonal_tiling.py:8-10
MAX_OBJ_TILES_RATIO = 0.6
PLANET_TILE_RATIO = 0.75
MAX_GOAL_CANDIDATES = 3

# 2-planet special-case layouts (hexagonal_tiling.py:79-86): (ship, planet, planet)
DIAGONAL_CASES = ((1, 0, 3), (2, 0, 3), (0, 1, 2), (3, 1, 2))


def compute_tiling_rows_cols_a(min_tiles: int, world_size: float) -> tuple[int, int, float]:
    """Rows/cols/hex side length for >= min_tiles tiles in a world_size square
    (hexagonal_tiling.py:161-174, sympy derivation in the reference notebook)."""
    m = min_tiles
    r_ = math.sqrt(72 * math.sqrt(3) * m - 6 * math.sqrt(3) + 12) / 12 - 1 / 4 + math.sqrt(3) / 12
    r = int(math.ceil(r_))
    while True:
        c = int(math.floor(2 * math.sqrt(3) * r / 3 - 1 / 3 + math.sqrt(3) / 3))
        if r * c >= m:
            break
        r += 1
    a = 2 * math.sqrt(3) * world_size / (3 * (2 * r + 1))
    return r, c, a


class TilingGeometry(NamedTuple):
    """Static tiling constants (hexagonal_tiling.py:15-48)."""

    n_planets: int
    world_size: float
    rows: int
    cols: int
    n_tiles: int
    a: float  # hexagon side
    hex_height: float
    hex_width: float
    tiling_width: float
    planets_radius: float
    goal_radius: float
    ship_radius: float
    tiles_coord: tuple[tuple[int, int], ...]  # (row, col) per tile nr


def make_tiling(n_planets: int, world_size: float) -> TilingGeometry:
    n_objects = n_planets + 2
    if n_planets == 2:
        min_tiles = n_objects
    else:
        min_tiles = int(math.ceil(n_objects / MAX_OBJ_TILES_RATIO))
    r, c, a = compute_tiling_rows_cols_a(min_tiles, world_size)
    hex_height = a * math.sqrt(3)
    planets_radius = hex_height / 2 * PLANET_TILE_RATIO
    return TilingGeometry(
        n_planets=n_planets,
        world_size=world_size,
        rows=r,
        cols=c,
        n_tiles=r * c,
        a=a,
        hex_height=hex_height,
        hex_width=2 * a,
        tiling_width=3 * a * (c - 1) / 2 + 2 * a,
        planets_radius=planets_radius,
        goal_radius=planets_radius / 2,
        ship_radius=planets_radius / 2,
        tiles_coord=tuple((row, col) for row in range(r) for col in range(c)),
    )
