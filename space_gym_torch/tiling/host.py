"""Host-side hexagonal-tiling sampler with reference-exact RNG call order.

This backs the old-Gym compatibility adapter's parity mode: it consumes a
legacy `np.random.RandomState` with *exactly* the same draw sequence as the
reference (gym_space/hexagonal_tiling.py:53-134), so resets and mid-episode
goal resampling reproduce the reference bitwise.  The batched engine has its
own sampler (tiling/device.py) with the same distribution.

A copy of space_gym_tpu/tiling/host.py, on this package's tiling/geometry.py.
"""
from __future__ import annotations

import numpy as np

from .geometry import DIAGONAL_CASES, MAX_GOAL_CANDIDATES, TilingGeometry


class HostTiling:
    """Mutable host twin of the reference HexagonalTiling.

    State: case/flip/col-shift of the current episode, occupied/free tiles,
    ship tile, goal tile.  All randomness comes from the RandomState passed to
    `seed()`/constructed here, in the reference's exact call order.
    """

    def __init__(self, geom: TilingGeometry, rng: np.random.RandomState):
        self.geom = geom
        self.rng = rng
        self.case_b = None
        self.flip_xy = None
        self.col_shift = None
        self.free_tiles = None  # python list, reference keeps a list too
        self.ship_tile = None
        self.goal_tile = None
        self._tiles_coord = np.array(geom.tiles_coord)

    def seed(self, rng: np.random.RandomState):
        self.rng = rng

    def reset(self) -> np.ndarray:
        """Sample ship + planet positions; returns (n_objects-1, 2) with the
        ship position first (hexagonal_tiling.py:53-93)."""
        g = self.geom
        self.goal_tile = None

        self.case_b, self.flip_xy = self.rng.uniform(size=2) < 0.5
        col_shift = np.cumsum(self.rng.uniform(size=g.cols))
        free_x_space = g.world_size - g.tiling_width
        self.col_shift = col_shift * (free_x_space / col_shift[-1])

        if g.n_planets == 2 and self.rng.uniform() < 0.25:
            tiles_nrs = np.array(DIAGONAL_CASES[self.rng.randint(4)])
        else:
            tiles_nrs = self.rng.choice(g.n_tiles, size=g.n_planets + 1, replace=False)
        self.ship_tile = tiles_nrs[0]
        self.free_tiles = [i for i in range(g.n_tiles) if i not in tiles_nrs]
        radii = np.array([g.ship_radius] + g.n_planets * [g.planets_radius])
        return self._sample_disc_from_tile(tiles_nrs, radii)

    def find_new_goal(self) -> np.ndarray:
        """Goal (re)sampling (hexagonal_tiling.py:95-128): on subsequent goals
        the ship inherits the old goal tile; 25% chance the new goal shares the
        ship tile, otherwise the taxi-farthest of <=3 random free tiles."""
        g = self.geom
        if self.goal_tile is not None:
            self.free_tiles.append(self.ship_tile)
            self.ship_tile = self.goal_tile

        if self.rng.uniform() < 0.25:
            self.goal_tile = self.ship_tile
        else:
            n_candidates = min(MAX_GOAL_CANDIDATES, len(self.free_tiles))
            cand_idx = self.rng.choice(len(self.free_tiles), size=n_candidates, replace=False)
            best_dist = -np.inf
            best_idx = None
            ship_row, ship_col = self._tiles_coord[self.ship_tile]
            for idx in cand_idx:
                row, col = self._tiles_coord[self.free_tiles[idx]]
                taxi = abs(row - ship_row) + abs(col - ship_col)
                if taxi > best_dist:
                    best_dist = taxi
                    best_idx = idx
            self.goal_tile = self.free_tiles.pop(best_idx)
        return self._sample_disc_from_tile(self.goal_tile, g.goal_radius)

    def _sample_disc_from_tile(self, tile_nr, radius):
        g = self.geom
        center_pos = self._tile_center_pos(tile_nr)
        noise_radius = g.hex_height / 2 - radius
        # uniform_disk_distribution (helpers.py:48-53): angle draw, then radius draw
        size = noise_radius.shape[0] if isinstance(noise_radius, np.ndarray) else 1
        angle = self.rng.uniform(0, 2 * np.pi, size=size)
        r = np.sqrt(self.rng.uniform(size=size) * noise_radius**2)
        noise = np.squeeze(r[:, np.newaxis] * np.stack([np.cos(angle), np.sin(angle)], axis=-1))
        return center_pos + noise

    def _tile_center_pos(self, tile_nr):
        g = self.geom
        tiles = self._tiles_coord[tile_nr]
        row_nrs = tiles[..., 0]
        col_nrs = tiles[..., 1]
        tile_zero_pos_x = -g.world_size / 2 + g.hex_width / 2
        tile_zero_pos_y = g.world_size / 2 - g.hex_height / 2
        if self.case_b:
            tile_zero_pos_y -= g.hex_height / 2
        x_shifts = col_nrs * 1.5 * g.a + self.col_shift[col_nrs]
        y_shifts_due_rows = -row_nrs * g.hex_height
        y_shifts_due_cols = -(col_nrs % 2) * g.hex_height / 2
        if self.case_b:
            y_shifts_due_cols *= -1
        y_shifts = y_shifts_due_rows + y_shifts_due_cols
        center_pos = np.stack([tile_zero_pos_x + x_shifts, tile_zero_pos_y + y_shifts], axis=-1)
        if self.flip_xy:
            return center_pos[..., ::-1]
        return center_pos
