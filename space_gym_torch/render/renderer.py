"""Host-side renderer (visualization layer, off the device hot path).

Replaces the reference's pyglet/OpenGL viewer (gym_space/rendering.py via
gym.envs.classic_control.rendering) with a dependency-light PIL rasterizer
producing the same scene semantics:

* 600-px window scaled to the world square; same world->screen transform
  (rendering.py:11,25-27,167-168)
* planet outline circles (:79-86)
* ship: filled white disc + outline + centre dot (SHIP_BODY_RADIUS=15,
  :119-132), engine triangle at the stern (:88-98)
* exhaust flame lines with opacity = thrust action (:100-117,64)
* torque indicator scaled/mirrored by the torque action (:65,134-138;
  drawn as a curved-arrow glyph instead of the PNG sprite)
* goal X marker (:140-146)
* fading position trail, deque(num_prev_pos_vis) with per-segment decay
  (:40-41,158-165)
* debug mode draws the lidar vectors from the ship (:72-76,170-182;
  enabled for Goal envs like goal.py:71)

`mode="rgb_array"` returns an (H, W, 3) uint8 array; `mode="human"` shows a
live matplotlib window when a display exists and falls back to rgb_array
headlessly.  PIL and matplotlib are imported only when a frame is drawn.

A copy of space_gym_tpu/render/renderer.py.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

MAX_SCREEN_SIZE = 600  # rendering.py:11
SHIP_BODY_RADIUS = 15  # rendering.py:12

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)


class Renderer:
    def __init__(
        self,
        planets_pos,
        planet_radii,
        world_size: float,
        goal_pos: Optional[np.ndarray] = None,
        num_prev_pos_vis: int = 30,
        prev_pos_color_decay: float = 0.85,
        debug_mode: bool = False,
    ):
        self.world_size = float(world_size)
        self.world_scale = MAX_SCREEN_SIZE / self.world_size
        self.size = int(round(self.world_size * self.world_scale))
        self.planets_pos = np.asarray(planets_pos, float)
        self.planet_radii = np.asarray(planet_radii, float)
        self.goal_pos = None if goal_pos is None else np.asarray(goal_pos, float)
        self.prev_ship_pos = deque(maxlen=num_prev_pos_vis)
        self.prev_pos_color_decay = prev_pos_color_decay
        self.debug_mode = debug_mode
        self._fig = None  # lazy matplotlib window for mode="human"

    # ------------------------------------------------------------- controls --
    def reset(self, goal_pos=None):
        """New episode: planets may have moved; trail clears (rendering.py:45-48)."""
        self.move_goal(goal_pos)
        self.prev_ship_pos.clear()

    def move_goal(self, goal_pos):
        if goal_pos is not None:
            self.goal_pos = np.asarray(goal_pos, float)

    def update_planets(self, planets_pos):
        self.planets_pos = np.asarray(planets_pos, float)

    # --------------------------------------------------------------- render --
    def render(self, ship_pose, action, goal_lidar, planets_lidars, mode="human"):
        """ship_pose: [x, y, angle]; action: translated (engine, thruster)."""
        from PIL import Image, ImageDraw

        img = Image.new("RGB", (self.size, self.size), WHITE)
        draw = ImageDraw.Draw(img, "RGBA")

        ship_xy = np.asarray(ship_pose[:2], float)
        angle = float(ship_pose[2])
        sp = self._w2s(ship_xy)
        thrust, torque = (0.0, 0.0) if action is None else (float(action[0]), float(action[1]))

        # Trail first (under everything), fading per segment (rendering.py:158-165).
        self.prev_ship_pos.append(sp)
        opacity = 1.0
        pts = list(self.prev_ship_pos)
        for i in range(1, len(pts)):
            a, b = pts[-i], pts[-i - 1]
            draw.line([tuple(a), tuple(b)], fill=BLACK + (int(255 * opacity),), width=1)
            opacity *= self.prev_pos_color_decay

        # Planet outlines (rendering.py:79-86).
        for pos, r in zip(self.planets_pos, self.planet_radii):
            c = self._w2s(pos)
            pr = r * self.world_scale
            draw.ellipse([c[0] - pr, c[1] - pr, c[0] + pr, c[1] + pr], outline=BLACK)

        # Goal X marker (rendering.py:140-146).
        if self.goal_pos is not None:
            g = self._w2s(self.goal_pos)
            draw.line([g[0] - 10, g[1] - 10, g[0] + 10, g[1] + 10], fill=BLACK)
            draw.line([g[0] - 10, g[1] + 10, g[0] + 10, g[1] - 10], fill=BLACK)

        # Debug lidars (rendering.py:170-182).
        if self.debug_mode:
            if goal_lidar is not None:
                t = self._w2s(ship_xy + np.asarray(goal_lidar))
                draw.line([tuple(sp), tuple(t)], fill=(0, 0, 0, 255))
            if planets_lidars is not None:
                for vec in np.atleast_2d(planets_lidars):
                    t = self._w2s(ship_xy + vec)
                    draw.line([tuple(sp), tuple(t)], fill=(0, 0, 0, 255))

        # Engine triangle at the stern (rendering.py:88-98): apex at the ship
        # centre, base behind it; ship heading is +angle, engine thrusts along
        # -heading so the triangle points along +heading from the stern.
        edge = SHIP_BODY_RADIUS * 1.7
        half_w = np.pi / 8  # engine_width_angle / 2
        p0 = sp
        p1 = self._ship_local(sp, angle, edge, -half_w)
        p2 = self._ship_local(sp, angle, edge, half_w)
        draw.polygon([tuple(p0), tuple(p1), tuple(p2)], fill=BLACK)

        # Exhaust flames, opacity = thrust (rendering.py:100-117,64).
        if thrust > 0:
            alpha = int(255 * min(max(thrust, 0.0), 1.0))
            for fa in np.linspace(-np.pi / 16, np.pi / 16, 3):
                a0 = self._ship_local(sp, angle, SHIP_BODY_RADIUS * 1.9, fa)
                a1 = self._ship_local(sp, angle, SHIP_BODY_RADIUS * 2.2, fa)
                draw.line([tuple(a0), tuple(a1)], fill=BLACK + (alpha,), width=2)

        # Ship body: filled white disc + outline + centre dot (rendering.py:119-132).
        rpx = SHIP_BODY_RADIUS
        draw.ellipse(
            [sp[0] - rpx, sp[1] - rpx, sp[0] + rpx, sp[1] + rpx],
            fill=WHITE,
            outline=BLACK,
        )
        draw.ellipse([sp[0] - 1, sp[1] - 1, sp[0] + 1, sp[1] + 1], fill=(128, 128, 128))

        # Torque indicator: arc arrow whose extent/side mirror the torque
        # action (role of the scaled PNG sprite, rendering.py:65,134-138).
        if abs(torque) > 1e-3:
            extent = 120 * min(abs(torque), 1.0)
            start = -90
            box = [sp[0] - rpx - 6, sp[1] - rpx - 6, sp[0] + rpx + 6, sp[1] + rpx + 6]
            if torque > 0:
                draw.arc(box, start, start + extent, fill=BLACK, width=2)
            else:
                draw.arc(box, start - extent, start, fill=BLACK, width=2)

        frame = np.asarray(img, np.uint8)
        if mode == "rgb_array":
            return frame
        return self._show(frame)

    # ------------------------------------------------------------ internals --
    def _w2s(self, world_pos):
        """World -> screen pixels; screen y grows downward (rendering.py:167-168
        composed with the raster flip)."""
        p = (np.asarray(world_pos, float) + self.world_size / 2) * self.world_scale
        return np.array([p[0], self.size - p[1]])

    def _ship_local(self, sp, angle, radius, rel_angle):
        """Point at polar (radius, angle+rel_angle) from the ship centre, in
        screen coords (y flipped)."""
        a = angle + rel_angle
        return sp + radius * np.array([np.cos(a), -np.sin(a)])

    def _show(self, frame):
        try:
            import os

            import matplotlib
            import matplotlib.pyplot as plt

            if self._fig is None:
                if (matplotlib.get_backend().lower() == "agg"
                        and not os.environ.get("SGT_FORCE_HUMAN")):
                    return frame  # headless: behave like rgb_array
                # SGT_FORCE_HUMAN=1 runs the real window path under Agg
                # (figure + imshow + draw_idle/flush_events all work there)
                # so tests can exercise it without a display.
                plt.ion()
                self._fig, ax = plt.subplots(figsize=(6, 6))
                ax.set_axis_off()
                self._im = ax.imshow(frame)
            else:
                self._im.set_data(frame)
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
            return True
        except Exception:
            return frame

    def close(self):
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None
