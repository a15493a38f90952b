"""Gymnasium-style (new-Gym-API) adapter over the bitwise parity env.

The reference speaks the OLD Gym API — reset() -> obs, 4-tuple step, seed()
method (SURVEY.md Q13) — and the drop-in twin (compat/gym_api.py) reproduces
it bitwise.  Modern trainers (SB3 >= 2, CleanRL, gymnasium wrappers) expect
the NEW API instead: reset(seed=...) -> (obs, info), 5-tuple
step -> (obs, reward, terminated, truncated, info).  This thin wrapper maps
between the two so such trainers run unmodified, with the SAME underlying
bitwise-parity semantics:

* `terminated` = the reference's physics `done` (crash / out-of-world /
  omega cap), `truncated` = gym TimeLimit expiry — recovered from the old
  API's `info["TimeLimit.truncated"]` exactly the way gymnasium's own
  compatibility shim does.  On a simultaneous physics-done + time-limit step
  the old wrapper reports done with truncated=False (TimeLimit semantics),
  which maps to terminated=True, truncated=False here.
* `reset(seed=...)` calls the old `seed()` then `reset()`, so trajectories
  match the reference under the same seed.

Usage:
    env = space_gym_torch.make_gymnasium("GoalContinuous2P-v0")
    obs, info = env.reset(seed=42)
    obs, reward, terminated, truncated, info = env.step(action)

The port of space_gym_tpu/compat/gymnasium_api.py.
"""
from __future__ import annotations


class GymnasiumAdapter:
    """New-API facade over a compat.gym_api adapter instance."""

    metadata = {"render_modes": ["human", "rgb_array"]}

    def __init__(self, env, render_mode: str | None = None):
        self._env = env
        self.render_mode = render_mode
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    # ----------------------------------------------------------- core API --
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._env.seed(seed)
        obs = self._env.reset()
        return obs, {}

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        truncated = bool(info.get("TimeLimit.truncated", False))
        terminated = bool(done) and not truncated
        info = {k: v for k, v in info.items() if k != "TimeLimit.truncated"}
        return obs, reward, terminated, truncated, info

    def render(self):
        if self.render_mode is None:
            return None
        return self._env.render(mode=self.render_mode)

    def close(self):
        self._env.close()

    # --------------------------------------------------------- passthrough --
    @property
    def unwrapped(self):
        return self._env

    def __getattr__(self, name):
        # config, planets_pos, goal_pos, vector_field, ... stay reachable
        return getattr(self._env, name)

    def __repr__(self):
        return f"GymnasiumAdapter({self._env!r})"


def make_gymnasium(env_id: str, render_mode: str | None = None, **kwargs):
    """space_gym_torch.make with the new-API facade.  kwargs (physics=...,
    time_limit=..., device=...) pass through to the underlying adapter."""
    from .. import make

    return GymnasiumAdapter(make(env_id, **kwargs), render_mode=render_mode)
