"""SB3-style vectorized env adapter: NumPy in and out over the batched engine.

The reference's users trained through SB3/rl-zoo (reference README.md:57-59),
whose interface is the VecEnv: `reset() -> obs[N, D]`,
`step(actions[N, ...]) -> (obs, rewards, dones, infos)` with implicit
auto-reset and the terminal observation stashed in
`infos[i]["terminal_observation"]`, which is the engine's TimeStep contract.
This adapter lets NumPy training code drive thousands of lanes on the card.

The port of space_gym_tpu/compat/vector_env.py: the engine's randomness
comes from a `torch.Generator` seeded with `seed` instead of a JAX key.
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.config import EnvConfig
from . import spaces
from .options import engine_options


class VectorEnv:
    """N lockstep envs on the engine's device (the card unless `device` says
    otherwise), NumPy at the boundary.  `physics`, `substeps` and the other
    engine options in either package's spelling (compat/options.py).

    >>> venv = VectorEnv("GoalContinuous2P-v0", num_envs=4096)
    >>> obs = venv.reset()
    >>> obs, rewards, dones, infos = venv.step(actions)
    """

    def __init__(
        self,
        env_id_or_config,
        num_envs: int,
        seed: int = 0,
        physics: str = "fixed",
        substeps: int = 2,
        device=None,
        **engine_kwargs,
    ):
        from ..engine import EnvEngine
        from ..registry import get_config

        config = env_id_or_config
        if not isinstance(config, EnvConfig):
            config = get_config(env_id_or_config)
        self.config = config
        self.num_envs = num_envs
        self.engine = EnvEngine(config, device=device, **engine_options(
            physics=physics, substeps=substeps, **engine_kwargs))
        self._generator = self.engine.generator(seed)
        self._state = None

        low, high = config.observation_bounds()
        self.observation_space = spaces.Box(low, high, dtype=np.float32)
        if config.continuous:
            ones = np.ones(2, dtype=np.float32)
            self.action_space = spaces.Box(-ones, ones, dtype=np.float32)
        else:
            self.action_space = spaces.Discrete(config.n_actions)

    def seed(self, seed: int):
        self._generator = self.engine.generator(seed)
        return [seed]

    def reset(self) -> np.ndarray:
        self._state, obs = self.engine.init(self.num_envs, self._generator)
        return obs.cpu().numpy()

    def step(self, actions: np.ndarray):
        assert self._state is not None, "Call reset() first"
        dtype = torch.float32 if self.config.continuous else torch.int32
        actions = torch.as_tensor(np.asarray(actions), dtype=dtype, device=self.engine.device)
        self._state, ts = self.engine.step(self._state, actions, self._generator)
        return self._to_host(ts)

    def _to_host(self, ts):
        """The TimeStep as NumPy arrays and the `infos` list."""
        obs = ts.obs.cpu().numpy()
        rewards = ts.reward.cpu().numpy()
        dones = ts.done.cpu().numpy()
        truncated = ts.truncated.cpu().numpy()
        infos = [{} for _ in range(self.num_envs)]
        done_lanes = np.flatnonzero(dones)
        if done_lanes.size:
            final_obs = ts.final_obs.cpu().numpy()
            for i in done_lanes:
                infos[i] = {"terminal_observation": final_obs[i]}
                if truncated[i]:
                    infos[i]["TimeLimit.truncated"] = True
        return obs, rewards, dones, infos

    def close(self):
        pass
