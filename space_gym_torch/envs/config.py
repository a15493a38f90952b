"""Typed, hashable environment configs (the reference's Gym registration
kwargs, gym_space/__init__.py), kept field for field equal to
space_gym_tpu.envs.config.

Each registered env ID maps to one immutable `EnvConfig`; the engine bakes
its constants into the kernels' parameter struct, and all per-episode
randomness lives in the dynamic EnvState.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from ..ops.field import STEERING_ACCELERATION, STEERING_VELOCITY, ShipParams
from ..tiling.geometry import TilingGeometry, make_tiling

TASK_DO_NOT_CRASH = "do_not_crash"

# "No TimeLimit" sentinel (the reference registers KeplerDiscrete-v0 without
# max_episode_steps, keyboard_agent.py:10-27, so those episodes only end on
# terminal events).  int32 step counters never reach it in practice.
NO_TIME_LIMIT = 2**31 - 1

# Discrete action table (spaceship_env.py:189-202): action id ->
# (engine in {0,1}, thruster in {-1,0,1}).
DISCRETE_ACTIONS = (
    (0.0, 0.0),
    (1.0, 0.0),
    (0.0, -1.0),
    (0.0, 1.0),
    (1.0, -1.0),  # (raw - 4.5) * 2 for raw=4
    (1.0, 1.0),   # (raw - 4.5) * 2 for raw=5
)


TASK_GOAL = "goal"
TASK_KEPLER = "kepler"


@dataclass(frozen=True)
class GoalTaskParams:
    """GoalEnv reward/placement knobs (gym_space/envs/goal.py:13-30)."""

    survival_reward_scale: float = 0.0
    goal_vel_reward_scale: float = 5.0
    safety_reward_scale: float = 10.0
    goal_sparse_reward: float = 5.0
    danger_zone: float = 0.25
    distance_fctr: float = 100.0  # goal.py:16
    total_planets_mass: float = 1e9  # goal.py:14


@dataclass(frozen=True)
class KeplerTaskParams:
    """KeplerEnv orbit/reward knobs (gym_space/envs/kepler.py:189-231)."""

    randomize: bool = False
    ref_orbit_a: float = 1.2
    ref_orbit_eccentricity: float = 0.5
    ref_orbit_angle: float = 3.75
    numerator_C: float = 0.01
    rad_penalty_C: float = 2.0
    act_penalty_C: float = 0.5
    planet_radius: float = 0.2  # kepler.py:17
    border_radius: float = 3.0  # kepler.py:18
    planet_mass: float = 6e8  # kepler.py:204


@dataclass(frozen=True)
class DncTaskParams:
    """DoNotCrash knobs (gym_space/envs/do_not_crash.py:10-32)."""

    planet_radius: float = 0.25
    border_radius: float = 1.0
    planet_mass: float = 6e8
    reward_per_step: float = 100.0 / 300.0  # do_not_crash.py:47-48


@dataclass(frozen=True)
class EnvConfig:
    env_id: str
    task: str
    continuous: bool
    ship: ShipParams
    n_planets: int  # number of gravitating/crashable planets incl. border "planet"
    planet_masses: tuple
    planet_radii: tuple
    fixed_planet_pos: Optional[tuple]  # ((x, y), ...) or None when tiling-sampled
    world_size: float
    max_abs_vel_angle: float
    step_size: float
    with_lidar: bool
    with_goal: bool
    max_episode_steps: int
    tiling: Optional[TilingGeometry] = None
    goal: Optional[GoalTaskParams] = None
    kepler: Optional[KeplerTaskParams] = None
    dnc: Optional[DncTaskParams] = None
    goal_radius: float = 0.0
    ship_radius: float = 0.0

    @property
    def obs_dim(self) -> int:
        # spaceship_env.py:102-111 (+3 orbit params for Kepler, kepler.py:172-187)
        d = 7
        if self.with_lidar:
            d += 2 * self.n_planets
            if self.with_goal:
                d += 2
        if self.task == TASK_KEPLER:
            d += 3
        return d

    @property
    def n_events(self) -> int:
        return self.n_planets + 3

    @property
    def action_dim(self) -> int:
        return 2

    @property
    def n_actions(self) -> int:
        """Discrete action count (spaceship_env.py:183-187)."""
        return 6

    def observation_bounds(self):
        """(low, high) of the observation space.

        Base env: spaceship_env.py:102-111 (symmetric Box).  Kepler replicates
        quirk Q7 (kepler.py:158-170): the hand-written obs_low is discarded
        upstream and the space is Box(-obs_high, obs_high).
        """
        high = [1.0, 1.0, 1.0, 1.0, math.inf, math.inf, 1.0]
        if self.task == TASK_KEPLER:
            high += [2 * math.pi, 0.7, 2.0]
        if self.with_lidar:
            high += 2 * self.n_planets * [2 * math.sqrt(2)]
            if self.with_goal:
                high += 2 * [2 * math.sqrt(2)]
        return [-h for h in high], high


def goal_config(
    env_id: str,
    n_planets: int,
    continuous: bool,
    *,
    ship_steering: int = STEERING_VELOCITY,
    ship_moi: float = 0.01,
    max_engine_force: float = 0.4,
    survival_reward_scale: float = 0.2,
    goal_vel_reward_scale: float = 5.0,
    safety_reward_scale: float = 10.0,
    goal_sparse_reward: float = 5.0,
    max_episode_steps: int = 500,
) -> EnvConfig:
    """GoalEnv config (goal.py:18-72 + registration kwargs, __init__.py:26-72).

    Only the n_planets >= 2 path exists in practice: the registered IDs use
    2-4 planets and the 1-planet path crashes upstream (quirk Q3).
    """
    assert n_planets >= 2, "1-planet GoalEnv is broken upstream (SURVEY.md Q3)"
    world_size = 3.0  # goal.py:10
    tiling = make_tiling(n_planets, world_size)
    params = GoalTaskParams(
        survival_reward_scale=survival_reward_scale,
        goal_vel_reward_scale=goal_vel_reward_scale,
        safety_reward_scale=safety_reward_scale,
        goal_sparse_reward=goal_sparse_reward,
    )
    mass = params.total_planets_mass / n_planets  # goal.py:43
    return EnvConfig(
        env_id=env_id,
        task=TASK_GOAL,
        continuous=continuous,
        ship=ShipParams(
            steering=ship_steering,
            mass=1.0,
            moi=ship_moi,
            max_engine_force=max_engine_force,
            max_thruster_force=0.05,
        ),
        n_planets=n_planets,
        planet_masses=(mass,) * n_planets,
        planet_radii=(tiling.planets_radius,) * n_planets,
        fixed_planet_pos=None,
        world_size=world_size,
        max_abs_vel_angle=6.0,
        step_size=0.07,
        with_lidar=True,
        with_goal=True,
        max_episode_steps=max_episode_steps,
        tiling=tiling,
        goal=params,
        goal_radius=tiling.goal_radius,
        ship_radius=tiling.ship_radius,
    )


def kepler_config(
    env_id: str,
    continuous: bool = True,
    *,
    randomize: bool = False,
    ref_orbit_a: float = 1.2,
    ref_orbit_eccentricity: float = 0.5,
    ref_orbit_angle: float = 3.75,
    numerator_C: float = 0.01,
    rad_penalty_C: float = 2.0,
    act_penalty_C: float = 0.5,
    step_size: float = 0.1,
    ship_steering: int = STEERING_ACCELERATION,
    ship_moi: float = 0.01,
    max_engine_force: float = 0.4,
    max_episode_steps: int = 500,
) -> EnvConfig:
    """KeplerEnv config (kepler.py:189-231).  Defaults mirror the constructor;
    registered IDs override via gym_space/__init__.py:79-146."""
    params = KeplerTaskParams(
        randomize=randomize,
        ref_orbit_a=ref_orbit_a,
        ref_orbit_eccentricity=ref_orbit_eccentricity,
        ref_orbit_angle=ref_orbit_angle,
        numerator_C=numerator_C,
        rad_penalty_C=rad_penalty_C,
        act_penalty_C=act_penalty_C,
    )
    return EnvConfig(
        env_id=env_id,
        task=TASK_KEPLER,
        continuous=continuous,
        ship=ShipParams(
            steering=ship_steering,
            mass=1.0,
            moi=ship_moi,
            max_engine_force=max_engine_force,
            max_thruster_force=0.05,
        ),
        n_planets=2,  # planet + border (kepler.py:204-206)
        planet_masses=(params.planet_mass, 0.0),
        planet_radii=(params.planet_radius, params.border_radius),
        fixed_planet_pos=((0.0, 0.0), (0.0, 0.0)),
        world_size=2 * params.border_radius,
        max_abs_vel_angle=6.0,
        step_size=step_size,
        with_lidar=False,
        with_goal=False,
        max_episode_steps=max_episode_steps,
        kepler=params,
    )


def dnc_config(env_id: str, continuous: bool) -> EnvConfig:
    """DoNotCrash config (do_not_crash.py:10-32).

    NOTE: upstream HEAD cannot construct this env — ShipParams is called
    without the required `steering` field (quirk Q12; recorded in
    tests/goldens/broken_ids.json).  We rebuild the obvious intent with
    acceleration steering.
    """
    params = DncTaskParams()
    return EnvConfig(
        env_id=env_id,
        task=TASK_DO_NOT_CRASH,
        continuous=continuous,
        ship=ShipParams(
            steering=STEERING_ACCELERATION,
            mass=1.0,
            moi=0.05,
            max_engine_force=0.3,
            max_thruster_force=0.05,
        ),
        n_planets=2,  # planet + border (do_not_crash.py:16-18)
        planet_masses=(params.planet_mass, 0.0),
        planet_radii=(params.planet_radius, params.border_radius),
        fixed_planet_pos=((0.0, 0.0), (0.0, 0.0)),
        world_size=2 * params.border_radius,
        max_abs_vel_angle=5.0,
        step_size=0.07,
        with_lidar=False,
        with_goal=False,
        max_episode_steps=300,
        dnc=params,
    )
