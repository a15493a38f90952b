"""Env-ID registry (gym_space/__init__.py:1-147): all 10 upstream IDs plus
the extra discrete variants the reference registers inside
keyboard_agent.py:10-74.

`get_config(env_id)` returns the static EnvConfig; the batched engine is
built from the config via space_gym_torch.engine.
"""
from __future__ import annotations

from typing import Callable, Dict

from .envs.config import NO_TIME_LIMIT, EnvConfig, dnc_config, goal_config, kepler_config

_REGISTRY: Dict[str, Callable[[], EnvConfig]] = {}


def register(env_id: str, factory: Callable[[], EnvConfig]) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"Cannot re-register id: {env_id}")
    _REGISTRY[env_id] = factory


def env_ids():
    return sorted(_REGISTRY)


def get_config(env_id: str) -> EnvConfig:
    try:
        factory = _REGISTRY[env_id]
    except KeyError:
        raise KeyError(
            f"Unknown env id {env_id!r}; known ids: {', '.join(env_ids())}"
        ) from None
    return factory()


# --- DoNotCrash (gym_space/__init__.py:5-15; rebuilt per quirk Q12) ---
register("DoNotCrashDiscrete-v0", lambda: dnc_config("DoNotCrashDiscrete-v0", continuous=False))
register("DoNotCrashContinuous-v0", lambda: dnc_config("DoNotCrashContinuous-v0", continuous=True))

# --- Goal (gym_space/__init__.py:20-72) ---
# GoalDiscrete-v0 is registered upstream without the three required reward
# kwargs and cannot be constructed (quirk Q14); rebuilt with the continuous
# variants' tuned values.
register(
    "GoalDiscrete-v0",
    lambda: goal_config("GoalDiscrete-v0", n_planets=2, continuous=False, max_episode_steps=1000),
)
for _n in (2, 3, 4):
    register(
        f"GoalContinuous{_n}P-v0",
        lambda _n=_n: goal_config(f"GoalContinuous{_n}P-v0", n_planets=_n, continuous=True),
    )

# --- Kepler (gym_space/__init__.py:76-146; shared step_size=0.07) ---
register(
    "KeplerCircleOrbit-v0",
    lambda: kepler_config(
        "KeplerCircleOrbit-v0",
        ship_steering=1,
        ship_moi=0.01,
        rad_penalty_C=2,
        numerator_C=0.01,
        act_penalty_C=0.5,
        step_size=0.07,
        randomize=False,
        ref_orbit_a=1.2,
        ref_orbit_eccentricity=0.0,
        ref_orbit_angle=0.0,
    ),
)
register(
    "KeplerEllipseEasy-v0",
    lambda: kepler_config(
        "KeplerEllipseEasy-v0",
        ship_steering=1,
        ship_moi=0.01,
        step_size=0.07,
        randomize=False,
        ref_orbit_a=1.2,
        ref_orbit_eccentricity=0.5,
        ref_orbit_angle=0.8,
    ),
)
register(
    "KeplerEllipseHard-v0",
    lambda: kepler_config(
        "KeplerEllipseHard-v0",
        ship_steering=1,
        ship_moi=0.01,
        step_size=0.07,
        randomize=False,
        ref_orbit_a=1.2,
        ref_orbit_eccentricity=0.725,
        ref_orbit_angle=3.925,
    ),
)
register(
    "KeplerRandomOrbits-v0",
    lambda: kepler_config(
        "KeplerRandomOrbits-v0",
        ship_steering=1,
        ship_moi=0.01,
        step_size=0.07,
        randomize=True,
    ),
)

# --- Extra IDs registered by the reference's keyboard agent (keyboard_agent.py:10-74) ---
for _n in (2, 3, 4):
    register(
        f"GoalDiscrete{_n}-v0",
        lambda _n=_n: goal_config(
            f"GoalDiscrete{_n}-v0", n_planets=_n, continuous=False, max_engine_force=1.0
        ),
    )
register(
    "KeplerDiscrete-v0",
    lambda: kepler_config(
        "KeplerDiscrete-v0",
        continuous=False,
        ship_steering=1,
        ship_moi=0.01,
        max_engine_force=0.4,
        step_size=0.07,
        randomize=False,
        ref_orbit_a=1.2,
        ref_orbit_eccentricity=0.0,
        ref_orbit_angle=0.0,
        # The reference registers this ID with NO max_episode_steps
        # (keyboard_agent.py:10-27): episodes end only on terminal events.
        max_episode_steps=NO_TIME_LIMIT,
    ),
)
