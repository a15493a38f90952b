"""The JAX package's spelling of the engine's options, mapped in one place.

`space_gym_tpu` and this package name the same options differently:

    space_gym_tpu                       space_gym_torch
    EnvEngine(physics="pallas")         EnvEngine(physics="kernel")
    EnvEngine(pallas_fuse=...)          EnvEngine(fuse=...)
    EnvEngine(pallas_tableau=...)       EnvEngine(tableau=...)
    EnvEngine(in_kernel_rng="hw")       EnvEngine(in_kernel_rng="philox")
    SpaceGymEnv(physics="jax")          SpaceGymEnv(physics="device")

`VectorEnv` and `make` pass their keyword arguments through here, so either
spelling works there; `EnvEngine` itself takes only its own and refuses the
other.  This is the only module of the package that knows JAX's spelling.
"""
from __future__ import annotations

ENGINE_NAMES = {"pallas_fuse": "fuse", "pallas_tableau": "tableau"}
ENGINE_PHYSICS = {"pallas": "kernel"}
RNG_MODES = {"hw": "philox"}
ADAPTER_PHYSICS = {"jax": "device"}


def engine_options(**kwargs) -> dict:
    """`EnvEngine` keyword arguments in the port's spelling, from either.

    Refuses `auto_reset=False` on the full-step kernel (physics="kernel",
    fuse="full", the engine's defaults): that kernel resets done lanes
    always, and the JAX engine's full-fused step ignores `auto_reset`
    there, so no spelling of that request means what it says."""
    out = {}
    for key, value in kwargs.items():
        name = ENGINE_NAMES.get(key, key)
        if name in out:
            raise TypeError(f"{key!r} and {name!r} name the same option")
        out[name] = value
    if "physics" in out:
        out["physics"] = ENGINE_PHYSICS.get(out["physics"], out["physics"])
    rng = out.get("in_kernel_rng")
    if isinstance(rng, str):
        out["in_kernel_rng"] = RNG_MODES.get(rng, rng)
    if (out.get("auto_reset", True) is False and out.get("physics", "kernel") == "kernel"
            and out.get("fuse", "full") == "full"):
        raise ValueError("auto_reset=False needs a tail tier (physics='fixed' or 'adaptive', "
                         "or fuse='env' or 'physics'): the full-step kernel resets done lanes")
    return out


def adapter_physics(physics: str) -> str:
    """The single-env adapter's physics mode in the port's spelling."""
    return ADAPTER_PHYSICS.get(physics, physics)
