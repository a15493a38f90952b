"""ctypes bindings for the native host physics runtime (native/sgt_native.cpp).

The port of space_gym_tpu/parity/native.py, on its own copy of the C++
source.  The shared library compiles on first use with g++ (-O2
-ffp-contract=off -fno-builtin-pow, for strict IEEE float64 rounding parity)
into build/native/ under the repository root, which git ignores, and is
rebuilt whenever its source-hash stamp no longer matches (utils/native_build.py).
No pybind11, no PyTorch headers: a plain C ABI and ctypes.

`solve_step_native` is a drop-in for compat/host_rk45.py's `solve_step`
specialized to the ship model; the Gym adapter exposes it as
`physics="native"`.  It dlopens numpy's bundled OpenBLAS, as the reference's
numpy and scipy calls do, so that its dot products round as theirs; without
it (`has_blas()` False) the fallback kernels agree within one ulp a step,
not bit for bit.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ..utils.native_build import build_shared, lib_is_fresh, openblas_path

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "sgt_native.cpp")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB = os.path.join(BUILD_DIR, "libsgt_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the shared library; returns an error string or None."""
    # -fno-builtin-pow: gcc otherwise folds std::pow(x, 2.0) back into x*x,
    # undoing the libm-pow parity semantics (numpy scalar ** 2).
    return build_shared(_SRC, _LIB, ["-O2", "-ffp-contract=off", "-fno-builtin-pow"])


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        # Source-hash stamp, not mtime (utils/native_build.py): a fresh
        # checkout must never dlopen a stale binary as the parity oracle.
        if not lib_is_fresh(_SRC, _LIB):
            _build_error = _build()
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(_LIB)
        lib.sgt_native_init.restype = ctypes.c_int
        lib.sgt_native_init.argtypes = [ctypes.c_char_p]
        lib.sgt_has_blas.restype = ctypes.c_int
        blas = openblas_path()
        if blas is not None:
            lib.sgt_native_init(blas.encode())
        lib.sgt_solve_step.restype = ctypes.c_int
        lib.sgt_solve_step.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # y0
            ctypes.c_double, ctypes.c_double,  # engine, thruster
            ctypes.POINTER(ctypes.c_double),  # planets_pos
            ctypes.POINTER(ctypes.c_double),  # planet_masses
            ctypes.POINTER(ctypes.c_double),  # planet_radii
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_planets, steering, f32
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,  # world_size, max_abs_vel_angle
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # t_bound, rtol, atol
            ctypes.POINTER(ctypes.c_double),  # y_out
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def has_blas() -> bool:
    """Whether the library found numpy's OpenBLAS (bitwise parity with the
    host path) rather than its fallback kernels (within one ulp)."""
    lib = _load()
    return lib is not None and bool(lib.sgt_has_blas())


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_step_native(config, state_vec, action, planets_pos):
    """One control interval via the native solver.

    `action` is the translated (engine, thruster) pair; float32 dtype marks
    the continuous envs' mixed-precision arithmetic (spaceship_env.py:69-71).
    Returns (y_final (6,), terminated: bool) like compat/host_rk45.py.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native solver unavailable: {_build_error}")
    y0 = np.ascontiguousarray(state_vec, dtype=np.float64)
    pp = np.ascontiguousarray(planets_pos, dtype=np.float64)
    masses = np.ascontiguousarray(config.planet_masses, dtype=np.float64)
    radii = np.ascontiguousarray(config.planet_radii, dtype=np.float64)
    y_out = np.empty(6, dtype=np.float64)
    f32 = 1 if np.asarray(action).dtype == np.float32 else 0
    ship = config.ship
    rc = lib.sgt_solve_step(
        _dp(y0),
        float(action[0]), float(action[1]),
        _dp(pp), _dp(masses), _dp(radii),
        int(config.n_planets), int(ship.steering), f32,
        float(ship.mass), float(ship.moi),
        float(ship.max_engine_force), float(ship.max_thruster_force),
        float(config.world_size), float(config.max_abs_vel_angle),
        float(config.step_size), 1e-3, 1e-6,
        _dp(y_out),
    )
    if rc < 0:
        raise RuntimeError(f"sgt_solve_step failed with code {rc}")
    return y_out, rc == 1
