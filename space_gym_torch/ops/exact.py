"""Switchable numpy-exact math for the device parity tier.

Counterpart of space_gym_tpu/ops/exact.py, with the same names.  Outside the
parity mode every function is the plain PyTorch expression the engine has
always computed, so every other tier and every kernel's twin keeps its bits.

In the parity mode the functions compute what the reference's numpy computes,
bit for bit: np.linalg.norm and np.dot through the OpenBLAS that numpy
bundles (dlopen'ed by parity/native/sgt_exactmath.cpp), pow, cos, sin and
(on the CPU) sqrt through libm, atan2 through np.arctan2 itself, and
divisions by a constant as true divisions.  On a CPU tensor a function calls the library on the
tensor's own memory, with no copy; on a CUDA tensor it copies the operands
to the host, calls the same library and copies the result back.  That round
trip is the definition of these ops (numpy's BLAS and libm exist only on the
host), not a fallback; `counts["round_trips"]` counts them and
`counts["calls"]` every call into the host library.

The mode is scoped, not global: `with parity():` turns it on for the
current thread until the block exits, and `enabled()` reads it.  The parity
engine (parity/device_replay.py) enters it around its own reset and step
and nothing else does, so other engines in the same process are unaffected.
This departs on purpose from the JAX package, whose mode is a process-wide
environment variable (SGT_EXACT_MATH=1) read at trace time together with
XLA flags that stop XLA from fusing multiply-adds and rewriting divisions,
which forces its replay into a subprocess.  PyTorch needs neither: its eager
ops do not contract `a*b + c` across ops, and a division by a tensor is a
true division.  Only the mechanism differs; the arithmetic is the same.

Two PyTorch habits the parity mode steps around: `c / x` with a Python
number `c` is `x.reciprocal() * c` (`rdivc` divides instead), and on the
card `x / c` multiplies by the reciprocal of a host scalar (`divc` divides
by a tensor holding `c` on `x`'s device).  The library builds at first use
with g++ into build/native/, which git ignores, whenever its source-hash
stamp is stale (utils/native_build.py); a failed build, or a numpy without
its bundled OpenBLAS, raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..utils.native_build import build_shared, lib_is_fresh, openblas_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "parity", "native", "sgt_exactmath.cpp")
_LIB = os.path.join(os.path.dirname(_PKG), "build", "native", "libsgt_exactmath.so")

# Coefficient-vector selectors of kt_dot (dp_coeffs in the .cpp); 1..5 are
# the rows of Dormand-Prince's A.
WHICH_B = 6
WHICH_E = 7

counts = {"calls": 0, "round_trips": 0}

_mode = threading.local()
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """Whether this thread is inside `parity()`."""
    return getattr(_mode, "on", False)


@contextlib.contextmanager
def parity():
    """The parity mode for this thread, until the block exits."""
    prev = enabled()
    _mode.on = True
    try:
        yield
    finally:
        _mode.on = prev


def load() -> ctypes.CDLL:
    """The library, built and its BLAS loaded on first use; raises with the
    compiler's or the loader's words where either fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # source-hash stamp, not mtime: a fresh checkout must never dlopen a
        # stale binary as the parity oracle
        if not lib_is_fresh(_SRC, _LIB):
            err = build_shared(_SRC, _LIB, ["-std=c++17", "-O2", "-ffp-contract=off"])
            if err is not None:
                raise RuntimeError(f"sgt_exactmath did not build: {err}")
        lib = ctypes.CDLL(_LIB)
        blas = openblas_path()
        if blas is None:
            raise RuntimeError("numpy bundles no OpenBLAS (numpy.libs/libscipy_openblas*.so): "
                               "the parity tier has no np.dot to reproduce")
        lib.sgt_exact_init.argtypes = [ctypes.c_char_p]
        lib.sgt_exact_error.restype = ctypes.c_char_p
        if lib.sgt_exact_init(blas.encode()) != 0:
            raise RuntimeError(f"sgt_exactmath could not load {blas}: "
                               f"{lib.sgt_exact_error().decode()}")
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        for name, args in (("pow", [ptr, ctypes.c_double, ptr, i64]),
                           ("atan2", [ptr, ptr, ptr, i64]),
                           ("cos", [ptr, ptr, i64]), ("sin", [ptr, ptr, i64]),
                           ("sqrt", [ptr, ptr, i64]),
                           ("norm_last", [ptr, i64, i64, ptr]),
                           ("norm_last_f32", [ptr, i64, i64, ptr]),
                           ("kt_dot", [ptr, i64, i64, i64, i64, ptr]),
                           ("ktp", [ptr, i64, i64, ptr]),
                           ("dot_mv", [ptr, ptr, i64, i64, i64, ptr])):
            fn = getattr(lib, "sgt_exact_" + name)
            fn.argtypes, fn.restype = args, None
        _lib = lib
        return lib


def _on_host(fn, out_shape, out_dtype, *xs):
    """Run `fn(*host operands, out)` for operands on any one device: the
    tensors themselves on the CPU (made contiguous), host copies of them on
    the card, the result copied back there."""
    dev = xs[0].device
    if dev.type != "cpu":
        counts["round_trips"] += 1
        xs = [x.cpu() for x in xs]
    xs = [x.contiguous() for x in xs]
    out = torch.empty(out_shape, dtype=out_dtype)
    fn(*xs, out)
    counts["calls"] += 1
    return out if dev.type == "cpu" else out.to(dev)


def _f64(x):
    return x.to(torch.float64)


# ---------------------------------------------------------------- functions --

def divc(x, c):
    """x / c for a constant c: a true division.  The card divides by a host
    scalar as a multiplication by its reciprocal (1 ulp off whenever 1/c is
    inexact), so the parity mode divides by a tensor holding c on x's
    device.  On the CPU that changes no bit."""
    if not enabled():
        return x / c
    return x / torch.as_tensor(c, dtype=x.dtype, device=x.device)


def rdivc(c, x):
    """c / x for a constant c: a true division.  PyTorch computes `c / x`
    as `x.reciprocal() * c`, so the parity mode divides a tensor holding c
    instead."""
    if not enabled():
        return c / x
    return torch.as_tensor(c, dtype=x.dtype, device=x.device) / x


def powf(x, e: float):
    """x ** e with a static exponent through libm pow (the scipy controller's
    and the reference's numpy-scalar pow)."""
    if not enabled():
        return x ** e
    lib = load()
    x = _f64(x)
    return _on_host(lambda a, o: lib.sgt_exact_pow(a.data_ptr(), float(e), o.data_ptr(), a.numel()),
                    x.shape, torch.float64, x)


def atan2(y, x):
    """np.arctan2 twin (lidar obs, Kepler orbit angles).  numpy >= 2 ships
    its own float64 atan2, 1 ulp from libm on about 8% of inputs, so the
    parity mode calls np.arctan2 itself."""
    if not enabled():
        return torch.atan2(y, x)
    y, x = torch.broadcast_tensors(_f64(y), _f64(x))
    return _on_host(lambda b, a, o: np.arctan2(b.numpy(), a.numpy(), out=o.numpy()),
                    y.shape, torch.float64, y, x)


def _libm(name, x):
    lib = load()
    fn = getattr(lib, "sgt_exact_" + name)
    x = _f64(x)
    return _on_host(lambda a, o: fn(a.data_ptr(), o.data_ptr(), a.numel()), x.shape,
                    torch.float64, x)


def cos(x):
    """libm cos (numpy's float64 cos on the host that recorded the goldens)."""
    return _libm("cos", x) if enabled() else torch.cos(x)


def sin(x):
    """libm sin."""
    return _libm("sin", x) if enabled() else torch.sin(x)


def sqrt(x):
    """The IEEE square root, numpy's: PyTorch's vectorized CPU sqrt is an
    ulp off on about 0.7% of float64 inputs, so on the CPU the parity mode
    calls the library.  The card's torch.sqrt is the IEEE one: no round
    trip."""
    if not enabled() or x.device.type != "cpu":
        return torch.sqrt(x)
    return _libm("sqrt", x)


def norm_last(v):
    """np.linalg.norm over the trailing axis: numpy's 1-D norm is
    sqrt(BLAS-dot(x, x)), not a sequential sum of squares.  float32 stays
    float32 (sdot), as the reference's float32 action norm does."""
    if not enabled():
        return torch.linalg.norm(v, dim=-1)
    lib = load()
    f32 = v.dtype == torch.float32
    if not f32:
        v = _f64(v)
    n = v.shape[-1]
    fn = lib.sgt_exact_norm_last_f32 if f32 else lib.sgt_exact_norm_last
    return _on_host(lambda a, o: fn(a.data_ptr(), a.numel() // n, n, o.data_ptr()),
                    v.shape[:-1], v.dtype, v)


def kt_dot(k_stacked, which: int):
    """np.dot(K[:s].T, coeffs) of the RK45 stage combinations; `which`
    selects the Dormand-Prince coefficient vector (1..5 = A row, 6 = B,
    7 = E).  k_stacked: (..., s, n) -> (..., n)."""
    if not enabled():
        raise RuntimeError("kt_dot is parity-mode only; use _wsum otherwise")
    lib = load()
    k = _f64(k_stacked)
    rows, n = k.shape[-2:]
    if not 1 <= which <= WHICH_E or rows < which:
        raise ValueError(f"kt_dot({which}) reads {which} stages, got {rows}")
    return _on_host(lambda a, o: lib.sgt_exact_kt_dot(a.data_ptr(), a.numel() // (rows * n), rows,
                                                      n, int(which), o.data_ptr()),
                    k.shape[:-2] + (n,), torch.float64, k)


def ktp(k_stacked):
    """Q = np.dot(K.T, P): (..., 7, n) -> (..., n, 4)."""
    if not enabled():
        raise RuntimeError("ktp is parity-mode only; use dense_q otherwise")
    lib = load()
    k = _f64(k_stacked)
    n = k.shape[-1]
    if k.shape[-2] != 7:
        raise ValueError(f"ktp takes the 7 stages, got {k.shape[-2]}")
    return _on_host(lambda a, o: lib.sgt_exact_ktp(a.data_ptr(), a.numel() // (7 * n), n,
                                                   o.data_ptr()),
                    k.shape[:-2] + (n, 4), torch.float64, k)


def dot_mv(a, x):
    """np.dot(A, x) for small row-major matrices A (..., m, n) and vectors
    x (..., n) (the dense output's Q @ p, the Kepler 2x2 rotation)."""
    if not enabled():
        return (a @ x[..., None])[..., 0]
    lib = load()
    a, x = _f64(a), _f64(x)
    m, n = a.shape[-2:]
    if x.shape != a.shape[:-2] + (n,):
        raise ValueError(f"dot_mv of {tuple(a.shape)} and {tuple(x.shape)}")
    return _on_host(lambda A, X, o: lib.sgt_exact_dot_mv(A.data_ptr(), X.data_ptr(),
                                                         A.numel() // (m * n), m, n, o.data_ptr()),
                    a.shape[:-1], torch.float64, a, x)


class ExactNamespace:
    """The operations envs/kepler_math.py takes from its `xp` argument, each
    through the exact functions above: handed to it in the parity mode."""

    class _Linalg:
        @staticmethod
        def norm(v):
            return norm_last(v)

    linalg = _Linalg()
    cos = staticmethod(cos)
    sin = staticmethod(sin)
    sqrt = staticmethod(sqrt)
    arctan2 = staticmethod(atan2)
    rdiv = staticmethod(rdivc)
    dot = staticmethod(dot_mv)

    @staticmethod
    def pow2(v):
        """v ** 2 through libm pow: numpy SCALAR ** 2 semantics."""
        return powf(v, 2)


exact_xp = ExactNamespace()
