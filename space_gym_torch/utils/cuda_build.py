"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/lib<name>.so` under the
repository (or installed package) root, compiled for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) with a plain C interface; nothing
includes PyTorch's headers, so one file builds in seconds.  A library is
rebuilt when the hash of its sources (the .cu and every csrc/*.cuh) no longer
matches the stamp written beside it after the last successful build.

`build_all()` starts one nvcc per stale source at once, waits for all of them
and returns each build's seconds and ptxas report; `load(name)` builds on
first use and returns the ctypes handle.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
# -fmad=false: no contraction of a*b+c into an FMA, so every operation rounds
# as in the JAX and PyTorch twins; contracted, a*a - b*b of the Kepler reward
# went negative for near-circular orbits and its square root NaN.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_build_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    return src, lib, lib + ".sha"


def _fresh(name: str) -> bool:
    src, lib, stamp = _paths(name)
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == _digest(src)


def _start(name: str):
    src, lib, _ = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib + ".tmp", src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> str:
    src, lib, stamp = _paths(name)
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out[-8000:]}")
    os.replace(lib + ".tmp", lib)
    with open(stamp, "w") as f:  # only after a successful build
        f.write(_digest(src))
    return out


def build_all(names=None) -> dict[str, tuple[float, str]]:
    """Build every stale kernel library, one nvcc per source, all at once.
    Returns {name: (seconds since the builds started, nvcc/ptxas output)}."""
    if names is None:
        names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu")))
    reports = {}
    with _build_lock:
        t0 = time.perf_counter()
        procs = {n: _start(n) for n in names if not _fresh(n)}
        try:
            for n, proc in procs.items():
                out = _finish(n, proc)
                reports[n] = (time.perf_counter() - t0, out)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first if stale."""
    build_all([name])
    return ctypes.CDLL(_paths(name)[1])
