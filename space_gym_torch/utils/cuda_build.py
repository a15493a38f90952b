"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/lib<name>.so` under the
repository (or installed package) root, compiled for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) with a plain C interface; nothing
includes PyTorch's headers, so one file builds in seconds.  A library is
rebuilt when the hash of its sources (the .cu and every csrc/*.cuh) and flags
no longer matches the stamp written beside it after the last successful build.

The env kernels (fused_step, env_step, full_step, full_step_threefry,
full_step_philox) build with `-fmad=false`: they are held to their plain
versions operation for operation.  The learner kernels (sac_update,
sac_update_fold, td3_update: `FMA_SOURCES`) build with nvcc's default contraction into
fused multiply-adds: they are chains of matrix products held to a tolerance,
and the flag would cost up to half the multiply-add rate.

`build_all()` starts one nvcc per stale source at once, waits for all of them
and returns each build's seconds and ptxas report; `load(name)` builds on
first use and returns the ctypes handle; `sass_count(name, opcode)` counts an
instruction in the built library's SASS.
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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
# Every source but these builds with -fmad=false: no contraction of a*b+c into
# an FMA, so every operation rounds as in the JAX and PyTorch twins;
# contracted, a*a - b*b of the Kepler reward went negative for near-circular
# orbits and its square root NaN.
FMA_SOURCES = frozenset({"sac_update", "sac_update_fold", "td3_update"})


def nvcc_flags(name: str) -> list[str]:
    """The flags of csrc/<name>.cu: `-fmad=false` unless it is in FMA_SOURCES."""
    return NVCC_FLAGS + ([] if name in FMA_SOURCES else ["-fmad=false"])

_build_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest(name: str) -> str:
    src = _paths(name)[0]
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(nvcc_flags(name)).encode())
    return h.hexdigest()


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    return src, lib, lib + ".sha"


def _fresh(name: str) -> bool:
    _, lib, stamp = _paths(name)
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == _digest(name)


def _start(name: str):
    src, lib, _ = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *nvcc_flags(name), "-o", lib + ".tmp", src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> str:
    src, lib, stamp = _paths(name)
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out[-8000:]}")
    os.replace(lib + ".tmp", lib)
    with open(stamp, "w") as f:  # only after a successful build
        f.write(_digest(name))
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


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of SASS `opcode` (e.g. "HMMA", the tensor cores'
    matrix multiply-add) lib<name>.so holds, by `cuobjdump -sass`; built
    first if stale."""
    build_all([name])
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", _paths(name)[1]], check=True, capture_output=True,
                         text=True).stdout
    return sum(1 for line in out.splitlines() if f" {opcode}." in line or f" {opcode} " in line)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first if stale."""
    build_all([name])
    return ctypes.CDLL(_paths(name)[1])
