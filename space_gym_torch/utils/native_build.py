"""Source-hash build freshness for the dlopen'ed native parity libraries.

The committed artifact is the SOURCE, never the binary: a library is
(re)built whenever its stamp file no longer matches the source hash.  An
mtime comparison is wrong after a fresh checkout (both mtimes equal the
checkout time), which would dlopen a stale or foreign-arch binary as the
ground truth of the bitwise parity tier.

The port's copy of space_gym_tpu/utils/native_build.py, used by
parity/native.py (libsgt_native) and ops/exact.py (libsgt_exactmath), with
the build itself (`build_shared`) and the path of numpy's bundled OpenBLAS
that both libraries dlopen (`openblas_path`).
"""
from __future__ import annotations

import glob
import hashlib
import os
import subprocess
from typing import Optional


def _stamp_path(lib: str) -> str:
    return lib + ".sha"


def src_digest(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def lib_is_fresh(src: str, lib: str) -> bool:
    stamp = _stamp_path(lib)
    if not os.path.exists(lib) or not os.path.exists(stamp):
        return False
    try:
        with open(stamp) as f:
            return f.read().strip() == src_digest(src)
    except OSError:
        return False


def write_stamp(src: str, lib: str) -> None:
    """Record the source hash AFTER a successful build (ordering matters: a
    failed build must not leave a fresh-looking stamp)."""
    with open(_stamp_path(lib), "w") as f:
        f.write(src_digest(src))


def build_shared(src: str, lib: str, flags: list) -> Optional[str]:
    """Compile `src` into the shared library `lib` with g++ and `flags`;
    returns the compiler's error text, or None.  The library is written under
    a name of this process and moved into place, so that processes building
    at once never load a half-written file; the stamp follows."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *flags, "-fPIC", "-shared", "-o", tmp, src, "-ldl"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing etc.
        return str(e)
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, lib)
    write_stamp(src, lib)
    return None


def openblas_path() -> Optional[str]:
    """numpy's bundled OpenBLAS, whose ILP64 cblas symbols the native
    libraries call; None where numpy bundles none."""
    import numpy as np

    base = os.path.dirname(os.path.dirname(os.path.abspath(np.__file__)))
    cands = sorted(glob.glob(os.path.join(base, "numpy.libs", "libscipy_openblas*.so")))
    return cands[0] if cands else None
