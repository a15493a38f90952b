"""Source-hash build freshness for the dlopen'ed native parity libraries.

The committed artifact is the SOURCE, never the binary: a library is
(re)built whenever its stamp file no longer matches the source hash.  An
mtime comparison is wrong after a fresh checkout (both mtimes equal the
checkout time), which would dlopen a stale or foreign-arch binary as the
ground truth of the bitwise parity tier.

The port's copy of space_gym_tpu/utils/native_build.py, used by
parity/native.py (libsgt_native).
"""
from __future__ import annotations

import hashlib
import os


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
