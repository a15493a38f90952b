"""Classic Gym seeding (pre-0.22 scheme): sha512(str(seed)) -> uint32 words ->
MT19937 RandomState.

The reference relies on `gym.utils.seeding.np_random` for every reset draw
(spaceship_env.py:92-94, hexagonal_tiling.py:50-51).  The compat adapter uses
this module so its RNG streams match the golden recorder's shim bit-for-bit.

A copy of space_gym_tpu/utils/seeding.py.
"""
from __future__ import annotations

import hashlib
import os
import struct

import numpy as np


def create_seed(a=None, max_bytes: int = 8) -> int:
    if a is None:
        return _bigint_from_bytes(os.urandom(max_bytes))
    if isinstance(a, int):
        return a % 2 ** (8 * max_bytes)
    if isinstance(a, str):
        a_bytes = a.encode("utf8")
        a_bytes = a_bytes + hashlib.sha512(a_bytes).digest()
        return _bigint_from_bytes(a_bytes[:max_bytes])
    raise ValueError(f"Invalid type for seed: {type(a)} ({a})")


def hash_seed(seed=None, max_bytes: int = 8) -> int:
    if seed is None:
        seed = create_seed(max_bytes=max_bytes)
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def _bigint_from_bytes(bt: bytes) -> int:
    sizeof_int = 4
    padding = sizeof_int - len(bt) % sizeof_int
    bt += b"\0" * padding
    int_count = len(bt) // sizeof_int
    unpacked = struct.unpack(f"{int_count}I", bt)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int):
    if bigint < 0:
        raise ValueError(f"Seed must be non-negative, not {bigint}")
    if bigint == 0:
        return [0]
    ints = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2**32)
        ints.append(mod)
    return ints


def np_random(seed=None):
    """Returns (RandomState, int_seed) with the classic gym derivation."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"Seed must be a non-negative integer or omitted, not {seed}")
    seed = create_seed(seed)
    rng = np.random.RandomState()
    rng.seed(_int_list_from_bigint(hash_seed(seed)))
    return rng, seed
