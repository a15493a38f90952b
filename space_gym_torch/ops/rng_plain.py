"""Plain PyTorch versions of the two in-kernel random sources (csrc/rng.cuh).

Each maps two 32-bit key words to the `(n_rows, B)` float32 block of uniforms
in [0, 1) that the full-step kernel draws for itself in that mode, row r of
lane l being a function of (key, l, r) only; `lane0` shifts l to the global
lane lane0 + l where the lanes are split over ranks (parallel/mesh.py):

* threefry: threefry2x32 of counter (0, l * n_rows + r), the two output words
  XORed: the bits of `jax.random.uniform(key, (B, n_rows), float32).T`
  (space_gym_tpu/ops/pallas_full.py::_threefry_uniform_matrix);
* philox: word r % 4 of Philox4x32-10 at counter (l, r // 4, 0, 0): the
  port's stand-in for the TPU core's hardware generator, its own stream.

Both fill the float's mantissa: bitcast((bits >> 9) | 0x3F800000) - 1.

PyTorch implements few operations for uint32 on the CPU, so the arithmetic is
done in int64 and masked to 32 bits after every addition and shift; the 32x32
products of Philox are taken in 16-bit halves to stay below 2**63.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def key_words(key, device=None) -> torch.Tensor:
    """Two 32-bit key words -> the (2,) int32 tensor holding their bit pattern
    that the kernels read; `key` is a sequence or array of two unsigned words
    (e.g. `jax.random.key_data(key)` as numpy) or a tensor of any integer
    type.  No host synchronisation for a tensor already on `device`."""
    k = key if isinstance(key, torch.Tensor) else torch.tensor([int(w) for w in key],
                                                               dtype=torch.int64)
    if k.shape != (2,):
        raise ValueError(f"a key is two 32-bit words, got shape {tuple(k.shape)}")
    if k.dtype == torch.uint32:
        k = k.view(torch.int32)
    elif k.dtype != torch.int32:
        k = k.to(torch.int64) & _M32
        k = torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)
    return k if device is None else k.to(device)


def _u64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values in int64."""
    return words.to(torch.int64) & _M32


def _mantissa_fill(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits in int64 -> float32 in [0, 1) (jax/_src/random.py::_uniform)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _lane_row(B: int, n_rows: int, device, lane0: int = 0):
    row = torch.arange(n_rows, dtype=torch.int64, device=device)[:, None]
    lane = torch.arange(lane0, lane0 + B, dtype=torch.int64, device=device)[None, :]
    return lane, row


def threefry_bits(k0, k1, x1: torch.Tensor) -> torch.Tensor:
    """x0 ^ x1 of threefry2x32 with key (k0, k1) on counters (0, x1); all
    values unsigned in int64."""
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = torch.zeros_like(x1) + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _THREEFRY_ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0 ^ x1


def threefry_uniform_matrix(key: torch.Tensor, B: int, n_rows: int,
                            lane0: int = 0) -> torch.Tensor:
    """(n_rows, B) float32 uniforms, bit for bit `jax.random.uniform(key,
    (lane0 + B, n_rows), float32).T[:, lane0:]` for the key whose words `key`
    (2,) holds."""
    if (lane0 + B) * n_rows >= 1 << 32:
        raise ValueError(f"(lane0 + B) * n_rows = {(lane0 + B) * n_rows} does not fit the "
                         "32-bit counter")
    k = _u64(key)
    lane, row = _lane_row(B, n_rows, key.device, lane0)
    return _mantissa_fill(threefry_bits(k[0], k[1], lane * n_rows + row))


def _mulhilo(m: int, b: torch.Tensor):
    """(high, low) 32-bit words of m * b, m < 2**32 a constant, b < 2**32."""
    t_lo = m * (b & 0xFFFF)
    t_hi = m * (b >> 16)
    hi = (t_hi + (t_lo >> 16)) >> 16
    lo = (((t_hi & 0xFFFF) << 16) + (t_lo & _M32)) & _M32
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3, rounds: int = 10):
    """Philox4x32 (Salmon et al. 2011) of counter (c0..c3) under key (k0, k1);
    unsigned values in int64, returns the four output words."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform_matrix(key: torch.Tensor, B: int, n_rows: int,
                          lane0: int = 0) -> torch.Tensor:
    """(n_rows, B) float32 uniforms: row r of lane l is word r % 4 of
    Philox4x32-10 at counter (lane0 + l, r // 4, 0, 0) under the key's two
    words."""
    if lane0 + B > 1 << 32:
        raise ValueError(f"lane0 + B = {lane0 + B} does not fit the 32-bit counter")
    k = _u64(key)
    n_blocks = (n_rows + 3) // 4
    lane, blk = _lane_row(B, n_blocks, key.device, lane0)
    zero = torch.zeros_like(lane + blk)
    words = philox4x32(k[0], k[1], lane + zero, blk + zero, zero, zero)
    bits = torch.stack(words, dim=1).reshape(4 * n_blocks, B)[:n_rows]
    return _mantissa_fill(bits)
