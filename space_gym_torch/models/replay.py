"""Circular replay buffer on the trainer's device.

Port of space_gym_tpu/models/replay.py.  ONE packed tensor `data` of shape
(rows, W, lanes), LANES MINOR, whose W rows are [obs | next_obs | action |
reward | discount | ones] at 8-aligned offsets (`replay_cols`).  The layout is
kept exactly as in the JAX package because the fused learner kernels
(csrc/sac_update.cuh) read minibatch tiles straight out of this ring: a tile
is W rows of consecutive lanes of one replay row, so every row of a tile is
one contiguous run of floats.

The ring is written IN PLACE (`replay_add_slab` copies a (T, W, lanes) slab
into `data` and returns a state that shares it); `cursor` and `filled` are
Python ints, since nothing here is traced.  Sampling takes an explicit
`torch.Generator` or injected indices.

Under a mesh (parallel/mesh.py) a rank's ring holds its block of the lanes.
The samplers then draw the indices over the global lanes, alike on every
rank, each rank takes the rows of the lanes it owns, and an `all_gather`
over "data" picked by owner (never a sum with zeros, which would turn -0.0
into +0.0) gives every rank the one-process minibatch, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor  # final_obs of the step (pre-reset; bootstrap target)
    discount: torch.Tensor  # 0.0 iff terminated (truncation still bootstraps)


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


def replay_cols(obs_dim: int, action_dim: int):
    """8-aligned W-row offsets (o0, n0, a0, r0, d0, W) of the packed buffer:
    obs at o0, next_obs at n0, action at a0, reward row r0, discount row d0.
    W = ceil8(d0 + 2): the row d0 + 1 is reserved (`replay_ones_row`), so it
    exists even when d0 + 1 lands on an 8-boundary."""
    o0 = 0
    n0 = _ceil8(obs_dim)
    a0 = _ceil8(n0 + obs_dim)
    r0 = a0 + action_dim
    d0 = r0 + 1
    return o0, n0, a0, r0, d0, _ceil8(d0 + 2)


def replay_ones_row(obs_dim: int, action_dim: int) -> int:
    """Row of constant 1.0 at d0 + 1, reserved by `replay_cols`.  The JAX
    kernels contract it against the critics' first-layer bias; the CUDA
    kernels add the bias plainly and do not read it, but the row stays so
    that a ring means the same in both packages."""
    return replay_cols(obs_dim, action_dim)[4] + 1


@dataclass(frozen=True)
class ReplayState:
    data: torch.Tensor    # (rows, W, lanes) packed transitions, lanes minor
    cursor: int           # next row to write (grows without bound)
    filled: int           # rows written so far (<= rows)
    obs_dim: int          # row layout (see replay_cols)
    action_dim: int

    def _replace(self, **kw):
        return replace(self, **kw)


def pack_slab(tr: Transition, obs_dim: int, action_dim: int) -> torch.Tensor:
    """(T, lanes, ·) Transition slab -> (T, W, lanes) packed, lanes minor."""
    o0, n0, a0, r0, d0, w = replay_cols(obs_dim, action_dim)
    t_len, lanes = tr.reward.shape
    out = torch.zeros((t_len, w, lanes), dtype=tr.obs.dtype, device=tr.obs.device)
    out[:, o0:o0 + obs_dim] = tr.obs.transpose(1, 2)
    out[:, n0:n0 + obs_dim] = tr.next_obs.transpose(1, 2)
    out[:, a0:a0 + action_dim] = tr.action.transpose(1, 2)
    out[:, r0] = tr.reward
    out[:, d0] = tr.discount
    out[:, d0 + 1] = 1.0
    return out


def unpack_flat(flat: torch.Tensor, obs_dim: int, action_dim: int) -> Transition:
    """(..., W) row-packed vectors -> Transition with (..., d) leaves."""
    o0, n0, a0, r0, d0, _ = replay_cols(obs_dim, action_dim)
    return Transition(
        obs=flat[..., o0:o0 + obs_dim],
        action=flat[..., a0:a0 + action_dim],
        reward=flat[..., r0],
        discount=flat[..., d0],
        next_obs=flat[..., n0:n0 + obs_dim],
    )


def replay_init(rows: int, lanes: int, obs_dim: int, action_dim: int,
                dtype=torch.float32, device="cpu") -> ReplayState:
    w = replay_cols(obs_dim, action_dim)[-1]
    return ReplayState(
        data=torch.zeros((rows, w, lanes), dtype=dtype, device=device),
        cursor=0, filled=0, obs_dim=obs_dim, action_dim=action_dim,
    )


def replay_add(state: ReplayState, tr: Transition) -> ReplayState:
    """Insert one time-slice of transitions, leaves shaped (lanes, ...)."""
    return replay_add_slab(state, Transition(*[x[None] for x in tr]))


def replay_add_slab(state: ReplayState, slab: Transition) -> ReplayState:
    """Insert T time-slices at once, leaves shaped (T, lanes, ...).

    Requires T | rows (checked): the write offset stays T-aligned and the
    slab never straddles the ring boundary.  `state.data` is written in
    place; the returned state shares it."""
    rows = state.data.shape[0]
    t = slab.obs.shape[0]
    if rows % t != 0:
        raise ValueError(f"slab length {t} must divide replay rows {rows}")
    row = state.cursor % rows
    packed = pack_slab(slab, state.obs_dim, state.action_dim).to(state.data.dtype)
    state.data[row:row + t] = packed
    return state._replace(cursor=state.cursor + t, filled=min(state.filled + t, rows))


def nstep_slab(slab: Transition, dones: torch.Tensor, gamma: float, n: int) -> Transition:
    """Rewrite a (T, lanes) rollout slab as n-step transitions.

    For each start t the chain extends while the episode continues, up to
    min(n, T - t) steps (tail rows fall back to shorter chains so the slab
    keeps length T):

      reward'   = sum_{k<m} gamma^k r_{t+k}         (m = chain length)
      next_obs' = next_obs_{t+m-1}                  (pre-reset obs at chain end)
      discount' = gamma^{m-1} * discount_{t+m-1}    (0 if the chain terminated)

    Chains stop at ANY done (termination or truncation); bootstrapping at the
    cut uses `discount`, which stays 1 on pure truncation."""
    if n <= 1:
        return slab
    t_len = slab.reward.shape[0]
    cont = 1.0 - dones.to(slab.reward.dtype)  # (T, lanes)
    zeros_row = torch.zeros_like(slab.reward[:1])

    def shift(x, k):
        """Row t sees row t + k; zeros past the end."""
        return torch.cat([x[k:], torch.zeros((k,) + x.shape[1:], dtype=x.dtype, device=x.device)])

    reward = slab.reward
    next_obs = slab.next_obs
    discount = slab.discount
    alive = torch.ones_like(slab.reward)  # chain from t reaches step t+k
    for k in range(1, n):
        # reach row t = cont[t+k-1] AND t+k < T (step t+k must exist)
        reach = torch.cat([cont[k - 1:t_len - 1], zeros_row.repeat(k, 1)])
        alive = alive * reach
        reward = reward + alive * (gamma**k) * shift(slab.reward, k)
        next_obs = torch.where(alive[..., None] > 0, shift(slab.next_obs, k), next_obs)
        discount = torch.where(alive > 0, (gamma**k) * shift(slab.discount, k), discount)
    return slab._replace(reward=reward, next_obs=next_obs, discount=discount)


def _randint(high: int, n: int, generator, device) -> torch.Tensor:
    return torch.randint(0, max(high, 1), (n,), generator=generator, device=device)


def global_lanes(state: ReplayState, mesh=None) -> int:
    """The lanes of the whole ring: the rank's times the data axis."""
    return state.data.shape[2] * (1 if mesh is None else mesh.data_size)


def replay_sample(state: ReplayState, generator, batch: int, row_idx=None,
                  lane_idx=None, mesh=None) -> Transition:
    """Uniform sample of `batch` transitions from the filled region; the
    (batch,) `row_idx` and `lane_idx` (global lanes) may be injected."""
    lanes = state.data.shape[2]
    dev = state.data.device
    if row_idx is None:
        row_idx = _randint(state.filled, batch, generator, dev)
    if lane_idx is None:
        lane_idx = _randint(global_lanes(state, mesh), batch, generator, dev)
    if mesh is None:
        flat = state.data[row_idx, :, lane_idx]          # (batch, W)
    else:
        # this rank's rows where it owns the lane (a clamped stand-in where
        # not, never picked), every rank's gathered, then each by its owner
        first = mesh.data_index * lanes
        mine = state.data[row_idx, :, (lane_idx - first).clamp(0, lanes - 1)]
        every = mesh.all_gather(mine, "data", dim=0).reshape(mesh.data_size, batch, -1)
        flat = every[lane_idx // lanes, torch.arange(batch, device=dev)]
    return unpack_flat(flat, state.obs_dim, state.action_dim)


def replay_rows(state: ReplayState, row_idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """The (n, W, lanes) rows `row_idx` of the ring, every lane of each:
    under a mesh the ranks' blocks gathered along lanes, the global rows."""
    rows = state.data[row_idx]
    return rows if mesh is None else mesh.all_gather(rows, "data", dim=2)


def replay_sample_rows(state: ReplayState, generator, batch: int, row_idx=None,
                       mesh=None) -> Transition:
    """Row-granular uniform sample: batch // lanes random TIME ROWS (or the
    injected `row_idx`), every lane of each.  Lanes are independent episodes
    in lockstep, so a row is `lanes` iid transitions sharing the time index."""
    w, lanes = state.data.shape[1], global_lanes(state, mesh)
    if batch % lanes:
        raise ValueError(f"batch {batch} not divisible by lanes {lanes}")
    if row_idx is None:
        row_idx = _randint(state.filled, batch // lanes, generator, state.data.device)
    flat = replay_rows(state, row_idx, mesh).transpose(1, 2).reshape(batch, w)
    return unpack_flat(flat, state.obs_dim, state.action_dim)
