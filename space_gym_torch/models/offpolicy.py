"""What the off-policy trainers (models/sac.py, models/td3.py) have in common:
optax.adam's arithmetic on dicts of tensors, and the train_iter loop: a
rollout on the engine's device, a replay insert, the warm-up gate, and the
choice of what the fused kernels sample from.

The rollout is the trainer's `PolicyRollout`: one captured CUDA graph on the
card, a loop on the CPU.  Its policy reads the actor's parameters where they
live: views of the fused state, which K4, K5 and K6 update in place, or the
unfused parameter tensors, which `_update_once` updates in place.

Under a mesh (the engine's, parallel/mesh.py) a rank rolls out its lanes,
every rank samples the same global minibatch (models/replay.py) and runs the
same update on it, so the learner state stays equal on every rank; the
metrics that average over lanes are reduced over the data axis.  Parameter
leaves that a model axis splits are gathered whole for the iteration
(`with_whole_params`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..engine.core import EnvEngine, PolicyRollout
from ..parallel.mesh import gather_model, split_model, trainer_state_shardings
from ..utils import profiling
from .learner_kernels import check_kernel_width
from .replay import (Transition, global_lanes, replay_add_slab, replay_rows, replay_sample,
                     replay_sample_rows)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """optax.adam's state: the step count and the two moments, shaped like
    the parameters (a dict of tensors, or one tensor)."""

    count: int
    mu: object
    nu: object


def _tmap(fn, *trees):
    """fn over the leaves of flat dicts of tensors (or over single tensors)."""
    if isinstance(trees[0], dict):
        return {k: fn(*[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def _add_(p, u):
    """An update written into its parameter tensor in place; returns it."""
    return p.add_(u)


def adam_init(params) -> AdamState:
    return AdamState(0, _tmap(torch.zeros_like, params), _tmap(torch.zeros_like, params))


def adam_update(grads, st: AdamState, lr: float):
    """(updates, new state) of optax.adam(lr) with its defaults (b1 0.9, b2
    0.999, eps 1e-8 outside the root, eps_root 0)."""
    count = st.count + 1
    mu = _tmap(lambda m, g: ADAM_B1 * m + (1 - ADAM_B1) * g, st.mu, grads)
    nu = _tmap(lambda v, g: ADAM_B2 * v + (1 - ADAM_B2) * g * g, st.nu, grads)
    bc1, bc2 = 1 - ADAM_B1**count, 1 - ADAM_B2**count
    upd = _tmap(lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS), mu, nu)
    return upd, AdamState(count, mu, nu)


def note_layout(trainer, state):
    """`state`, fresh from `trainer.init`; under the trainer's mesh its
    leaves' specs (parallel/mesh.py::trainer_state_shardings, on the whole
    shapes) are kept in `trainer.shardings` for `with_whole_params`."""
    if trainer.mesh is not None:
        trainer.shardings = trainer_state_shardings(state, trainer.mesh, trainer.mesh.model_size)
    return state


def with_whole_params(trainer, state, step, refresh=None):
    """`step(state)` -> (state, metrics) on whole parameters: under a model
    axis the split leaves are gathered from the model sub-group first
    (`refresh` then rebuilds what views them) and cut back to this rank's
    columns after, so the math is the one-process math."""
    mesh = trainer.mesh
    if mesh is None or mesh.model_size == 1:
        return step(state)
    if trainer.shardings is None:
        raise ValueError("a model-split state comes from this trainer's init(), then place()")
    state = gather_model(state, trainer.shardings, mesh)
    if refresh is not None:
        state = refresh(state)
    state, metrics = step(state)
    return split_model(state, trainer.shardings, mesh), metrics


def lane_randn(engine: EnvEngine, like: torch.Tensor, generator) -> torch.Tensor:
    """Standard normals shaped like `like` (lanes first), drawn for the
    global lanes under the engine's mesh (EnvEngine.draw_lanes)."""
    return engine.draw_lanes(lambda s: torch.randn(
        s, generator=generator, device=like.device, dtype=like.dtype), like.shape)


def lane_mean(mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of a (T, lanes) tensor over every rank's lanes: the
    gathered tensor's, in the one-process order."""
    return x.mean() if mesh is None else mesh.all_gather(x, "data", dim=1).mean()


def lane_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of a (T, lanes) tensor over every rank's lanes."""
    return x.sum() if mesh is None else mesh.all_gather(x, "data", dim=1).sum()


class OffPolicyTrainer:
    """The loop around an off-policy learner on one EnvEngine, on the engine's
    device: the card unless the engine was made with `device="cpu"`.  A
    subclass gives `act`, `_update_once` and `_update_fused`, and a state with
    the fields env_state, obs, replay, step and fused."""

    name = ""              # the algorithm, for messages
    reward_scale = 1.0     # multiplies rewards entering the replay ring

    def __init__(self, engine: EnvEngine, config, layout_module, device=None):
        if not engine.config.continuous:
            raise ValueError(f"{self.name} requires a continuous-action env config")
        if device is not None and torch.device(device).type != engine.device.type:
            raise ValueError(f"the trainer runs on its engine's device {engine.device}, "
                             f"got device={device!r}")
        self.engine = engine
        self.device = engine.device
        self.cfg = config
        self.mesh = engine.mesh
        self.shardings = None
        self.obs_dim = engine.obs_dim
        self.action_dim = engine.config.action_dim
        if config.fused_updates and self.action_dim != 2:
            # the packed replay layout and the kernels' head hard-code two actions
            raise ValueError(
                f"fused_updates requires action_dim == 2 (got {self.action_dim}); "
                "use the unfused path for other action dims")
        # Width-parameterized layout namespace, bound whenever the net shape
        # fits the packed layout: the format bridges (migrate/rehydrate) need
        # it on unfused trainers too.
        h = config.hidden
        self._layout = None
        if self.action_dim == 2 and len(h) == 2 and h[0] == h[1] and h[0] % 128 == 0:
            self._layout = layout_module.build(h[0])
        if config.fused_updates and self._layout is None:
            raise ValueError(
                f"fused_updates requires hidden=(h, h) with h a multiple of 128, got {h}")
        if config.fused_updates and self.device.type == "cuda":
            # the CPU takes any multiple of 128 (the plain version); the card
            # only the widths its kernels are built for, said here and not at
            # the first launch
            check_kernel_width(h[0])
        self.collect = PolicyRollout(engine, lambda params, g, obs: self.act(params, obs, g),
                                     config.rollout_len)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _need_layout(self):
        if self._layout is None:
            raise ValueError("fused-format bridge requires hidden=(h, h), h % 128 == 0")
        return self._layout

    def _rollout(self, state, generator):
        """Collect cfg.rollout_len steps with the behavior policy `act`; returns
        (env_state, obs, slab with (T, lanes, ...) leaves, rewards, dones)."""
        env_state, obs, traj = self.collect(state.actor_params, state.env_state, state.obs,
                                            generator)
        slab = Transition(
            obs=traj.obs,
            action=traj.kept["action"],
            reward=self.reward_scale * traj.reward,
            next_obs=traj.final_obs,
            discount=1.0 - traj.terminated.to(traj.reward.dtype),
        )
        return env_state, obs, slab, traj.reward, traj.done

    def _ring_rows(self, state, row_idx):
        """Under a mesh, the sampled rows of every rank's ring gathered into a
        ring of the global lanes, and the indices of its rows."""
        rows = replay_rows(state.replay, row_idx, self.mesh)
        return rows, torch.arange(rows.shape[0], device=self.device)

    def _fused_minibatches(self, state, generator, row_idx, batches):
        """What the fused entry points get for the K updates: (ring, row_idx,
        None) when minibatches are whole replay rows, so that the ring itself
        goes to the kernel with the sampled rows ((K * batch // lanes,), may
        be injected; under a mesh the ring of those rows gathered over the
        ranks); else, or when `batches` (Transition, (K, B, ...) leaves) is
        injected, (None, None, batches) with gathered minibatches."""
        c = self.cfg
        K = c.updates_per_iter
        lanes_r = global_lanes(state.replay, self.mesh)
        bt = min(c.fused_block, lanes_r)
        from_ring = batches is None and (row_idx is not None or (
            c.batch_size % lanes_r == 0 and lanes_r % bt == 0))
        if from_ring:
            if row_idx is None:
                row_idx = torch.randint(0, max(state.replay.filled, 1),
                                        (K * (c.batch_size // lanes_r),), generator=generator,
                                        device=self.device)
            if self.mesh is not None:
                return (*self._ring_rows(state, row_idx), None)
            return state.replay.data, row_idx, None
        if batches is None:
            total = K * c.batch_size
            if total % c.lanes == 0 and c.batch_size >= c.lanes:
                big = replay_sample_rows(state.replay, generator, total, mesh=self.mesh)
            else:
                big = replay_sample(state.replay, generator, total, mesh=self.mesh)
            batches = Transition(*[x.reshape(K, c.batch_size, *x.shape[1:]) for x in big])
        return None, None, batches

    def _slab_for_replay(self, slab, dones):
        """The rollout slab as it enters the ring."""
        return slab

    def _iter_metrics(self, state) -> dict:
        """Metrics of a train_iter beside the losses and the rollout's."""
        return {}

    def train_iter(self, state, generator):
        """One rollout, one replay insert, `updates_per_iter` updates: the
        span `sg.train_iter` around the spans `sg.rollout`, `sg.insert` and
        `sg.update` (utils/profiling.py), their iteration id the state's step."""
        refresh = self._refresh_from_fused if self.cfg.fused_updates else None
        with profiling.span("train_iter", device=self.device, it=state.step):
            return with_whole_params(self, state, lambda s: self._train_iter(s, generator),
                                     refresh)

    def _train_iter(self, state, generator):
        c = self.cfg
        with torch.no_grad():
            with profiling.span("rollout", device=self.device):
                env_state, obs, slab, rewards, dones = self._rollout(state, generator)
            with profiling.span("insert", device=self.device):
                replay = replay_add_slab(state.replay, self._slab_for_replay(slab, dones))
        state = state._replace(env_state=env_state, obs=obs, replay=replay)

        # The warm-up gate: before the ring holds min(warmup_rows, replay_rows)
        # rows the learner state does not change.  The JAX trainers compute the
        # update and discard it to keep one compiled program; here the update
        # is skipped, since the kernels update the state in place and nothing
        # is compiled.
        nan = torch.full((), float("nan"), device=self.device)
        metrics = {"critic_loss": nan, "actor_loss": nan}
        if replay.filled >= min(c.warmup_rows, c.replay_rows):
            with profiling.span("update", device=self.device):
                if c.fused_updates:
                    state, metrics = self._update_fused(state, generator)
                else:
                    for _ in range(c.updates_per_iter):
                        state, metrics = self._update_once(state, generator)
        metrics = dict(metrics, mean_reward=lane_mean(self.mesh, rewards),
                       episodes_done=lane_sum(self.mesh, dones),
                       **self._iter_metrics(state))
        return state._replace(step=state.step + 1), metrics

    def train_iters(self, state, generator, n: int):
        """n train_iters; returns the last iteration's metrics."""
        metrics = {}
        for _ in range(n):
            state, metrics = self.train_iter(state, generator)
        return state, metrics
