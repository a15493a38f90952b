"""A (data, model) grid over the ranks of the process group, and where each
leaf of a trainer's state lives on it.

Port of space_gym_tpu/parallel/mesh.py.  The scale axis is the env batch:
lanes split along "data" over the ranks, parameters replicate.  JAX's GSPMD
inserts a gradient all-reduce where replicated parameters meet split
batches; the port keeps the one-process math instead by replicating the
update: every rank draws the same global minibatch indices, fills the rows
it owns, and an `all_gather` picked by owner gives every rank the same
minibatch (models/replay.py), so every rank runs the same update and the
replicated state stays equal bit for bit.  The fused K-update is one launch
with Adam inside and could not all-reduce between its K updates anyway.

Rollouts need no communication: a rank steps only its lanes, and every draw
with a lanes axis is made for the global lanes from generators that all
ranks seed alike and sliced to the rank's rows (EnvEngine.draw_lanes), so a
lane's randomness does not depend on how many ranks there are.

The optional "model" axis stores parameter leaves whose last axis divides
it column-split over the model sub-group (JAX's column-parallel kernels);
a trainer gathers them whole before it computes and keeps its own columns
after, so the math stays the one-process math (SURVEY §2: tensor
parallelism is not needed at these widths, and the port adds no split
compute).

    init_distributed(...)
    mesh = make_mesh()                          # every rank, model_parallel=1
    tr = SACTrainer(EnvEngine(cfg, mesh=mesh), SACConfig(lanes=4096, ...))
    state = tr.init(0)                          # the global state, alike on every rank
    state = place(state, trainer_state_shardings(state, mesh), mesh)
    state, metrics = tr.train_iter(state, tr.generator(1))
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec, as jax.sharding.PartitionSpec: entry i names the
    mesh axis that splits the leaf's axis i, None where it is whole; the
    empty spec replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the (data, model) grid and its two sub-groups:
    the ranks that share its model index (`groups["data"]`, over which lanes
    split) and those that share its data index (`groups["model"]`).  Without
    a process group both are None and the grid is (1, 1)."""

    shape: tuple
    axis_names: tuple
    rank: int
    coords: tuple
    groups: dict

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    def all_gather(self, t: torch.Tensor, axis: str = "data", dim: int = 0) -> torch.Tensor:
        """The tensors of the ranks along `axis`, concatenated along `dim` in
        their order on the axis; `t` itself without a process group."""
        group = self.groups[axis]
        if group is None:
            return t
        if t.dtype == torch.bool:  # not every backend reduces bool: as bytes
            return self.all_gather(t.to(torch.uint8), axis, dim).bool()
        parts = [torch.empty_like(t) for _ in range(self.size(axis))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The (n_devices // model_parallel, model_parallel) grid over the ranks,
    row-major as JAX reshapes its devices, with the axes "data" and "model"
    that the split tables name.  Every rank must call it, in the same order
    as any other group it makes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n % model_parallel != 0:
        raise ValueError(f"n_devices {n} not divisible by model_parallel {model_parallel}")
    if n != world:
        raise ValueError(f"a mesh spans every rank of the process group: n_devices {n}, "
                         f"world size {world}")
    shape = (n // model_parallel, model_parallel)
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups = {"data": None, "model": None}
    if dist.is_initialized():
        grid = np.arange(n).reshape(shape)
        for j in range(shape[1]):
            g = dist.new_group([int(r) for r in grid[:, j]])
            if j == rank % model_parallel:
                groups["data"] = g
        for i in range(shape[0]):
            g = dist.new_group([int(r) for r in grid[i, :]])
            if i == rank // model_parallel:
                groups["model"] = g
    return Mesh(shape=shape, axis_names=("data", "model"), rank=rank,
                coords=(rank // model_parallel, rank % model_parallel), groups=groups)


# Fields of SACState / TD3State holding network/optimizer leaves (replicated,
# or model-split when a model axis is used).
_PARAM_FIELDS = frozenset(
    {
        "actor_params", "critic_params", "target_actor_params",
        "target_critic_params", "log_alpha", "actor_opt", "critic_opt",
        "alpha_opt", "n_updates", "step",
        "params", "opt",  # DQNState / PPOState naming
    }
)
# Fields whose leaves carry a leading lanes axis.
_ENV_FIELDS = frozenset({"env_state", "obs"})
# The packed replay ring is (rows, W, lanes): lanes is the MINOR axis 2
# (models/replay.py).
_REPLAY_FIELDS = frozenset({"replay"})


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else int(np.ndim(x))


def _spec_env(x) -> P:
    n = _ndim(x)
    return P("data", *([None] * (n - 1))) if n >= 1 else P()


def _spec_replay(x) -> P:
    # data ring (rows, W, lanes); the cursor and filled counts replicate
    return P(None, None, "data") if _ndim(x) == 3 else P()


def _spec_param(model_parallel: int):
    def spec(x) -> P:
        # Column-split: the last (output) axis of kernels (in, out) and
        # biases that divide the model axis; everything else (scalars,
        # counts) replicates.
        n = _ndim(x)
        if n >= 1 and model_parallel > 1:
            last = x.shape[-1]
            if last >= model_parallel and last % model_parallel == 0:
                return P(*([None] * (n - 1)), "model")
        return P()

    return spec


def _replicated(x) -> P:
    return P()


def tree_map(fn, tree, *rest):
    """fn over the leaves of the port's state trees: NamedTuples, dicts,
    tuples and lists, dataclasses (the replay ring), with tensors, Python
    numbers and None as leaves.  `rest` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and not isinstance(tree, P):
        return type(tree)(*[tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)])
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def state_shardings(state, mesh: Mesh):
    """The spec of every leaf of a batched engine EnvState (an obs tensor or
    a tuple of both is fine): lanes split along "data"."""
    return tree_map(_spec_env, state)


def trainer_state_shardings(state, mesh: Mesh, model_parallel: int = 1):
    """The spec of every leaf of a SAC/TD3/PPO/DQN state, by field: env and
    replay leaves split along "data", parameters and optimizer state
    replicate (or column-split along "model" when model_parallel > 1), the
    rest replicates."""
    param_spec = _spec_param(model_parallel)
    fields = {}
    for name in state._fields:
        if name in _ENV_FIELDS:
            spec_fn = _spec_env
        elif name in _REPLAY_FIELDS:
            spec_fn = _spec_replay
        elif name in _PARAM_FIELDS:
            spec_fn = param_spec
        else:
            spec_fn = _replicated
        fields[name] = tree_map(spec_fn, getattr(state, name))
    return type(state)(**fields)


def _take(x, spec, mesh: Mesh):
    """This rank's block of one leaf under its spec."""
    if not isinstance(x, torch.Tensor) or not any(spec):
        return x
    out = x
    for axis, name in enumerate(spec):
        if name is None:
            continue
        n, i = mesh.size(name), mesh.index(name)
        if out.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {out.shape[axis]} does not split over "
                             f"{n} ranks of {name!r}")
        per = out.shape[axis] // n
        out = out.narrow(axis, i * per, per)
    return x if out.shape == x.shape else out.contiguous().clone()


def place(tree, shardings, mesh: Mesh):
    """This rank's shard of every leaf of `tree` (made alike on every rank)
    under the spec tree `shardings`: a leaf whose spec splits nothing is
    returned as it is, a split one as a fresh contiguous copy of its
    block."""
    return tree_map(lambda x, s: _take(x, s, mesh), tree, shardings)


def gather_model(tree, shardings, mesh: Mesh):
    """The leaves that `shardings` split along "model", gathered whole from
    the model sub-group; the others as they are."""
    if mesh.model_size == 1:
        return tree

    def whole(x, spec):
        if isinstance(x, torch.Tensor) and "model" in spec:
            return mesh.all_gather(x, "model", dim=list(spec).index("model"))
        return x

    return tree_map(whole, tree, shardings)


def split_model(tree, shardings, mesh: Mesh):
    """The inverse of `gather_model`: this rank's columns of the leaves that
    `shardings` split along "model"."""
    if mesh.model_size == 1:
        return tree
    only_model = tree_map(lambda s: P(*[a if a == "model" else None for a in s])
                          if isinstance(s, P) else s, shardings)
    return place(tree, only_model, mesh)
