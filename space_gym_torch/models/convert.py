"""Carry a learner between space_gym_tpu and this package as numpy arrays.

Nothing here imports jax, flax or optax: the JAX side hands over trees whose
leaves are numpy arrays (`jax.tree.map(np.asarray, tree)`), and gets such
trees back.

  * flax parameter trees of `TanhGaussianActor` ("actor"),
    `DeterministicActor` ("det_actor"), `DoubleCritic` ("critic"),
    `GaussianActorValue` ("ppo") and DQN's Q network, an `MLP` ("dqn")
    (`{"params": {"MLP_0": {"Dense_0": {"kernel", "bias"}, ...}, ...}}`)
    <-> the port's parameter dicts, named like the modules' state dicts
    (`"mlp.layers.0.kernel"`, ...).  Kernels keep their (in, out) layout.
  * an optax Adam state (`(ScaleByAdamState(count, mu, nu), EmptyState())`)
    <-> `models.sac.AdamState`.
  * `PackedParams`, `PackedAdam` and `FusedState` of the JAX package's
    fused_sac (`algo="sac"`, the default) or fused_td3 (`algo="td3"`, with the
    second count `count_a`), or any object or mapping with their fields <->
    the port's tuples of the same names.  `load_learner_npz` reads a
    learner file: a fused-layout SAC learner (the fields of FusedState and
    `log_alpha`, as `docs/goal2p_sac_best.npz` holds them), or flattened
    flax parameters under "p:<path>" keys (PPO's and DQN's, as
    `docs/goal2p_ppo_feat_best.npz` and `docs/dqn_goaldiscrete3_best.npz`
    hold them).
"""
from __future__ import annotations

import numpy as np
import torch

from . import fused_sac, fused_td3
from .offpolicy import AdamState

# the packed tuples by algorithm
_TUPLES = {"sac": fused_sac, "td3": fused_td3}

# (flax path, port name) of every layer, by network
_ACTOR_LAYERS = (
    (("MLP_0", "Dense_0"), "mlp.layers.0"), (("MLP_0", "Dense_1"), "mlp.layers.1"),
    (("Dense_0",), "mean_head"), (("Dense_1",), "log_std_head"),
)
_DET_ACTOR_LAYERS = (
    (("MLP_0", "Dense_0"), "mlp.layers.0"), (("MLP_0", "Dense_1"), "mlp.layers.1"),
    (("Dense_0",), "head"),
)
_CRITIC_LAYERS = tuple(
    ((f"MLP_{i}", f"Dense_{j}"), f"q{i + 1}.layers.{j}") for i in range(2) for j in range(3))
_PPO_LAYERS = (
    (("MLP_0", "Dense_0"), "torso.layers.0"), (("MLP_0", "Dense_1"), "torso.layers.1"),
    (("Dense_0",), "mean_head"), (("vf", "Dense_0"), "vf.layers.0"),
    (("vf", "Dense_1"), "vf.layers.1"), (("vhead",), "vhead"),
)
_DQN_LAYERS = tuple(((f"Dense_{j}",), f"layers.{j}") for j in range(3))
_LAYERS = {"actor": _ACTOR_LAYERS, "det_actor": _DET_ACTOR_LAYERS, "critic": _CRITIC_LAYERS,
           "ppo": _PPO_LAYERS, "dqn": _DQN_LAYERS}
# parameters that are not a layer's, by network: (flax name, port name)
_LEAVES = {"ppo": (("log_std", "log_std"),)}
# the top-level names of each network's flax tree, to tell a file's kind
_TOP = {kind: frozenset(path[0] for path, _ in layers) | {f for f, _ in _LEAVES.get(kind, ())}
        for kind, layers in _LAYERS.items()}


def _tensor(a, device):
    return torch.tensor(np.asarray(a), device=device)


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) or hasattr(obj, "keys") else getattr(obj, name)


def params_from_flax(tree, kind: str, device="cpu") -> dict:
    """A flax tree of the `kind` ("actor", "det_actor" or "critic") network ->
    the port's parameter dict."""
    out = {}
    node0 = tree["params"]
    for path, name in _LAYERS[kind]:
        node = node0
        for p in path:
            node = node[p]
        out[name + ".kernel"] = _tensor(node["kernel"], device)
        out[name + ".bias"] = _tensor(node["bias"], device)
    for flax_name, name in _LEAVES.get(kind, ()):
        out[name] = _tensor(node0[flax_name], device)
    return out


def params_to_flax(params: dict, kind: str) -> dict:
    """The port's parameter dict -> the flax tree, numpy leaves."""
    tree: dict = {}
    for path, name in _LAYERS[kind]:
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel"] = params[name + ".kernel"].detach().cpu().numpy()
        node["bias"] = params[name + ".bias"].detach().cpu().numpy()
    for flax_name, name in _LEAVES.get(kind, ()):
        tree[flax_name] = params[name].detach().cpu().numpy()
    return {"params": tree}


def flax_kind(tree) -> str:
    """The network ("actor", "det_actor", "ppo" or "dqn") whose flax tree
    this is, by its top-level names."""
    top = frozenset(tree["params"])
    for kind in ("actor", "det_actor", "ppo", "dqn"):
        if top == _TOP[kind]:
            return kind
    raise ValueError(f"no network has the top-level parameters {sorted(top)}")


def adam_from_optax(opt_state, kind: str | None, device="cpu") -> AdamState:
    """An optax.adam state with numpy leaves -> AdamState.  `kind` names the
    network whose parameters it follows, None for a single array
    (log_alpha)."""
    st = opt_state[0]
    conv = ((lambda t: params_from_flax(t, kind, device)) if kind
            else (lambda t: _tensor(t, device)))
    return AdamState(int(np.asarray(st.count)), conv(st.mu), conv(st.nu))


def adam_to_optax(st: AdamState, kind: str | None) -> dict:
    """AdamState -> the fields of optax's ScaleByAdamState, numpy leaves."""
    conv = ((lambda t: params_to_flax(t, kind)) if kind
            else (lambda t: t.detach().cpu().numpy()))
    return {"count": np.asarray(st.count, np.int32), "mu": conv(st.mu), "nu": conv(st.nu)}


def _counts(obj, cls, skip):
    """The step counts of a PackedAdam or FusedState `cls` as Python ints."""
    return {f: int(np.asarray(_get(obj, f))) for f in cls._fields if f not in skip}


def packed_from_numpy(p, device="cpu", algo: str = "sac"):
    cls = _TUPLES[algo].PackedParams
    return cls(*[_tensor(_get(p, f), device) for f in cls._fields])


def packed_to_numpy(p):
    return type(p)(*[x.detach().cpu().numpy() for x in p])


def packed_adam_from_numpy(a, device="cpu", algo: str = "sac"):
    cls = _TUPLES[algo].PackedAdam
    return cls(m=packed_from_numpy(_get(a, "m"), device, algo),
               v=packed_from_numpy(_get(a, "v"), device, algo), **_counts(a, cls, ("m", "v")))


def packed_adam_to_numpy(a):
    counts = {f: np.asarray(getattr(a, f), np.int32) for f in a._fields if f not in ("m", "v")}
    return type(a)(m=packed_to_numpy(a.m), v=packed_to_numpy(a.v), **counts)


_FUSED_ARRAYS = ("w", "vec", "mw", "mvec", "vw", "vvec")


def fused_from_numpy(f, device="cpu", algo: str = "sac"):
    """Any object or mapping with FusedState's fields -> FusedState on `device`."""
    cls = _TUPLES[algo].FusedState
    arrays = {k: _tensor(_get(f, k), device).to(torch.float32).contiguous()
              for k in _FUSED_ARRAYS}
    return cls(**_counts(f, cls, _FUSED_ARRAYS), **arrays)


def fused_to_numpy(f):
    arrays = {k: getattr(f, k).detach().cpu().numpy() for k in _FUSED_ARRAYS}
    counts = {k: np.asarray(getattr(f, k), np.int32) for k in f._fields if k not in _FUSED_ARRAYS}
    return type(f)(**counts, **arrays)


def _unflatten(flat: dict) -> dict:
    """{"p:['params']['MLP_0']['Dense_0']['bias']": array, ...} (the keys
    `jax.tree_util.keystr` gives) -> the nested flax tree."""
    tree: dict = {}
    for key, value in flat.items():
        path = [part.strip("'\"") for part in key[2:].strip("[]").split("][")]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def load_learner_npz(path, device="cpu"):
    """A learner file -> (learner, log_alpha, meta), where meta holds the
    file's other entries (obs_dim, env_id, ...) and "kind".  A fused-layout
    file gives its FusedState (kind "sac", or "td3" where it has `count_a`)
    and log_alpha (None for TD3); a file of flattened flax parameters gives
    the port's parameter dict of the network it holds, log_alpha None, and
    its kind ("ppo", "dqn", "actor" or "det_actor")."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k.startswith("p:")}
        if flat:
            tree = _unflatten(flat)
            kind = flax_kind(tree)
            meta = {k: z[k][()] for k in z.files if not k.startswith("p:")}
            return params_from_flax(tree, kind, device), None, dict(meta, kind=kind)
        algo = "td3" if "count_a" in z.files else "sac"
        fused = fused_from_numpy(z, device, algo)
        log_alpha = _tensor(z["log_alpha"], device) if "log_alpha" in z.files else None
        meta = {k: z[k][()] for k in z.files
                if k not in _FUSED_ARRAYS + ("count", "count_a", "log_alpha")}
    return fused, log_alpha, dict(meta, kind=algo)
