"""Checkpoint and resume of a trainer's whole state.

Port of space_gym_tpu/utils/checkpoint.py (orbax there): the state is a tree
of NamedTuples, dicts, the replay ring's dataclass, tensors and Python
numbers (network and optimiser state, the FusedState of the fused trainers,
the env lanes, the ring, the counters), and a caller may add what else a
resume needs, such as a generator's state.  `save` writes the tree's leaves,
moved to the CPU, with `torch.save`; `restore` reads them with
`torch.load(weights_only=True)`, which unpickles no class, and puts them back
into the structure of a `template` (a freshly made state), each tensor on
its template's device.  Same leaves, same bits: a restored run continues as
the uninterrupted run would.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch


def _flatten(tree, leaves: list):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], leaves)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, leaves)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), leaves)
    else:
        leaves.append(tree)
    return leaves


def _unflatten(template, leaves):
    """The template's structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_unflatten(v, leaves) for v in template])
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    return _leaf(template, next(leaves))


def _leaf(want, got):
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"checkpoint leaf {_describe(got)} does not fit the template's "
                             f"{_describe(want)}")
        return got.to(want.device)
    if want is not None and type(got) is not type(want):
        raise ValueError(f"checkpoint leaf {_describe(got)} does not fit the template's "
                         f"{_describe(want)}")
    return got


def _describe(x):
    return f"tensor {tuple(x.shape)} {x.dtype}" if isinstance(x, torch.Tensor) else repr(x)


def save(path: str, state: Any) -> str:
    """Write the leaves of `state` to the file `path` (atomically: a
    partial file never replaces a good one); returns the absolute path."""
    path = os.path.abspath(path)
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x
              for x in _flatten(state, [])]
    for x in leaves:
        if not (x is None or isinstance(x, (torch.Tensor, bool, int, float, str))):
            raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")
    tmp = path + ".tmp"
    torch.save({"leaves": leaves}, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str, template: Any) -> Any:
    """The state saved at `path`, in the structure of `template` (a fresh
    state of the same trainer and configuration), each tensor on the
    template's device."""
    leaves = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)["leaves"]
    n = len(_flatten(template, []))
    if len(leaves) != n:
        raise ValueError(f"checkpoint {path} holds {len(leaves)} leaves, the template {n}")
    return _unflatten(template, iter(leaves))
