"""A function of tensors captured into one CUDA graph and replayed.

The port's counterpart of a jitted `lax.scan`: `EnvEngine.capture_rollout`
captures a rollout's T steps (policy, action translate, K3, the writes of
the step's fields) once and replays them, so that the host issues one graph
launch where it issued some 30 operations a step.

`Captured(fn, args, generator)`:
  * copies `args` into static buffers, runs `fn` on them once eagerly on a
    side stream (the warm-up: it builds and loads the kernels' libraries,
    sets their attributes and occupancy caches, and makes cuBLAS's handles),
    puts the generator back where it was, and captures `fn` on the static
    buffers;
  * registers the generator with the graph, so that each replay draws the
    numbers the same calls would draw eagerly from the generator's state at
    that time, and advances it as far;
  * on a call, copies the new arguments into the static buffers, replays,
    and returns clones of the outputs (a tree of tuples, dicts and tensors):
    nothing the caller keeps is overwritten by the next replay.

What `fn` reads besides its arguments (a policy's parameters) is read where
it lives at each replay.  `fn` must not synchronise with the host, and must
not make a tensor from host data.  A capture that fails raises; there is no
eager fallback.

Launch counts.  A kernel wrapper counts a launch that runs; under capture its
launch only enters the graph, so the wrapper calls `note_launch(name)`,
which records it for the graph being captured instead.  Each replay then adds
the graph's launches to `REPLAYED`, which `reset_launches` sets to 0.
"""
from __future__ import annotations

import torch

# kernel name -> its launches in the graph being captured
_CAPTURING: dict[str, int] = {}
# kernel name -> launches made by graph replays since the last reset
REPLAYED: dict[str, int] = {}


def note_launch(name: str) -> bool:
    """Called by a kernel wrapper where it launches kernel `name`: True when
    the launch runs now (the wrapper counts it), False when it is recorded
    into the graph being captured (each replay counts it)."""
    if torch.cuda.is_current_stream_capturing():
        _CAPTURING[name] = _CAPTURING.get(name, 0) + 1
        return False
    return True


def reset_launches():
    REPLAYED.clear()


def _tree_map(fn, tree):
    """fn over the tensors of a tree of tuples, NamedTuples and dicts;
    anything else passes as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class Captured:
    """`fn(*args)` captured once, replayed on every call (see the module
    docstring).  `launches`: the kernels' launches one replay makes."""

    def __init__(self, fn, args, generator: torch.Generator):
        dev = args[0].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
        if generator is None or generator.device.type != "cuda" or (
                generator.device.index not in (None, dev.index)):
            raise ValueError("the captured function draws from an explicit generator on "
                             f"{dev}, got {generator!r}")
        self.static_in = [a.clone() for a in args]
        side = torch.cuda.Stream(device=dev)
        saved = generator.get_state()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        generator.set_state(saved)

        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        _CAPTURING.clear()
        try:
            with torch.cuda.graph(self.graph, stream=side):
                self.static_out = fn(*self.static_in)
            self.launches = dict(_CAPTURING)
        finally:
            _CAPTURING.clear()
        if not torch.equal(generator.get_state(), saved):
            raise RuntimeError("capturing the graph moved its generator")

    def __call__(self, *args):
        if len(args) != len(self.static_in):
            raise ValueError(f"captured with {len(self.static_in)} arguments, got {len(args)}")
        for s, a in zip(self.static_in, args):
            if s.shape != a.shape or s.dtype != a.dtype or s.device != a.device:
                raise ValueError(f"argument {tuple(a.shape)} {a.dtype} {a.device} does not fit "
                                 f"the captured {tuple(s.shape)} {s.dtype} {s.device}")
            s.copy_(a)
        self.graph.replay()
        for k, n in self.launches.items():
            REPLAYED[k] = REPLAYED.get(k, 0) + n
        return _tree_map(torch.clone, self.static_out)
