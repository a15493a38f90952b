"""TD3's faults, planted underneath the timed path to see goal2p-td3's check
fail.  Each is a context manager that patches the program for the length of
the `with` and puts it back after:

  td3.unchanged    the K-update reports its losses, the learner unchanged
  td3.half         each minibatch is half of its rows, twice
  td3.nosmooth     the K-update runs without the target smoothing noise
  td3.actor_every  the actor and the targets move on every update, not on
                   every `policy_delay`-th
  td3.insert       the replay insert writes its rows one rollout past the
                   cursor (faults.py's sac.insert: the insert is shared)

The benchmark's runs plant none; the tests plant each on the CPU, and

    python3 -m benchmark.faults_td3 --workload goal2p-td3 --seeds 1 2 3 --calls 300 \\
        --fault td3.half

reads one on the card: benchmark.limits with its `--fault` taking these names
besides faults.py's.
"""
from __future__ import annotations

import contextlib
import sys

from . import faults

KINDS = ("unchanged", "half", "nosmooth", "actor_every", "insert")


@contextlib.contextmanager
def _patched(cls, name, make):
    """`cls.name` replaced by make(the method it had, inherited or its own)."""
    own = name in vars(cls)
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        if own:
            setattr(cls, name, orig)
        else:
            delattr(cls, name)


def _unchanged(orig):
    def _update_fused(self, state, generator=None, **kw):
        saved = [x.clone() for x in state.fused[:6]]
        state, metrics = orig(self, state, generator, **kw)
        for x, s in zip(state.fused[:6], saved):
            x.copy_(s)
        return state, metrics
    return _update_fused


def _with_config(**change):
    """The K-update run under the trainer's configuration with `change`."""
    def make(orig):
        def _update_fused(self, state, generator=None, **kw):
            cfg = self.cfg
            self.cfg = cfg._replace(**change)
            try:
                return orig(self, state, generator, **kw)
            finally:
                self.cfg = cfg
        return _update_fused
    return make


def plant(name: str):
    """The context manager of fault `name` (the module docstring)."""
    from space_gym_torch.models.td3 import TD3Trainer

    mode, _, kind = name.partition(".")
    if mode != "td3" or kind not in KINDS:
        raise KeyError(f"no TD3 fault named {name!r}")
    if kind == "insert":
        return faults.plant("sac.insert")
    if kind == "half":
        return _patched(TD3Trainer, "_fused_minibatches", faults._sac_rows())
    if kind == "unchanged":
        return _patched(TD3Trainer, "_update_fused", _unchanged)
    change = {"smooth_std": 0.0} if kind == "nosmooth" else {"policy_delay": 1}
    return _patched(TD3Trainer, "_update_fused", _with_config(**change))


def main(argv=None) -> int:
    """benchmark.limits with TD3's faults among the names `--fault` takes."""
    from . import limits

    accepted = faults.plant
    faults.plant = lambda name: plant(name) if name.startswith("td3.") else accepted(name)
    try:
        return limits.main(argv)
    finally:
        faults.plant = accepted


if __name__ == "__main__":
    sys.exit(main())
