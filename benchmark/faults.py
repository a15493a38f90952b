"""Faults planted underneath the timed path, to see the check fail.

Each is a context manager that patches one of the program's classes for the
length of the `with` and puts it back after:

  collect.unchanged   the env step returns its state as it was
  collect.half        the env step leaves half of the lanes out
  collect.altered     the env step's ship x comes out moved by 0.05
  sac.unchanged       the K-update reports its losses, the learner unchanged
  sac.half            each minibatch is half of its rows, twice
  sac.altered         the reported critic loss is 2% high
  sac.insert          the replay insert writes its rows one rollout past the
                      cursor, which it then advances as it should

The benchmark's runs plant none; the tests plant each on the CPU, and
`python3 -m benchmark.limits --fault <name>` reads one on the card.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def _env_step(kind):
    def make(orig):
        def step_carry(self, carry, raw_action, generator=None):
            new, ts = orig(self, carry, raw_action, generator)
            if kind == "unchanged":
                return carry, ts
            if kind == "half":
                h = carry.y.shape[1] // 2
                return type(new)(*[torch.cat([n[:, :h], c[:, h:]], dim=1)
                                   for n, c in zip(new, carry)]), ts
            y = new.y.clone()
            y[0] += 0.05
            return new._replace(y=y), ts
        return step_carry
    return make


def _sac_update(kind):
    def make(orig):
        def _update_fused(self, state, generator=None, **kw):
            if kind == "unchanged":
                saved = [x.clone() for x in state.fused[:6]]
                state, metrics = orig(self, state, generator, **kw)
                for x, s in zip(state.fused[:6], saved):
                    x.copy_(s)
                return state, metrics
            state, metrics = orig(self, state, generator, **kw)
            return state, dict(metrics, critic_loss=metrics["critic_loss"] * 1.02)
        return _update_fused
    return make


def _sac_rows():
    def make(orig):
        def _fused_minibatches(self, state, generator, row_idx, batches):
            ring, rows, batches = orig(self, state, generator, row_idx, batches)
            rpb = self.cfg.batch_size // ring.shape[2]
            r = rows.reshape(-1, rpb)
            half = r[:, : max(rpb // 2, 1)]
            return ring, half.repeat(1, rpb // half.shape[1]).reshape(-1), batches
        return _fused_minibatches
    return make


def _insert():
    def make(orig):
        def replay_add_slab(state, slab):
            t = slab.obs.shape[0]
            new = orig(state._replace(cursor=state.cursor + t), slab)
            return new._replace(cursor=state.cursor + t)
        return replay_add_slab
    return make


def plant(name: str):
    """The context manager of fault `name` (the module docstring)."""
    from space_gym_torch.engine.core import EnvEngine
    from space_gym_torch.models.sac import SACTrainer

    from space_gym_torch.models import offpolicy

    mode, kind = name.split(".")
    if mode == "collect":
        return _patched(EnvEngine, "step_carry", _env_step(kind))
    if kind == "insert":
        return _patched(offpolicy, "replay_add_slab", _insert())
    if kind == "half":
        return _patched(SACTrainer, "_fused_minibatches", _sac_rows())
    return _patched(SACTrainer, "_update_fused", _sac_update(kind))

