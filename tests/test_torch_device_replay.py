"""The port's device parity tier: every recorded golden episode (tests/goldens,
7 env IDs x 2 seed sets, 2774 steps) replayed through the port's own
EnvEngine (space_gym_torch/parity/device_replay.py: float64 adaptive
physics, semantic draws through the sequential-exact tiling twin, the
numpy-exact ops of ops/exact.py) on the CPU, in this process.

Tolerance: none.  The reset state, obs, planets and goal, and at every step
the state, the post-step goal, obs, reward, done and truncated are bit for
bit the reference's.  A negative control replays one file with the parity
mode off and must find steps that differ: the bitwise result comes from the
exact ops, not from a comparison that cannot fail.
"""
import contextlib
import functools

import pytest

from space_gym_torch.ops import exact
from space_gym_torch.parity import device_replay as replay

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

CASES = [(subset, env_id) for subset in replay.GOLDEN_SETS for env_id in replay.GOLDEN_IDS]


@functools.cache
def _replayed(subset, env_id):
    return replay.replay(env_id, subset, device="cpu")


@pytest.mark.parametrize("subset,env_id", CASES)
def test_golden_file_replays_bitwise(subset, env_id):
    st = _replayed(subset, env_id)
    assert st["bitwise"], st
    assert st["steps"] > 0 and st["max_state_err"] == st["max_obs_err"] == 0.0
    assert st["host_round_trips"] == 0  # the CPU calls the library in place


def test_every_golden_step_is_replayed():
    assert sum(_replayed(*c)["steps"] for c in CASES) > 2500


def test_without_the_exact_ops_some_step_differs(monkeypatch):
    monkeypatch.setattr(exact, "parity", contextlib.nullcontext)
    st = replay.replay("GoalContinuous2P-v0", "", device="cpu")
    assert not st["bitwise"]
    assert st["state_bitwise"] < st["steps"] and st["max_state_err"] > 0
    assert st["flag_match"] == st["steps"]  # still the same trajectory, to an ulp or so
