"""The port's checkpoints (space_gym_torch/utils/checkpoint.py), training CLI
(`python -m space_gym_torch.train`) and bench entry (`python -m
space_gym_torch.bench`) on the CPU, at tiny sizes.

A checkpoint holds every leaf of a trainer's state (the fused learner, the
env lanes, the replay ring, the counters) and the generators' states: a run
resumed from it continues as the uninterrupted run does, bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import SACConfig, SACTrainer, convert
from space_gym_torch.models.ppo import PPOConfig, PPOTrainer
from space_gym_torch.utils import checkpoint
from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--iters", "2", "--lanes", "128", "--rollout-len", "4",
        "--batch-size", "128", "--updates-per-iter", "2", "--replay-rows", "16",
        "--hidden", "128", "--log-every", "1", "--eval-every", "2", "--eval-steps", "8"]
ENVS = {"sac": "GoalContinuous2P-v0", "td3": "GoalContinuous2P-v0",
        "ppo": "GoalContinuous2P-v0", "dqn": "GoalDiscrete3-v0"}


def leaves(tree):
    return checkpoint._flatten(tree, [])


def assert_same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        else:
            assert x == y


def sac(fused=True):
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu")
    return SACTrainer(eng, SACConfig(lanes=16, rollout_len=4, replay_rows=16, batch_size=32,
                                     updates_per_iter=2, warmup_rows=4, fused_updates=fused,
                                     fused_block=32))


def ppo():
    eng = EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu")
    return PPOTrainer(eng, PPOConfig(lanes=128, rollout_len=4, epochs=2, minibatches=2))


def test_save_and_restore_give_equal_bits(tmp_path):
    tr = sac()
    st = tr.init(0)
    g = tr.generator(1)
    for _ in range(2):
        st, _ = tr.train_iter(st, g)
    saved = {"state": st, "generator": g.get_state()}
    path = checkpoint.save(str(tmp_path / "ck.pt"), saved)
    back = checkpoint.restore(path, {"state": tr.init(5), "generator": g.get_state()})
    assert_same_bits(back, saved)
    assert back["state"].fused.count == st.fused.count == 4
    assert back["state"].replay.filled == 8
    with pytest.raises(ValueError, match="leaves"):  # another trainer's state
        checkpoint.restore(path, {"state": sac(fused=False).init(0), "generator": g.get_state()})
    with pytest.raises(ValueError, match="does not fit"):  # another configuration's
        checkpoint.restore(path, {"state": st._replace(obs=st.obs[:8]),
                                  "generator": g.get_state()})


@pytest.mark.parametrize("make", [sac, ppo], ids=["sac", "ppo"])
def test_resume_continues_as_the_uninterrupted_run(tmp_path, make):
    tr = make()
    st = tr.init(0)
    g = tr.generator(1)
    for _ in range(2):
        st, _ = tr.train_iter(st, g)
    path = checkpoint.save(str(tmp_path / "ck.pt"), {"state": st, "generator": g.get_state()})
    for _ in range(2):
        st, m = tr.train_iter(st, g)

    tr2 = make()
    g2 = tr2.generator(99)
    back = checkpoint.restore(path, {"state": tr2.init(3), "generator": g2.get_state()})
    g2.set_state(back["generator"])
    st2 = back["state"]
    if getattr(st2, "fused", None) is not None:
        st2 = tr2._refresh_from_fused(st2)
    for _ in range(2):
        st2, m2 = tr2.train_iter(st2, g2)
    assert_same_bits(st2, st)
    assert {k: float(v) for k, v in m2.items()} == pytest.approx(
        {k: float(v) for k, v in m.items()}, nan_ok=True, rel=0, abs=0)


def run_module(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("algo", ["sac", "td3", "ppo", "dqn"])
def test_cli_trains_each_algorithm(tmp_path, algo):
    extra = ["--rollout-len", "32"] if algo == "ppo" else []  # 32 minibatches of 128
    lines = run_module("space_gym_torch.train",
                       TINY + extra + ["--algo", algo, "--env", ENVS[algo], "--ckpt", "ck.pt"],
                       tmp_path)
    iters = [d for d in lines if "env_steps" in d]
    assert [d["iter"] for d in iters] == [1, 2]
    assert all(np.isfinite(d["mean_reward"]) for d in iters)
    assert any("eval_mean_return" in d for d in lines)
    assert lines[-1] == {"checkpoint": "ck.pt", "final": True}
    learner, _, meta = convert.load_learner_npz(str(tmp_path / "ck.pt.best.npz"))
    assert str(meta["env_id"]) == ENVS[algo] and int(meta["step"]) == 2
    # TD3 fused by default, as in tools/train.py; the others' policy as flax arrays
    assert meta["kind"] == {"sac": "actor", "td3": "td3", "ppo": "ppo", "dqn": "dqn"}[algo]
    assert (type(learner).__name__ == "FusedState") == (algo == "td3")


def test_cli_resume_is_the_uninterrupted_run(tmp_path, monkeypatch):
    from space_gym_torch import train

    base = TINY + ["--algo", "sac", "--fused", "--eval-every", "0"]
    monkeypatch.chdir(tmp_path)
    whole = train.main(base + ["--iters", "4", "--ckpt", "whole.pt"])
    train.main(base + ["--iters", "2", "--ckpt", "part.pt"])
    resumed = train.main(base + ["--iters", "4", "--ckpt", "part.pt", "--resume"])
    assert_same_bits(resumed, whole)
    with pytest.raises(SystemExit, match="does not match"):  # another configuration's
        train.main(base + ["--iters", "4", "--ckpt", "part.pt", "--resume", "--lanes", "64"])


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_cli_cross_format_resume(tmp_path, monkeypatch, capsys, algo):
    """tests/test_aux.py::test_train_cli_cross_format_resume in process: a
    fused save resumed without --fused re-hydrates the parameters and Adam
    moments (the trained actor comes back, not the frozen init snapshot);
    that unfused save resumed with --fused migrates; a resume in the
    checkpoint's own format prints neither."""
    from space_gym_torch import train

    base = TINY + ["--algo", algo, "--eval-every", "0", "--ckpt", "ck.pt"]
    monkeypatch.chdir(tmp_path)

    def run(*extra):
        state = train.main(base + list(extra))
        return state, capsys.readouterr().out

    fused, _ = run("--fused", "--iters", "2")
    back, out = run("--no-fused", "--iters", "2", "--resume")  # no iteration left to run
    assert "re-hydrated" in out and "migrated" not in out and "resumed from" in out
    assert back.fused is None and back.step == fused.step == 2
    assert_same_bits(back.actor_params, fused.actor_params)
    st, out = run("--fused", "--iters", "3", "--resume")
    assert "migrated" in out and "re-hydrated" not in out
    assert st.fused is not None and st.step == 3
    _, out = run("--fused", "--iters", "4", "--resume")
    assert "resumed from" in out and "migrated" not in out and "re-hydrated" not in out


def test_bench_smoke_prints_one_line(tmp_path):
    lines = run_module("space_gym_torch.bench", ["--device", "cpu", "--smoke"], tmp_path)
    assert len(lines) == 1
    d = lines[0]
    for k in ("metric", "value", "unit", "value_mean", "value_std", "repeat_values", "batch",
              "warmup_s", "tableau", "substeps", "refine", "rng", "device_kind"):
        assert k in d, k
    assert d["value"] > 0 and d["batch"] == 512 and d["device_kind"] == "cpu"
    assert (d["tableau"], d["substeps"], d["refine"], d["rng"]) == ("bs3", 1, 8, "bulk")
    assert "vs_baseline" not in d


def test_profiling_trace_and_meter(tmp_path):
    from space_gym_torch.utils import profiling

    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    meter = profiling.ThroughputMeter(window=2)
    assert meter.rate != meter.rate  # NaN before two ticks
    for n in (0, 100, 100, 100):
        meter.tick(n)
    assert meter.rate > 0 and len(meter._counts) == 3
