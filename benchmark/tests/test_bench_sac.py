"""The SAC cell's run and check on the CPU at a tiny size: the program's
plain K-update passes, each planted fault and the control fail."""
import io
import json
import types

import pytest
import torch

from benchmark import faults, harness
from benchmark.registry import Registry


def run_cell(reg, workload, seed=2**31 + 13):
    out = io.StringIO()
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.3, trace=0)
    rc = harness.run(args, 0.0, device=torch.device("cpu"), reg=reg, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_tiny_sac_is_correct(bench_copy):
    rc, res = run_cell(Registry(str(bench_copy)), "goal2p-sac-tiny")
    assert rc == 0 and res["correct"] is True, res
    assert set(res["metrics"]) == {"setup_s", "train_env_steps_per_s"}
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap", "end_lanes_off_pct",
                                  "end_loss_gap", "end_change_gap"}


@pytest.mark.parametrize("fault", ["sac.unchanged", "sac.half", "sac.altered", "sac.insert"])
def test_faults_are_not_correct(bench_copy, fault):
    with faults.plant(fault):
        rc, res = run_cell(Registry(str(bench_copy)), "goal2p-sac-tiny")
    assert rc == 0 and res["correct"] is False, res


def test_control_is_not_correct(bench_copy):
    reg = Registry(str(bench_copy))
    w = reg.workload("goal2p-sac-tiny")
    mode = harness.load_mode(reg, "sac").Mode(reg.config("goal2p"), reg.traffic("tiny_sac"), 3,
                                              torch.device("cpu"))
    mode.setup()
    got = mode.check(control=True)
    assert all(v <= w["limits"][k] for k, v in got["program"].items())
    assert any(v > w["limits"][k] for k, v in got["control"].items())


def test_the_end_check_reads_the_wrapped_ring(bench_copy):
    """The start is sound and the ring has wrapped when the window's end call
    writes its rows one rollout past the cursor: the end check alone sees it."""
    reg = Registry(str(bench_copy))
    w = reg.workload("goal2p-sac-tiny")
    mode = harness.load_mode(reg, "sac").Mode(reg.config("goal2p"), reg.traffic("tiny_sac"), 4,
                                              torch.device("cpu"))
    mode.setup()
    for _ in range(6):
        mode.call()
    assert mode.state.replay.cursor > 2 * mode.state.replay.data.shape[0]
    with faults.plant("sac.insert"):
        got = mode.check()
    start = ("loss_gap", "grad_gap", "change_gap")
    assert all(got[k] <= w["limits"][k] for k in start), got
    assert got["end_lanes_off_pct"] > w["limits"]["end_lanes_off_pct"], got
