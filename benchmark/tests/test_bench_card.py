"""On the card, at a size a test run holds: the control fails the collect
cells' limits where the program passes them, and a traced run reads shares
of the chip that stay under 100%.

    python3 -m pytest benchmark/tests/test_bench_card.py -q -p no:cacheprovider
"""
import io
import json
import types

import pytest

from benchmark import harness
from benchmark.registry import Registry

SMALL = {"lanes": 65536, "steps_per_call": 64, "trace_calls": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["goal2p-collect", "goal4p-collect"])
def test_control_fails_where_the_program_passes(cuda_device, cell):
    reg = Registry()
    w = reg.workload(cell)
    traffic = dict(reg.traffic(w["traffic"]), **SMALL)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        mode = harness.load_mode(reg, traffic["mode"]).Mode(reg.config(w["config"]), traffic,
                                                            seed, cuda_device)
        mode.setup()
        mode.call()
        got = mode.check(control=True)
        limits = w["limits"]
        assert all(got["program"][k] <= v for k, v in limits.items()), got
        assert any(not got["control"][k] <= v for k, v in limits.items()), got


@pytest.mark.cuda
def test_traced_run_reads_shares_under_the_peak(cuda_device, bench_copy):
    traffic = json.loads((bench_copy / "traffic" / "random_collect.json").read_text())
    (bench_copy / "traffic" / "random_collect.json").write_text(json.dumps(dict(traffic,
                                                                                **SMALL)))
    out = io.StringIO()
    args = types.SimpleNamespace(workload="goal4p-collect", seed=7, seconds=1, trace=1)
    assert harness.run(args, 0.0, reg=Registry(str(bench_copy)), out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {"device_idle.collect", "mfu.collect", "k3_roofline.collect",
                      "glue_ms.collect"}
    assert 0 < m["mfu.collect"] <= m["k3_roofline.collect"] <= 100
    assert 0 <= m["device_idle.collect"] < 100 and m["glue_ms.collect"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert len(res["breakdown"]["device_ops"]) <= 10 and len(res["breakdown"]["idle_gaps"]) <= 10
