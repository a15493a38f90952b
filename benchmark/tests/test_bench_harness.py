"""The harness on the CPU at a tiny size: a run end to end, the faults its
check must catch, what it refuses, and the files it finds by name."""
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from benchmark import faults, harness
from benchmark.registry import Registry

from .conftest import BENCH, ROOT


def run_cell(reg, workload, seed=2**31 + 11, seconds=0.2):
    """harness.run on the CPU; (exit code, the result line or None)."""
    out = io.StringIO()
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    rc = harness.run(args, 0.0, device=torch.device("cpu"), reg=reg, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_tiny_run_is_correct(bench_copy, capsys):
    rc, res = run_cell(Registry(str(bench_copy)), "goal2p-tiny")
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "env_steps_per_s"}
    assert set(res["checks"]) == {"lanes_off_pct", "reward_sum_gap_pct"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("check lanes_off_pct ") and " limit " in err[-2]


@pytest.mark.parametrize("fault", ["collect.unchanged", "collect.half", "collect.altered"])
def test_faults_are_not_correct(bench_copy, fault):
    with faults.plant(fault):
        rc, res = run_cell(Registry(str(bench_copy)), "goal4p-tiny")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["lanes_off_pct"]["value"] > res["checks"]["lanes_off_pct"]["limit"]


def test_control_is_not_correct(bench_copy):
    """The reference in bfloat16 in the program's place fails the cell's
    limits, where the program passes them."""
    reg = Registry(str(bench_copy))
    w = reg.workload("goal2p-tiny")
    mode = harness.load_mode(reg, "collect").Mode(reg.config("goal2p"), reg.traffic("tiny_collect"),
                                                  3, torch.device("cpu"))
    mode.setup()
    mode.call()
    got = mode.check(control=True)
    assert all(v <= w["limits"][k] for k, v in got["program"].items())
    assert any(v > w["limits"][k] for k, v in got["control"].items())


def test_forbidden_modules_refuse_the_run(bench_copy, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = run_cell(Registry(str(bench_copy)), "goal2p-tiny")
    assert rc != 0 and res is None
    assert "jax" in capsys.readouterr().err
    assert harness.loaded_forbidden() == ["jax"]
    monkeypatch.setitem(sys.modules, "space_gym_tpux", types.ModuleType("space_gym_tpux"))
    assert harness.loaded_forbidden() == ["jax"]  # whole top-level names only


def test_run_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run exits with an error and prints no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "goal2p-collect",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(bench_copy):
    """A configuration, a traffic mix, a cell and a metric dropped in as new
    files are found by name and run, with no file that was there edited."""
    before = _digests(bench_copy)
    with open(bench_copy / "configs" / "goal2p.json") as f:
        cfg = json.load(f)
    cfg["env"].update(env_id="GoalContinuous3P-v0", n_planets=3)
    (bench_copy / "configs" / "goal3p.json").write_text(json.dumps(dict(cfg, name="goal3p")))
    traffic = json.loads((bench_copy / "traffic" / "tiny_collect.json").read_text())
    (bench_copy / "traffic" / "short_collect.json").write_text(
        json.dumps(dict(traffic, steps_per_call=3)))
    (bench_copy / "workloads" / "goal3p-short.json").write_text(json.dumps({
        "config": "goal3p", "traffic": "short_collect", "chips": 1, "why": "a new cell",
        "metrics": ["setup_s", "calls_per_s"],
        "limits": {"lanes_off_pct": 1.0, "reward_sum_gap_pct": 1.0}}))
    (bench_copy / "metrics" / "calls_per_s.py").write_text(
        'META = {"name": "calls_per_s", "kind": "end_to_end", "unit": "1/s", '
        '"better": "higher", "bound": 0.05, "source": "host_clock"}\n\n\n'
        'def read(rec):\n    return rec.window["calls"] / rec.window["seconds"]\n')
    reg = Registry(str(bench_copy))
    man = reg.manifest()
    assert "goal3p" in [c["name"] for c in man["configs"]]
    cell = [w for w in man["workloads"] if w["name"] == "goal3p-short"]
    assert cell == [{"name": "goal3p-short", "config": "goal3p", "traffic": "short_collect",
                     "chips": 1, "why": "a new cell"}]
    metric = [m for m in man["end_to_end"] if m["name"] == "calls_per_s"][0]
    assert metric["workloads"] == ["goal3p-short"]
    setup = [m for m in man["end_to_end"] if m["name"] == "setup_s"][0]
    assert "workloads" not in setup  # every cell reports it, the new one too
    rc, res = run_cell(reg, "goal3p-short")
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "calls_per_s"}
    after = _digests(bench_copy)
    assert {k: v for k, v in after.items() if k in before} == before


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        b = json.load(f)
    assert b == Registry().manifest()  # built from the files under benchmark/
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert "workloads" not in e2e["setup_s"]  # every cell reports it
    for cell in cells:
        reported = [m for m in b["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


def test_kernel_readers_scale_by_the_launches_seen():
    """A traced window in which the profiler saw half of K3's launches reads
    the same K3 share and glue time as one that saw them all."""
    reg = Registry()
    mods = reg.metrics()
    mode = types.SimpleNamespace(KERNEL="full_step_kernel", KERNEL_PER_CALL=4,
                                 least_seconds=lambda calls, ended: 1e-3 * calls)

    def reading(hits, scale):
        trace = {"calls": 2, "ended": 0, "hits": hits,
                 "kernels": {"full_step_kernel": [hits, 0.004 * scale],
                             "copy": [hits, 0.002 * scale]}}
        rec = types.SimpleNamespace(mode=mode, trace=trace)
        return [mods[n].read(rec) for n in ("k3_roofline.collect", "glue_ms.collect")]

    assert reading(8, 1.0) == pytest.approx(reading(4, 0.5))
    assert reading(8, 1.0) == pytest.approx([50.0, 0.25])
