"""Fixtures of the benchmark's tests: a copy of the benchmark's files with a
tiny traffic mix for the CPU, and the card for the tests marked `cuda`."""
import json
import os
import shutil

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {"lanes": 96, "steps_per_call": 6, "warmup_calls": 1, "trace_calls": 1}
TINY_SAC = {"lanes": 64, "rollout_len": 4, "batch_size": 128, "updates_per_iter": 2,
            "replay_rows": 16, "hidden": 128, "warmup_calls": 1, "fused_block": 128}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of benchmark/ (without its tests) with `tiny_collect`, a small
    collection mix, and a `<config>-tiny` cell on it for each configuration,
    and `goal2p-sac-tiny` on `tiny_sac`, a small SAC job."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(root / "traffic" / "random_collect.json") as f:
        traffic = json.load(f)
    traffic.update(TINY)
    (root / "traffic" / "tiny_collect.json").write_text(json.dumps(traffic))
    with open(root / "traffic" / "sac_documented.json") as f:
        traffic = json.load(f)
    (root / "traffic" / "tiny_sac.json").write_text(json.dumps(dict(traffic, **TINY_SAC)))
    with open(root / "workloads" / "goal2p-sac.json") as f:
        w = json.load(f)
    (root / "workloads" / "goal2p-sac-tiny.json").write_text(json.dumps(dict(w,
                                                                             traffic="tiny_sac")))
    for name in ("goal2p", "goal4p"):
        with open(root / "workloads" / f"{name}-collect.json") as f:
            w = json.load(f)
        w["traffic"] = "tiny_collect"
        (root / "workloads" / f"{name}-tiny.json").write_text(json.dumps(w))
    return root


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
