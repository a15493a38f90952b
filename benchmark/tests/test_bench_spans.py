"""The readers of the program's spans (benchmark/spans.py and the metrics
that use it) on made-up spans, without spans, and, on the card, after a
traced window of each mode.

    python3 -m pytest benchmark/tests/test_bench_spans.py -q -p no:cacheprovider
"""
import types

import pytest

from benchmark import harness, spans
from benchmark.registry import Registry
from benchmark.trace import traced_window

NEW = {"rollout_ms.train", "insert_ms.train", "update_ms.train", "iter_gap_ms.train",
       "graph_captures.train", "call_gap_ms.collect", "call_io_ms.collect"}
MS = 1_000_000


def span(name, id, start, end, it=None, parent=None, parent_id=None):
    """A span as profiling.spans() gives it, its device stamps in ms."""
    return {"name": name, "id": id, "parent": parent, "parent_id": parent_id, "it": it,
            "host_start_ns": 0, "host_end_ns": 0, "args": {},
            "dev_start_ns": None if start is None else round(start * MS),
            "dev_end_ns": None if end is None else round(end * MS)}


def rec(calls=3):
    return types.SimpleNamespace(trace={"calls": calls})


@pytest.fixture
def program(monkeypatch):
    from space_gym_torch.utils import profiling

    def use(made):
        monkeypatch.setattr(profiling, "spans", lambda: list(made))
    return use


def read(name, r):
    return Registry().metrics()[name].read(r)


def test_train_readers(program):
    made, n = [], 0
    # two windows of three train_iters (steps 10-12, then 13-15): a gap of 0.1
    # ms between calls of a window, 500 ms between the windows
    t = 0.0
    for step in range(10, 16):
        if step == 13:
            t += 500.0
        base = n
        made += [span("sg.train_iter", base, t, t + 11.0, it=step),
                 span("sg.rollout", base + 1, t, t + 0.6, step, "sg.train_iter", base),
                 span("sg.graph.call", base + 2, t, t + 0.6, 1, "sg.rollout", base + 1),
                 span("sg.insert", base + 3, t + 0.6, t + 0.7, step, "sg.train_iter", base),
                 span("sg.update", base + 4, t + 0.7, t + 11.0, step, "sg.train_iter", base)]
        n += 5
        t += 11.1
    made.append(span("sg.graph.capture", n, t, t + 1.0, 1, "sg.graph.call", 2))
    program(made)
    r = rec()
    assert read("rollout_ms.train", r) == pytest.approx(0.6)
    assert read("insert_ms.train", r) == pytest.approx(0.1)
    assert read("update_ms.train", r) == pytest.approx(10.3)
    assert read("iter_gap_ms.train", r) == pytest.approx(0.1)  # the 500 ms between windows left out
    assert read("graph_captures.train", r) == 1
    program(made[:-1])
    assert read("graph_captures.train", r) == 0
    assert read("call_gap_ms.collect", r) is None  # no captured call stands alone here
    assert spans.mean_gap_ms(r, "sg.graph.call") is None  # all call 1: no consecutive pair


def test_collect_readers(program):
    made, t = [], 0.0
    for i in range(4):
        made += [span("sg.graph.call", 2 * i, t, t + 42.0, it=i + 1),
                 span("sg.graph.replay", 2 * i + 1, t + 0.1, t + 41.9, i + 1, "sg.graph.call",
                      2 * i)]
        t += 42.0 + 0.01 * (i + 1)
    program(made)
    assert read("call_io_ms.collect", rec(4)) == pytest.approx(0.2)
    assert read("call_gap_ms.collect", rec(4)) == pytest.approx(0.02)
    assert read("call_gap_ms.collect", rec(2)) == pytest.approx(0.02)  # pairs (1, 2), (3, 4)
    made.append(span("sg.graph.call", 8, None, None, it=5))  # opened under capture: no extent
    program(made)
    assert read("call_io_ms.collect", rec(5)) == pytest.approx(0.2)


def test_nothing_without_spans_or_a_traced_window(program):
    program([])
    for name in NEW:
        assert read(name, rec()) is None, name
        assert read(name, types.SimpleNamespace(trace=None)) is None, name


def test_nothing_from_a_program_without_spans(monkeypatch):
    """The program before spans: utils/profiling.py has no `spans`."""
    from space_gym_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in NEW:
        assert read(name, rec()) is None, name


def test_the_new_metrics_name_their_cells():
    reg = Registry()
    for name in NEW:
        m = reg.metrics()[name].META
        assert m["kind"] == "per_layer" and m["source"] == "program_span"
        assert reg.cells_of(name) == sorted(m["workloads"])
        for cell in m["workloads"]:
            assert m["moves"] in reg.cell_metrics(cell, "end_to_end")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["goal2p-tiny", "goal2p-sac-tiny"])
def test_traced_window_reads_the_spans(cuda_device, bench_copy, cell):
    """On the card: a traced window of each mode gives the cell's span
    metrics, and the profiler's kernels hold no `sg.` range."""
    from space_gym_torch.utils import profiling

    reg = Registry(str(bench_copy))
    w = reg.workload(cell)
    traffic = dict(reg.traffic(w["traffic"]), trace_calls=3)
    mode = harness.load_mode(reg, traffic["mode"]).Mode(reg.config(w["config"]), traffic,
                                                        2**31 + 17, cuda_device)
    mode.setup()
    profiling.clear_spans()
    r = harness.RunRecord(mode)
    r.trace = traced_window(mode, traffic["trace_calls"])
    assert not [k for k in r.trace["kernels"] if k.startswith("sg.")], r.trace["kernels"]
    names = ({"rollout_ms.train", "insert_ms.train", "update_ms.train", "iter_gap_ms.train",
              "graph_captures.train"} if "sac" in cell
             else {"call_gap_ms.collect", "call_io_ms.collect"})
    got = {n: reg.metrics()[n].read(r) for n in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    if "sac" in cell:
        assert got["graph_captures.train"] == 0
        assert got["update_ms.train"] > got["insert_ms.train"]
    profiling.clear_spans()
