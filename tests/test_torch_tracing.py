"""The port's tracing (space_gym_torch/utils/profiling.py) on the CPU: spans
off and on, their nesting, their host stamps against the profiler's ranges,
`trace`'s files, the launch counts, and the spans of a `train_iter`."""
import json
import types

import numpy as np
import pytest
import torch

from space_gym_torch import get_config
from space_gym_torch.engine import EnvEngine
from space_gym_torch.models import SACConfig, SACTrainer
from space_gym_torch.utils import graphs, profiling

from .torch_scenarios import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear_spans()
    profiling.reset_counts()
    yield
    profiling.clear_spans()
    profiling.reset_counts()


def test_a_span_off_is_a_shared_null_context(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: made.append(a))
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("off"), profiling.span("off", device="cpu", it=3, x=1)
    assert a is b
    with a:
        pass
    assert made == [] and profiling.spans() == []


def test_nesting_gives_parents_and_iteration_ids():
    with profiling.tracing():
        with profiling.span("outer", it=7, kind="test"):
            with profiling.span("mid"):
                with profiling.span("inner", it=3):
                    pass
            with profiling.span("mid"):
                pass
        with profiling.span("alone"):
            pass
    got = profiling.spans()
    assert [s["name"] for s in got] == ["sg.outer", "sg.mid", "sg.inner", "sg.mid", "sg.alone"]
    outer, mid, inner, mid2, alone = got
    assert outer["parent"] is None and outer["it"] == 7 and outer["args"] == {"kind": "test"}
    assert mid["parent"] == "sg.outer" and mid["parent_id"] == outer["id"] and mid["it"] == 7
    assert inner["parent_id"] == mid["id"] and inner["it"] == 3
    assert mid2["parent_id"] == outer["id"] and alone["parent"] is None and alone["it"] is None
    for s in got:  # no device: no device extent
        assert s["host_start_ns"] <= s["host_end_ns"] and s["dev_start_ns"] is None
    assert outer["host_start_ns"] <= inner["host_start_ns"] <= inner["host_end_ns"] \
        <= outer["host_end_ns"]
    profiling.clear_spans()
    assert profiling.spans() == []


def test_host_stamps_lie_on_the_profilers_ranges():
    """A span under torch.profiler is its `sg.` range, and its host stamps,
    in time.time_ns(), lie within 1 ms of the range's on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("timed"):
                torch.ones(1000).sum()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "sg.timed")
    got = profiling.spans()
    assert len(ranges) == len(got) == 3
    for (a, b), s in zip(ranges, got):
        assert abs(s["host_start_ns"] - a) < 1_000_000 and abs(s["host_end_ns"] - b) < 1_000_000
    assert not torch.autograd._profiler_enabled() and profiling.span("x") is profiling.span("y")


def test_trace_writes_the_spans_beside_the_trace(tmp_path):
    with profiling.tracing():
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("inside", it=1):
            torch.zeros(8).add_(1)
    assert (tmp_path / "trace.json").is_file()
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert [s["name"] for s in spans] == ["sg.inside"] and spans[0]["it"] == 1


def test_a_span_under_capture_records_no_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with profiling.tracing():
        with profiling.span("captured", device=torch.device("cuda", 0)):
            pass
    (s,) = profiling.spans()
    assert s["dev_start_ns"] is None and s["host_end_ns"] is not None


class _Clock:
    """One made-up host clock and a device timer that runs 10 ppm fast from
    another origin, the stamps on the CPU; the references taken are counted."""

    def __init__(self, monkeypatch):
        self.ns = self.origin = 1_760_000_000_123_456_789
        self.refs = 0
        clock = self

        class Device(profiling._DeviceClock):
            def __init__(self, idx):
                super().__init__(idx, device="cpu")

            def sync(self):
                pass

            def stamp(self, slot):
                self.slots[slot] = clock.device_ns()

            def reference(self):
                taken = self.refs
                ref = super().reference()
                clock.refs += self.refs - taken
                return ref

        monkeypatch.setattr(profiling, "_DeviceClock", Device)
        monkeypatch.setattr(profiling, "_clocks", {})
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=lambda: clock.ns))

    def device_ns(self):
        return self.ns - self.origin + (self.ns - self.origin) // 100_000 + 987_654_321

    def span(self):
        with profiling.span("timed", device=torch.device("cuda", 0)):
            self.ns += 1000
        return profiling.spans()[-1]


def test_a_reference_taken_long_ago_is_not_reused(monkeypatch, tmp_path):
    """Device stamps stay on the host clock: an outermost span that finds the
    reference over a second old takes a new one, an inner
    span keeps its parent's, and each tracing block, profiler session and
    trace() starts with a new one."""
    c = _Clock(monkeypatch)

    def close(s):  # within the drift of 1.5 s; an hour's is 36 ms
        assert abs(s["dev_start_ns"] - s["host_start_ns"]) < 20_000
        assert abs(s["dev_end_ns"] - s["host_end_ns"]) < 20_000
        assert s["dev_end_ns"] - s["dev_start_ns"] == 1000 + 1000 // 100_000

    with profiling.tracing():
        close(c.span())
        for syncs in (1, 2, 2, 3):  # spans 0.6 s apart
            c.ns += 600_000_007
            close(c.span())
            assert c.refs == syncs
        c.ns += 3600 * 10**9
        close(c.span())
        assert c.refs == 4
        with profiling.span("outer", device=torch.device("cuda", 0)):
            c.ns += 1_500_000_003
            close(c.span())
        assert c.refs == 4
    c.ns += 10**6
    with profiling.tracing():
        close(c.span())
    assert c.refs == 5
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        close(c.span())
        close(c.span())
    assert c.refs == 6
    with profiling.trace(str(tmp_path)):
        close(c.span())
    assert c.refs == 7


def test_a_span_whose_stamps_went_round_is_not_timed(monkeypatch):
    """The stamps are rings: a span whose slots later spans took (one open
    around more spans than the ring keeps), or whose reference later
    references took, reads no device extent, and the later spans keep theirs."""
    c = _Clock(monkeypatch)
    monkeypatch.setattr(profiling, "SLOTS", 8)  # four spans
    with profiling.tracing():
        with profiling.span("outer", device=torch.device("cuda", 0)):
            for _ in range(5):
                with profiling.span("inner", device=torch.device("cuda", 0)):
                    c.ns += 1000
    outer, *inner = profiling.spans()
    assert outer["dev_start_ns"] is None and inner[0]["dev_start_ns"] is None
    assert all(s["dev_end_ns"] - s["dev_start_ns"] == 1000 for s in inner[1:])
    profiling.clear_spans()
    monkeypatch.setattr(profiling, "REFS", 2)
    for _ in range(3):  # a reference each
        with profiling.tracing():
            with profiling.span("alone", device=torch.device("cuda", 0)):
                c.ns += 1000
    first, *later = profiling.spans()
    assert first["dev_start_ns"] is None and c.refs == 4
    assert all(s["dev_end_ns"] - s["dev_start_ns"] == 1000 for s in later)


def test_counts_keep_the_launch_semantics(monkeypatch):
    """A launch is counted at once; under capture it enters the graph, whose
    every replay adds it; reset_counts sets all to 0.  (Kernels launch only
    on the card: here the capture state is set by hand.)"""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    profiling.launch("full_step")
    profiling.launch("full_step")
    profiling.launch("sac_update")
    assert profiling.counts() == {"full_step": 2, "sac_update": 1}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with profiling.captured_launches() as graph:
        for _ in range(8):
            profiling.launch("full_step_philox")
        assert graph == {}  # filled when the capture ends
    assert graph == {"full_step_philox": 8}
    assert profiling.counts() == {"full_step": 2, "sac_update": 1}
    for _ in range(2):
        profiling.add(graph)
    assert profiling.counts()["full_step_philox"] == 16
    with profiling.captured_launches() as again:
        pass
    assert again == {}
    profiling.reset_counts()
    assert profiling.counts() == {}


def test_a_failed_capture_counts_no_graph():
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.Captured(lambda x: x, (torch.zeros(2),), None)
    assert profiling.counts() == {}


@pytest.fixture(scope="module")
def sac():
    tr = SACTrainer(EnvEngine(get_config("GoalContinuous2P-v0"), device="cpu"),
                    SACConfig(lanes=16, rollout_len=4, replay_rows=16, batch_size=32,
                              updates_per_iter=2, warmup_rows=8, fused_updates=True))
    return tr, tr.init(0)


def test_train_iter_spans(sac):
    """Off, a train_iter records nothing; under tracing() it is `sg.train_iter`
    around its rollout, insert and update, all with the state's step."""
    tr, st = sac
    g = tr.generator(1)
    st, _ = tr.train_iter(st, g)  # the ring below the warm-up gate: no update
    assert profiling.spans() == []
    with profiling.tracing():
        st, _ = tr.train_iter(st, g)
    got = profiling.spans()
    assert [s["name"] for s in got] == ["sg.train_iter", "sg.rollout", "sg.insert",
                                        "sg.update"]
    it = got[0]
    assert it["it"] == st.step - 1 and it["parent"] is None
    assert all(s["parent_id"] == it["id"] and s["it"] == it["it"] for s in got[1:])
    assert all(it["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"]
               <= it["host_end_ns"] for s in got[1:])
