"""The program's own spans (space_gym_torch/utils/profiling.py), read after
a traced window: while the profiler runs, each span of the program records
its host stamps and its device extent, from two stamps of the device's timer
written in stream order.

The readers of span metrics read them here.  A program that records no
span (one without `profiling.spans`) reads as nothing, and so does a run
without a traced window.  The profiler's windows are `calls` calls each
(benchmark/trace.py, retaken up to three times), and every span the process
kept comes from them: a mean over spans is over every traced call, and a
gap between calls is taken only between two calls of one window.
"""
from __future__ import annotations


def program_spans(rec, name: str):
    """The spans named `name` that the program kept in a traced run, in the
    order they opened; None without a traced window or without spans."""
    if rec.trace is None:
        return None
    try:
        from space_gym_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return [s for s in read() if s["name"] == name]


def _timed(spans):
    return [s for s in spans if s["dev_start_ns"] is not None]


def extent_ms(s) -> float:
    return (s["dev_end_ns"] - s["dev_start_ns"]) / 1e6


def mean_extent_ms(rec, name: str):
    """The mean device extent of the spans named `name`, in ms."""
    spans = _timed(program_spans(rec, name) or [])
    return sum(map(extent_ms, spans)) / len(spans) if spans else None


def mean_gap_ms(rec, name: str):
    """The mean device time from the end of one span named `name` to the
    start of the next, over the pairs of consecutive calls in one window
    (`rec.trace["calls"]` spans a window), in ms."""
    spans = program_spans(rec, name)
    calls = rec.trace["calls"] if rec.trace is not None else 0
    if not spans or calls < 2:
        return None
    gaps = [(b["dev_start_ns"] - a["dev_end_ns"]) / 1e6
            for i, (a, b) in enumerate(zip(spans, spans[1:]))
            if i // calls == (i + 1) // calls and b["it"] == a["it"] + 1
            and a["dev_end_ns"] is not None and b["dev_start_ns"] is not None]
    return sum(gaps) / len(gaps) if gaps else None
