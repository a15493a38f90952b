"""The traced window: `torch.profiler` over a fixed number of calls.

The benchmark's own host ranges label the timeline: `bench.window` around the
whole window, the mode's call range (`bench.replay`, `bench.train_iter`)
around each call, `bench.sync` around the waits.  From the trace:

  busy_s     the union of the device's activity intervals (kernels, copies,
             sets) inside the window
  window_s   the length of `bench.window`
  kernels    {name: [launches, device seconds]}
  hits       the launches of the mode's main kernel
  breakdown  the ten device operations that took most time, and the ten
             longest idle gaps of the device, each named by the innermost host
             operation that was running at its middle

The profiler's buffer can drop device events (a window may miss a third of
its launches): a window that saw fewer launches of the main kernel than the
calls made is taken again, up to `tries` windows, and the one that saw the
most is kept.  The readers of one kernel's time scale by the launches seen
(`hits`), not by the calls made.
"""
from __future__ import annotations

import sys

import torch


def _device_events(prof):
    """The device's own activities: kernels, copies and sets, without the
    device-side copies of host ranges (user annotations)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench.")]


def _host_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CPU and e.time_range.end > e.time_range.start]


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, kernel: str) -> dict:
    """The numbers of one profiled window (times in the trace's microseconds)."""
    host = _host_events(prof)
    win = [e for e in host if e.name == "bench.window"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} bench.window ranges")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = _device_events(prof)
    kernels: dict[str, list] = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    merged = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev
                     if e.time_range.end > w0 and e.time_range.start < w1])
    busy = sum(b - a for a, b in merged) / 1e6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = max(inside, key=lambda e: e.time_range.start).name if inside else "none"
        idle.append([name[:200], length / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy,
        "window_s": (w1 - w0) / 1e6,
        "kernels": kernels,
        "hits": sum(v[0] for k, v in kernels.items() if kernel in k),
        "breakdown": {"device_ops": [[k[:200], v[1]] for k, v in top], "idle_gaps": idle},
    }


def traced_window(mode, calls: int, tries: int = 3) -> dict:
    """`calls` calls of the mode under the profiler; returns `summarize` of
    the last window taken, with the calls made and the episodes they ended."""
    from torch.profiler import ProfilerActivity, profile, record_function

    want = calls * mode.KERNEL_PER_CALL
    best = None
    for attempt in range(tries):
        torch.cuda.synchronize()
        first = len(mode.done_sums)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                for _ in range(calls):
                    with record_function(mode.CALL_RANGE):
                        mode.call()
                with record_function("bench.sync"):
                    torch.cuda.synchronize()
        out = summarize(prof, mode.KERNEL)
        out.update(calls=calls, ended=sum(int(x) for x in mode.done_sums[first:]))
        if best is None or out["hits"] > best["hits"]:
            best = out
        if out["hits"] >= want:
            break
        print(f"the profiler saw {out['hits']} of {want} launches of {mode.KERNEL} "
              f"(window {attempt + 1} of {tries})", file=sys.stderr, flush=True)
    return best
