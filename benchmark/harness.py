"""One run of one cell: set-up, the window, the check, the result line.

  set-up   from the process's start to the first timed call: the CUDA
           context, the kernels from the build cache inside the checkout,
           the mode's set-up (engine, reset, graph capture, warm-up calls)
  window   `--trace 0`: calls back to back for `--seconds` seconds, one call
           in flight while the host waits for the one before, ending in a
           device synchronise; each call is timed by a CUDA event after it.
           `--trace 1`: the traffic's `trace_lead_calls` calls untraced (to
           reach the state the window runs in), then its `trace_calls` calls
           under the profiler (benchmark/trace.py)
  check    the mode's comparison with the plain reference, after the
           window's device memory peak was read; each number against the
           cell's limit

The last lines on standard error are the numbers compared, each beside its
limit; the last line on standard output is the result:
{"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time

import torch

from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "space_gym_tpu")


class RunRecord:
    """What the metric readers read."""

    def __init__(self, mode):
        self.mode = mode
        self.setup_s = None
        self.window = None  # trace 0: seconds, calls, work, call_ms
        self.trace = None   # trace 1: trace.traced_window's dict


def load_mode(reg: Registry, name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark.modes.{name}", reg.mode_path(name))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def window(mode, seconds: float, device) -> dict:
    """Calls back to back for `seconds`: every call's work over the time from
    the first call's start to the end of the last."""
    cuda = device.type == "cuda"
    events = []
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    work = calls = 0
    while True:
        work += mode.call()
        calls += 1
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
            if len(events) > 1:
                events[-2].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    call_ms = ([start.elapsed_time(events[0])]
               + [a.elapsed_time(b) for a, b in zip(events, events[1:])]) if cuda else []
    return {"seconds": wall, "calls": calls, "work": work, "call_ms": call_ms}


def loaded_forbidden() -> list[str]:
    """Modules whose whole top-level name is JAX's, its libraries' or the JAX
    package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def run(args, t_start: float, device=None, reg: Registry | None = None, out=None) -> int:
    """One run of `args.workload`; prints the result line and returns the exit
    code.  `device` set skips the look for a card (the CPU tests)."""
    reg = reg or Registry()
    out = out or sys.stdout
    workload = reg.workload(args.workload)
    config = reg.config(workload["config"])
    traffic = reg.traffic(workload["traffic"])
    if device is None:
        if not torch.cuda.is_available():
            return fail("CUDA is not available")
        if torch.cuda.device_count() < workload["chips"]:
            return fail(f"the cell needs {workload['chips']} cards, "
                        f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    if args.trace and not cuda:
        return fail("a traced run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    mode = load_mode(reg, traffic["mode"]).Mode(config, traffic, args.seed, device)
    rec = RunRecord(mode)
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros((), device=device)  # the CUDA context
        torch.cuda.reset_peak_memory_stats(device)
    mode.setup()
    if cuda:
        torch.cuda.synchronize(device)
    rec.setup_s = time.perf_counter() - t_start

    if args.trace:
        from .trace import traced_window
        for _ in range(traffic.get("trace_lead_calls", 0)):
            mode.call()
        rec.trace = traced_window(mode, traffic["trace_calls"])
        calls = rec.trace["calls"]
    else:
        rec.window = window(mode, args.seconds, device)
        calls = rec.window["calls"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for name in reg.cell_metrics(args.workload, kind):
        mod = reg.metrics()[name]
        value = mod.read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.META["unit"]}

    readings = mode.check()
    limits = workload["limits"]
    correct = all(v <= limits[k] for k, v in readings.items())  # a NaN is never within
    checks = {k: {"value": v if math.isfinite(v) else None, "limit": limits[k]}
              for k, v in readings.items()}

    found = loaded_forbidden()
    if found:
        return fail("modules of JAX or of the JAX package are loaded: " + ", ".join(found))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": calls, "failed": 0, "metrics": metrics,
              "device": dev}
    if rec.trace is not None:
        dev.update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        result["breakdown"] = rec.trace["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
