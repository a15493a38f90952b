"""Profiling hooks: a torch.profiler trace and a steps/s meter.

Port of space_gym_tpu/utils/profiling.py.  `trace(log_dir)` records the CPU
and, where there is a card, the CUDA activity of its block with
`torch.profiler` and writes a Chrome trace (view it in Perfetto).
`ThroughputMeter` counts items over a sliding window of ticks; `sync` waits
for the card, since PyTorch returns before the device finishes.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with torch.profiler; writes `<log_dir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """env-steps/s (and anything/s) over a sliding window.

    Call `sync()` before `tick`, so that the tick follows the device's work
    and not its enqueue."""

    def __init__(self, window: int = 20):
        self.window = window
        self._times = []
        self._counts = []

    @staticmethod
    def sync(x=None):
        """Wait for the card (no-op without one); returns x."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return x

    def tick(self, n_items: int):
        self._times.append(time.perf_counter())
        self._counts.append(n_items)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._counts.pop(0)

    @property
    def rate(self) -> float:
        if len(self._times) < 2:
            return float("nan")
        dt = self._times[-1] - self._times[0]
        return sum(self._counts[1:]) / dt if dt > 0 else float("nan")
