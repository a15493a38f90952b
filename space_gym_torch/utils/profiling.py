"""The port's tracing: spans at its layer boundaries, the kernel launch
counts, a torch.profiler trace and a steps/s meter.

Spans.  `span(name)` marks a block of host code, such as a `train_iter` or a
captured rollout's call.  It is on while a `torch.profiler` is active or
inside `tracing()`, and off everywhere else, where it costs one check and
returns a shared null context.  When on it records:

  * a `torch.profiler.record_function` range `sg.<name>`, so the span sits on
    the profiler's timeline, nested under the caller's ranges;
  * an entry in memory (`spans()`): its name, its id, the span open around
    it (`parent`, `parent_id`), an iteration id (`it`: given, or the
    parent's), its host start and end in `time.time_ns()`, the clock of the
    profiler's host events;
  * on a CUDA device, two stamps of the device's nanosecond timer, written
    in stream order by a one-thread kernel (csrc/span_stamp.cu) at entry and
    at exit: the span's device extent, from the moment the stream reaches
    its first work to the moment it finishes its last, idle between them
    included.  The stamps are put on the host stamps' clock by a reference
    stamp taken right after a synchronise: at a session's first span (a
    `tracing()` block, a profiler's session, `trace()`), and again by an
    outermost span that finds it over a second old.  A kernel and not a
    CUDA timing event: under the profiler a timing event on the stream holds
    the first launch of a large CUDA graph back by milliseconds.  These
    kernels are the spans' cost on the device, and appear among the
    profiler's kernels as `span_stamp`.

A span opened while the current stream is being captured into a CUDA graph
stamps nothing.  `spans()` reads the stamps and their references,
synchronising the devices, so that a traced block copies nothing back.  At
most `MAX_SPANS` entries are kept (the oldest go first); `clear_spans()`
empties the list.  `prepare(device)` loads a device's clock (its kernel,
built if stale and its module loaded, and its slots) where a traced path is
set up, so that no traced span does.

Spans of the program (`sg.` on the profiler's timeline):

  train_iter     OffPolicyTrainer.train_iter (it = the state's step)
  rollout        its rollout: the trainer's PolicyRollout
  insert         its n-step slab and replay ring insert
  update         its K updates (draws, the fused kernel, refresh)
  graph.capture  a CUDA graph's eager warm-up and capture (utils/graphs.py)
  graph.call     a captured rollout's call: the copies in, the replay, the
                 clones out (EnvEngine.capture_rollout; it = its call count)
  graph.replay   the replay alone

Counts.  `launch(kernel)` counts a kernel wrapper's launch under the
kernel's name, or, while a CUDA graph is captured, records it into the
graph, whose every replay adds it (`add`); `Captured` adds 1 to
`graph.capture` for each graph it captures.  `counts()` reads them all,
`reset_counts()` sets them to 0.

`trace(log_dir)` records its block with torch.profiler and writes
`trace.json` (a Chrome trace: open it in Perfetto) and `spans.json` (the
block's spans).  `ThroughputMeter` counts items over a sliding window of
ticks; `sync` waits for the card, since PyTorch returns before the device
finishes.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import json
import os
import time

import torch

MAX_SPANS = 1 << 16

# name -> count since the last reset_counts()
_COUNTS: dict[str, int] = {}
# kernel name -> its launches in the CUDA graph being captured
_CAPTURING: dict[str, int] = {}


def launch(name: str):
    """A kernel wrapper's launch of kernel `name`: counted now, or, while a
    CUDA graph is being captured, recorded into the graph (`captured_launches`)."""
    if torch.cuda.is_current_stream_capturing():
        _CAPTURING[name] = _CAPTURING.get(name, 0) + 1
    else:
        add({name: 1})


def add(counts: dict):
    """Add {name: n} to the counts."""
    for k, n in counts.items():
        _COUNTS[k] = _COUNTS.get(k, 0) + n


def counts() -> dict:
    """{name: count} since the last reset: kernel launches by kernel name (a
    graph's replays add its launches), `graph.capture`."""
    return dict(_COUNTS)


def reset_counts():
    _COUNTS.clear()


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture: yields the {kernel: launches} that the
    wrappers record into it, filled when the block ends."""
    _CAPTURING.clear()
    out: dict[str, int] = {}
    try:
        yield out
        out.update(_CAPTURING)
    finally:
        _CAPTURING.clear()


# ------------------------------------------------------------------ spans --
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_open: list = []          # the spans open now, innermost last
_ids = itertools.count()
_clocks: dict = {}        # device index -> _DeviceClock
_depth = 0                # tracing() blocks open
_profiled = False         # a profiler was on at the last span() call
_NULL = contextlib.nullcontext()
REFERENCE_NS = 1_000_000_000
SLOTS = 2 * MAX_SPANS     # a device's span stamps kept: two for each span kept
REFS = 1024               # its references kept


@functools.cache
def _stamp_lib():
    from . import cuda_build

    lib = cuda_build.load("span_stamp")
    lib.sg_span_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sg_span_stamp.restype = ctypes.c_int
    return lib


class _DeviceClock:
    """A device's span stamps: two rings of int64 slots that the `span_stamp`
    kernel (csrc/span_stamp.cu) fills with the device's nanosecond timer in
    stream order, `SLOTS` for the spans and `REFS` for the references.  A
    stamp's number counts the stamps of its ring so far; a ring that has
    gone round since no longer holds it."""

    def __init__(self, idx: int, device=None):
        self.idx = idx
        self.slots = torch.empty(SLOTS + REFS, dtype=torch.int64,
                                 device=device or torch.device("cuda", idx))
        self.count = self.refs = 0
        self.ref = None  # the reference: its stamp's number, its host time

    def sync(self):
        torch.cuda.synchronize(self.idx)

    def stamp(self, slot: int):
        """Enqueue a read of the timer into `slot` on the current stream."""
        if torch.cuda.current_device() != self.idx:
            with torch.cuda.device(self.idx):
                return self.stamp(slot)
        err = _stamp_lib().sg_span_stamp(self.slots.data_ptr() + 8 * slot,
                                         torch.cuda.current_stream(self.idx).cuda_stream)
        if err:
            raise RuntimeError(f"span_stamp kernel launch failed: error {err}")

    def reference(self) -> tuple:
        """A stamp taken right after a synchronise, with the host time it
        stands for: a new session takes a new one, and so does an outermost
        span that finds it over `REFERENCE_NS` old, since the clocks drift.
        Read with the spans, so that a traced window copies nothing back."""
        if self.ref is None or (not _open and time.time_ns() - self.ref[1] > REFERENCE_NS):
            self.sync()
            self.refs += 1
            self.ref = (self.refs - 1, time.time_ns())
            self.stamp(SLOTS + self.ref[0] % REFS)
        return self.ref

    def take(self) -> int:
        """The number of a span's start stamp; its end's is the next."""
        self.count += 2
        return self.count - 2

    def kept(self, seq: int, ref: int) -> bool:
        return self.count - seq <= SLOTS and self.refs - ref <= REFS

    def read(self):
        """Every slot, after a synchronise."""
        self.sync()
        return self.slots.cpu().numpy()


def _clock(idx: int) -> _DeviceClock:
    c = _clocks.get(idx)
    if c is None:
        c = _clocks[idx] = _DeviceClock(idx)
    return c


def prepare(device):
    """Load the span clock of a CUDA `device`: its kernel (built if stale,
    its module loaded by one stamp) and its slots.  A caller that sets up a
    traced path calls this, so that no traced span does it."""
    device = torch.device(device)
    if device.type == "cuda":
        c = _clock(device.index if device.index is not None else torch.cuda.current_device())
        c.stamp(0)
        c.sync()


def _new_session():
    """Tracing starts again: each device's next span takes a new reference."""
    for c in _clocks.values():
        c.ref = None


class _Span:
    __slots__ = ("name", "id", "parent", "parent_id", "it", "args", "host", "clock", "ref",
                 "seq", "dev", "_rf")

    def __init__(self, name, device, it, args):
        self.name = "sg." + name
        self.id = next(_ids)
        up = _open[-1] if _open else None
        self.parent = up.name if up else None
        self.parent_id = up.id if up else None
        self.it = it if it is not None or up is None else up.it
        self.args = args
        self.host = [None, None]
        self.clock = self.dev = None
        device = torch.device(device) if device is not None else None
        if (device is not None and device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self.clock = _clock(device.index if device.index is not None
                                else torch.cuda.current_device())
            self.ref = self.clock.reference()
            self.seq = self.clock.take()

    def __enter__(self):
        self._rf = torch.profiler.record_function(
            self.name, json.dumps(self.args) if self.args else None)
        self._rf.__enter__()
        self.host[0] = time.time_ns()
        if self.clock is not None:
            self.clock.stamp(self.seq % SLOTS)
        _open.append(self)
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        if self.clock is not None:
            if self.clock.kept(self.seq, self.ref[0]):
                self.clock.stamp(self.seq % SLOTS + 1)
            else:  # its slots went round to later spans
                self.clock = None
        self.host[1] = time.time_ns()
        _open.pop()
        self._rf.__exit__(*exc)
        self._rf = None
        return False

    def record(self, read: dict) -> dict:
        if self.clock is not None:  # read once
            c, self.clock = self.clock, None
            if c.kept(self.seq, self.ref[0]):
                if c.idx not in read:
                    read[c.idx] = c.read()
                ring, a = read[c.idx], self.seq % SLOTS
                offset = self.ref[1] - int(ring[SLOTS + self.ref[0] % REFS])
                self.dev = [int(ring[a]) + offset, int(ring[a + 1]) + offset]
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "parent_id": self.parent_id, "it": self.it, "host_start_ns": self.host[0],
                "host_end_ns": self.host[1],
                "dev_start_ns": self.dev[0] if self.dev else None,
                "dev_end_ns": self.dev[1] if self.dev else None, "args": self.args}


def span(name: str, device=None, it=None, **args):
    """A span `sg.<name>` around a block (see the module docstring): timed on
    the device where `device` is a CUDA device; `it` is its iteration id (the
    parent's by default); `args` are kept with it and given to the profiler's
    range."""
    global _profiled
    on = torch.autograd._profiler_enabled()
    if on and not _profiled:  # a profiler session begins
        _new_session()
    _profiled = on
    if not (on or _depth):
        return _NULL
    return _Span(name, device, it, args)


@contextlib.contextmanager
def tracing():
    """Spans on without a profiler.  A block opened outside any other is a
    new session: the first span on a device synchronises it."""
    global _depth
    if _depth == 0:
        _new_session()
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def spans(since: int = 0) -> list[dict]:
    """The kept spans that have ended, in the order they opened, with ids
    from `since` on.  Reads their devices' stamps after synchronising them."""
    read: dict = {}
    return [s.record(read) for s in list(_spans) if s.id >= since and s.host[1] is not None]


def clear_spans():
    _spans.clear()


# -------------------------------------------------------------- exporters --
@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with torch.profiler; writes `<log_dir>/trace.json`
    and the block's spans to `<log_dir>/spans.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _new_session()
    first = next(_ids)  # ids only grow: every span of the block comes after it
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(spans(since=first), f)


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
