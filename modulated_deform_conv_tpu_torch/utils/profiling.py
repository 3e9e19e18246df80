"""Tracing and timing: the program's spans, host ranges, a profiler trace
and an event timer.

The port's counterpart of the JAX package's `utils/profiling.py` (which
imports jax, so nothing of it is imported here):

* `tracing(on)`: the process-wide switch of the program's spans, off by
  default; a call or a context manager (`with tracing(True): ...`, which
  puts the previous state back on exit).  Nothing else turns them on.
* `span(name, at, **attrs)` (and `begin` / `end`): a named span of device
  time, between two marks on the device of `at` (a tensor or a device).
  On a CUDA device a mark is one one-thread kernel on the current stream
  (`csrc/trace_mark.cu`) that stores the GPU's `%globaltimer` (ns) into a
  ring on the device: no synchronisation, no profiler.  Inside a capture
  (`utils/graphs.py::capture` opens a `StepRecord`) each mark becomes a
  node of the graph with a slot fixed at the capture, so every replay
  stamps its own spans into its own row.  Outside a capture the marks go
  to a process-wide ring, which `spans()` reads.  On the CPU a mark is the
  host's `time.perf_counter_ns()`, since eager CPU work is synchronous.
  With the switch off, `span` is one flag test and marks nothing.
* `annotate(name)`: a host span: a `record_function` range (seen by
  `trace` and any torch.profiler, on the profiler's clock) and an entry in
  an in-memory record on `time.perf_counter_ns()` (`host_spans()`).
* `trace(logdir)`: a `torch.profiler` trace of the block, written as a
  Chrome trace file under `logdir`;
* `Timer(device)`: the elapsed time of a block, on CUDA events of the
  named CUDA device, or on the host clock for device="cpu" only.

A span has a parent (the innermost span open when it began) and belongs to
one record unit: a replay of a captured step, or, for eager spans, the
tree under one root span.  Read spans are dicts {"replay", "index",
"name", "parent", "start_ns", "end_ns", "self_ns", "attrs"}: `index` is the
span's place in its unit in the order the spans began, `parent` the
parent's index (None for a root), `self_ns` its duration minus its
children's.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

logger = logging.getLogger("modulated_deform_conv_tpu_torch")

# Rows of a captured step's ring: the last RING_ROWS replays are readable.
RING_ROWS = 1024
# Marks the process-wide ring holds on each device, and eager spans kept.
EAGER_MARKS = 1 << 16
EAGER_SPANS = 1 << 14
# Host spans kept by `annotate`.
HOST_SPANS = 1 << 16

_on = False
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Are the program's spans on?"""
    return _on


class tracing:
    """Turn the program's spans on or off for the process: `tracing(True)`
    as a call, or `with tracing(True):` for a block (the state before is
    put back on exit).  A step captured while they are on keeps its marks
    on every replay, whatever the state when it replays."""

    def __init__(self, on: bool = True):
        global _on
        self._prev, _on = _on, bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _on
        _on = self._prev
        return False


# ---- the mark kernel -------------------------------------------------------

_MARK = {}
_MARK_LOCK = threading.Lock()


def _mark_lib():
    """csrc/trace_mark.cu's entries, built and loaded at the first mark on
    a card (never by the kernels' build)."""
    with _MARK_LOCK:
        if not _MARK:
            from ..ops.cuda import lib
            path = lib._lib_path("trace_mark")
            if not path.exists():
                lib.build(["trace_mark"])
            so = ctypes.CDLL(str(path))
            mark, steps = so.trace_mark, so.trace_clock_steps
            mark.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
                ctypes.c_int] * 4 + [ctypes.c_void_p]
            steps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_void_p]
            mark.restype = steps.restype = ctypes.c_int
            _MARK.update(mark=mark, steps=steps)
        return _MARK


def _launch_mark(device, ring: int, ctr: int, slot: int, rows: int,
                 width: int, advance: bool) -> None:
    fn = _mark_lib()["mark"]
    with torch.cuda.device(device):
        err = fn(ring, ctr, slot, rows, width, int(advance),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"trace_mark: kernel launch failed with CUDA "
                           f"error {err}")


def clock_steps(device="cuda", n: int = 64) -> List[int]:
    """The first n distinct values of `%globaltimer` one thread reads back
    to back (ns): their differences are the timer's resolution."""
    device = _device(device)
    out = torch.zeros(n, dtype=torch.int64, device=device)
    fn = _mark_lib()["steps"]
    with torch.cuda.device(device):
        err = fn(out.data_ptr(), n, 1 << 26,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"trace_clock_steps: kernel launch failed with "
                           f"CUDA error {err}")
    return [v for v in out.tolist() if v]


# ---- records ---------------------------------------------------------------

class _Span:
    __slots__ = ("name", "parent", "unit", "index", "ordinal", "begin", "end",
                 "attrs")

    def __init__(self, name, parent, unit, index, ordinal, begin, attrs):
        self.name, self.parent, self.unit = name, parent, unit
        self.index, self.ordinal, self.begin = index, ordinal, begin
        self.end, self.attrs = None, attrs


class _Record:
    """Spans and the marks they take: the nesting, shared by the eager
    record and a captured step's.  A subclass makes the marks (`_mark`,
    returning the mark's id); `spans` keeps the spans begun."""

    def __init__(self, spans):
        self.spans = spans
        self.open: List[_Span] = []
        self._unit = -1
        self._next = 0
        self._names: Dict[str, int] = {}

    def begin(self, name: str, device, attrs: dict) -> _Span:
        parent = self.open[-1] if self.open else None
        if parent is None:
            self._unit += 1
            self._next, self._names = 0, {}
        ordinal = self._names.get(name, 0)
        self._names[name] = ordinal + 1
        sp = _Span(name, parent, self._unit, self._next, ordinal,
                   self._mark(device, False), attrs)
        self._next += 1
        self.open.append(sp)
        self.spans.append(sp)
        return sp

    def end(self, sp: _Span, device, last: bool = False) -> None:
        sp.end = self._mark(device, last)
        self.open.remove(sp)


def _rows(spans: List[_Span], value, unit_of) -> List[dict]:
    """Read spans as dicts, `value(mark)` giving a mark's time."""
    out = []
    for sp in spans:
        out.append({"replay": unit_of(sp), "index": sp.index, "name": sp.name,
                    "parent": None if sp.parent is None else sp.parent.index,
                    "start_ns": value(sp.begin), "end_ns": value(sp.end),
                    "attrs": dict(sp.attrs)})
    by_unit = collections.defaultdict(dict)
    for r in out:
        by_unit[r["replay"]][r["index"]] = r
        r["self_ns"] = r["end_ns"] - r["start_ns"]
    for r in out:
        p = by_unit[r["replay"]].get(r["parent"])
        if p is not None:
            p["self_ns"] -= r["end_ns"] - r["start_ns"]
    return out


class _EagerRecord(_Record):
    """The process-wide record of marks made outside a capture: on the CPU
    host times, on a card a ring of EAGER_MARKS marks a device; the last
    EAGER_SPANS spans are kept."""

    def __init__(self):
        super().__init__(collections.deque(maxlen=EAGER_SPANS))
        self.marks: Dict[torch.device, int] = collections.defaultdict(int)
        self.host: Dict[int, int] = {}
        self.rings: Dict[torch.device, torch.Tensor] = {}

    def _mark(self, device, last):
        n = self.marks[device]
        self.marks[device] = n + 1
        if device.type != "cuda":
            self.host[n % EAGER_MARKS] = time.perf_counter_ns()
            return (device, n)
        ring = self.rings.get(device)
        if ring is None:
            # The marks' slots, then a counter that stays 0 (one row).
            ring = self.rings[device] = torch.zeros(
                EAGER_MARKS + 1, dtype=torch.int64, device=device)
        _launch_mark(device, ring.data_ptr(), ring[EAGER_MARKS].data_ptr(),
                     n % EAGER_MARKS, 1, EAGER_MARKS, False)
        return (device, n)

    def read(self) -> List[dict]:
        copies = {}
        for device, ring in self.rings.items():
            torch.cuda.synchronize(device)
            copies[device] = ring[:EAGER_MARKS].tolist()

        def live(mark):
            device, n = mark
            return self.marks[device] - n <= EAGER_MARKS

        def value(mark):
            device, n = mark
            if device.type != "cuda":
                return self.host[n % EAGER_MARKS]
            return copies[device][n % EAGER_MARKS]

        done = [sp for sp in self.spans
                if sp.end is not None and live(sp.begin) and live(sp.end)]
        return _rows(done, value, lambda sp: sp.unit)


class StepRecord(_Record):
    """A captured step's spans: `width` marks a replay, each with its slot
    fixed at the capture, in a ring of `rows` replays on the device (int64
    ns, then the replay counter), allocated here, outside the graph's
    pool.  The step's last mark (its root span's end) advances the
    counter, so consecutive replays fill consecutive rows."""

    def __init__(self, device, width: int, rows: int = RING_ROWS):
        super().__init__([])
        self.device, self.width, self.rows = _device(device), width, rows
        self.buf = torch.zeros(rows * width + 1, dtype=torch.int64,
                               device=self.device)
        self.slots = 0

    def _mark(self, device, last):
        if _device(device) != self.device:
            raise RuntimeError(f"a mark on {device} inside a step captured "
                               f"on {self.device}")
        slot = self.slots
        if slot >= self.width:
            raise RuntimeError(f"the step makes more than the {self.width} "
                               "marks its warm-up made")
        self.slots += 1
        base = self.buf.data_ptr()
        _launch_mark(self.device, base, base + 8 * self.rows * self.width,
                     slot, self.rows, self.width, last)
        return slot

    def marks(self) -> List[tuple]:
        """(replay, its `width` marks in slot order, ns) of the last
        min(replays, rows) replays (0 the first replay); one
        synchronisation and one copy of the ring."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        host = self.buf.tolist()
        n, w = host[-1], self.width
        return [(r, host[(r % self.rows) * w:(r % self.rows + 1) * w])
                for r in range(max(0, n - self.rows), n)]

    def read(self) -> List[dict]:
        """The spans of the last min(replays, rows) replays, each replay's
        spans under its replay number."""
        out = []
        for r, row in self.marks():
            out += _rows(self.spans, row.__getitem__, lambda sp, r=r: r)
        return out


_EAGER = _EagerRecord()
_record: _Record = _EAGER


@contextlib.contextmanager
def recording(record: Optional[_Record]) -> Iterator[None]:
    """While open, marks go to `record` (a captured step's); None leaves
    them where they go."""
    global _record
    if record is None:
        yield
        return
    saved, _record = _record, record
    try:
        yield
    finally:
        _record = saved


def _device(at) -> torch.device:
    d = at.device if isinstance(at, torch.Tensor) else torch.device(at)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def begin(name: str, at, **attrs) -> _Span:
    """Open a span: a mark on `at`'s device.  Marks whatever the switch
    says (a caller tests `enabled()` first)."""
    return _record.begin(name, _device(at), attrs)


def end(sp: _Span, at) -> None:
    """Close the span: a mark on `at`'s device."""
    _record.end(sp, _device(at))


class _SpanBlock:
    __slots__ = ("name", "at", "attrs", "sp")

    def __init__(self, name, at, attrs):
        self.name, self.at, self.attrs = name, at, attrs

    def __enter__(self):
        self.sp = begin(self.name, self.at, **self.attrs)
        return self.sp

    def __exit__(self, *exc):
        end(self.sp, self.at)
        return False


def span(name: str, at, **attrs):
    """A span around a block, on `at`'s device (a tensor or a device); with
    the switch off, a shared no-op context manager."""
    if not _on:
        return _NULL
    return _SpanBlock(name, at, attrs)


def spans() -> List[dict]:
    """The eager spans still in the process-wide record (synchronises each
    card marked on, and copies its ring once)."""
    return _EAGER.read()


def marks(device) -> int:
    """Eager marks made so far on the device."""
    return _EAGER.marks[_device(device)]


def clock_offsets(events: List[dict], step_marks: List[tuple]) -> dict:
    """Where a captured step's marks sit on a torch.profiler trace's clock.

    `events`: the trace's complete events (Chrome trace dicts, "ts" in
    us); `step_marks`: `StepRecord.marks()` of the replays the trace
    holds, in order.  Each mark kernel the trace recorded gives an offset,
    its "ts" (ns) minus the `%globaltimer` it stored.  A replay's mark
    kernels share its graph launch's correlation id.  The replays are
    matched to the rows from the last one back (a trace may miss the first
    replays, never the last), then each replay whose every mark was
    recorded to the row whose offsets lie nearest the median, slot by
    slot.  Returns {"offsets_ns" (one a matched mark), "ts_ns" (its trace
    time), "spread_ns" (the offsets' range), "within_replay_ns" (the
    widest range inside one replay), "drift_ppm" (the least-squares rate
    of the offsets in trace time: the two clocks' rates differ by it),
    "spread_about_drift_ns" (the offsets' range about that line), "found"
    (the share of the rows' marks the trace holds), "replays_matched"}."""
    width = len(step_marks[0][1]) if step_marks else 0
    groups = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel" and "trace_mark_kernel" in e["name"]:
            groups[e.get("args", {}).get("correlation")].append(
                float(e["ts"]) * 1e3)
    found = sum(len(g) for g in groups.values())
    replays = sorted((sorted(g) for g in groups.values()), key=lambda g: g[0])
    rows = [row for _, row in step_marks]
    out = {"offsets_ns": [], "ts_ns": [], "spread_ns": None,
           "within_replay_ns": None, "drift_ppm": None,
           "spread_about_drift_ns": None,
           "found": found / max(1, width * len(rows)), "replays_matched": 0}
    full = [g for g in replays if len(g) == width]
    if not full or not rows:
        return out
    guess = sorted(g[0] - r[0] for g, r in zip(replays[::-1], rows[::-1])
                   if len(g) == width)
    mid = guess[len(guess) // 2]
    per = []
    for g in full:
        row = min(rows, key=lambda r: abs(g[0] - r[0] - mid))
        per.append([t - v for t, v in zip(g, row)])
    offsets = [o for p in per for o in p]
    ts = [t for g in full for t in g]
    # Least squares of offset against time, about the means.
    mt, mo = sum(ts) / len(ts), sum(offsets) / len(offsets)
    stt = sum((t - mt) ** 2 for t in ts)
    slope = (sum((t - mt) * (o - mo) for t, o in zip(ts, offsets)) / stt
             if stt else 0.0)
    resid = [o - mo - slope * (t - mt) for t, o in zip(ts, offsets)]
    out.update(offsets_ns=offsets, ts_ns=ts,
               spread_ns=max(offsets) - min(offsets),
               within_replay_ns=max(max(p) - min(p) for p in per),
               drift_ppm=slope * 1e6,
               spread_about_drift_ns=max(resid) - min(resid),
               replays_matched=len(full))
    return out


# ---- host spans, the profiler, the event timer ----------------------------

_HOST = collections.deque(maxlen=HOST_SPANS)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A host span: `torch.profiler.record_function` (seen by `trace`) and
    an entry (name, start, end on `time.perf_counter_ns()`) in the record
    `host_spans()` reads."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            _HOST.append((name, t0, time.perf_counter_ns()))


def host_spans(name: Optional[str] = None) -> List[dict]:
    """The last HOST_SPANS host spans ({"name", "start_ns", "end_ns"}),
    those of one name where given."""
    return [{"name": n, "start_ns": a, "end_ns": b} for n, a, b in _HOST
            if name is None or n == name]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block with `torch.profiler` (CPU activity, and the
    CUDA devices' kernels where CUDA is available) and write the trace to
    `logdir/trace-<pid>-<n>.json` (Chrome trace format: Perfetto or
    chrome://tracing open it).  Yields the profiler, whose
    `key_averages()` the caller may read after the block; its `path`
    attribute holds the file written."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith("trace-")])
        prof.path = os.path.join(logdir, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(prof.path)


class Timer:
    """The elapsed time of a block on the named device, `elapsed_ms`.

    On a CUDA device, CUDA events are recorded on its current stream
    around the block and the exit synchronises on the end event, so the
    time is the device's time from the first to the last work queued in
    the block.  The host clock is used only for device="cpu", where the
    caller asked for it; a CUDA device that is not there raises."""

    def __init__(self, device, name: str = "timer"):
        self.device = torch.device(device)
        self.name = name
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"Timer({str(self.device)!r}): no CUDA "
                                   "device is visible")
        elif self.device.type != "cpu":
            raise ValueError(f"Timer: device 'cuda[:n]' or 'cpu', got "
                             f"{self.device}")
        self.elapsed_ms: Optional[float] = None
        self._start = self._end = None
        self._t0 = 0.0

    def __enter__(self):
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._end.record(torch.cuda.current_stream(self.device))
            self._end.synchronize()
            self.elapsed_ms = self._start.elapsed_time(self._end)
        else:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        logger.info("%s: %.4f ms on %s", self.name, self.elapsed_ms,
                    self.device)
        return False
