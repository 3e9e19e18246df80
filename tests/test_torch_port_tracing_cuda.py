"""The program's spans on the card: marks inside captured steps.

Marked `cuda`: each test skips without an NVIDIA GPU.  Imports no JAX:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_tracing_cuda.py -q

* with the spans off, a captured step launches no mark, has no ring, loads
  no mark library, and its `kernels` are the traced capture's;
* with them on, the same step's replays are bit-equal to the untraced
  step's, its graph has one node more per mark than the untraced graph
  (cudaGraphGetNodes), and R + 3 replays wrap
  the ring: the last R replays read back, each nested and monotone;
* a `torch.cuda._sleep` between two marks of a captured step reads within
  10% of CUDA events around the replay;
* each mark kernel that torch.profiler records sits at one offset from the
  `%globaltimer` it stored, to within 5 us inside a replay and about the
  line of the two clocks' rate across replays (the clock check; the
  profiler's clock has run up to 0.44% fast or slow of `%globaltimer`).
"""
import collections
import ctypes
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.utils import graphs, profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    try:
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        profiling.tracing(False)


def _leaves(dev, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, 16, 12, 10)),
            rng.uniform(-1, 1, (2, 36, 12, 10)),
            rng.uniform(0, 1, (2, 18, 12, 10)),
            rng.standard_normal((24, 16, 3, 3)) * 0.1,
            rng.standard_normal((24,))]
    return [torch.tensor(a, dtype=torch.float32, device=dev,
                         requires_grad=True) for a in arrs]


def _step(x, off, mask, w, b):
    """Two public op calls and the gradients of their loss."""
    with profiling.span("outer", x):
        out = mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, 1, 2,
                                          impl="cuda")
        out = mdt.modulated_deform_conv2d(out[:, :16].contiguous(), off,
                                          mask, w, b, 1, 1, 1, 1, 2,
                                          impl="cuda")
    return (out.detach(),) + torch.autograd.grad(
        (out * out).sum(), (x, off, mask, w, b))


def _nodes(graph) -> int:
    """The captured graph's node count (cudaGraphGetNodes)."""
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    rt.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(graph.raw_cuda_graph(), None,
                                ctypes.byref(n)) == 0
    return n.value


def test_off_and_on_captures(dev, monkeypatch):
    graph = torch.cuda.CUDAGraph
    # Graphs that keep their cudaGraph_t after the capture.
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: graph(keep_graph=True))
    ins = _leaves(dev)

    def refuse(*a, **k):
        raise AssertionError("a mark with the spans off")
    with monkeypatch.context() as m:
        m.setattr(profiling, "_launch_mark", refuse)
        m.setattr(profiling, "_mark_lib", refuse)
        off = graphs.capture(_step, *ins)
        want = [t.clone() for t in off(*ins)]
    assert off.record is None and off.spans() == []

    with profiling.tracing(True):
        on = graphs.capture(_step, *ins)
    got = [t.clone() for t in on(*ins)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert on.kernels == off.kernels
    # outer, mdc.step and two forwards and backwards: 12 marks, each a node;
    # the untraced graph is the traced one without them.
    assert on.record.width == 12
    assert _nodes(on.graph) == _nodes(off.graph) + 12


def test_ring_wraps_with_nested_monotone_spans(dev):
    ins = _leaves(dev, 1)
    with profiling.tracing(True):
        step = graphs.capture(_step, *ins)
    rows = step.record.rows
    for _ in range(rows + 3):
        step()
    spans = step.spans()
    units = collections.defaultdict(list)
    for s in spans:
        units[s["replay"]].append(s)
    assert sorted(units) == list(range(3, rows + 3))
    starts = []
    for r in sorted(units):
        u = units[r]
        assert [s["name"] for s in u] == [
            "mdc.step", "outer", "mdc.dcn.fwd", "mdc.dcn.fwd", "mdc.dcn.bwd",
            "mdc.dcn.bwd"]
        assert [s["parent"] for s in u] == [None, 0, 1, 1, 0, 0]
        by = {s["index"]: s for s in u}
        for s in u:
            assert s["start_ns"] <= s["end_ns"] and s["self_ns"] >= 0
            if s["parent"] is not None:
                p = by[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                    p["end_ns"]
        assert [s["attrs"]["call"] for s in u[2:]] == [0, 1, 1, 0]
        starts.append(u[0]["start_ns"])
        ends = sorted(s["end_ns"] for s in u)
        assert ends[-1] == u[0]["end_ns"]
    assert all(b > a for a, b in zip(starts, starts[1:]))


def test_sleep_between_marks_reads_as_events(dev):
    z = torch.zeros(1, device=dev)
    cycles = 20_000_000      # ~10 ms at the H100's clock

    def fn():
        with profiling.span("sleep", z):
            torch.cuda._sleep(cycles)
        return z

    with profiling.tracing(True):
        step = graphs.capture(fn)
    spans = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        sleep, = [s for s in step.spans() if s["name"] == "sleep"][-1:]
        spans.append(((sleep["end_ns"] - sleep["start_ns"]) / 1e6,
                      a.elapsed_time(b)))
    for span_ms, event_ms in spans:
        assert span_ms == pytest.approx(event_ms, rel=0.1), spans


def test_marks_sit_on_the_profiler_clock(dev):
    ins = _leaves(dev, 2)
    with profiling.tracing(True):
        step = graphs.capture(_step, *ins)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n = 20
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    marks = step.record.marks()[-n:]
    got = profiling.clock_offsets(events, marks)
    summary = {k: v for k, v in got.items()
               if k not in ("offsets_ns", "ts_ns")}
    assert got["found"] >= 0.9 and got["replays_matched"] >= n // 2, summary
    # One offset within each replay; across replays one offset and one
    # rate: the profiler's clock may run fast or slow of %globaltimer.
    assert got["within_replay_ns"] <= 5000, summary
    assert got["spread_about_drift_ns"] <= 5000, summary
    assert abs(got["drift_ppm"]) <= 1e4, summary
