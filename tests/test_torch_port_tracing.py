"""The program's spans (utils/profiling.py) on the CPU, where a mark is the
host's `time.perf_counter_ns()`.

* off (the default): no mark is made, no identity autograd node is added
  (the ops' `grad_fn` graph is the untraced one), outputs and gradients
  are bit-equal to a traced call's, and the removed counters are gone;
* `tracing(on)` as a call and as a context manager;
* a tiny DCNResNet-50 `train_step` traced: one "mdc.train.*" triple a
  step, one "mdc.dcn.fwd" per DCN layer under the forward and one
  "mdc.dcn.bwd" per layer under the backward, nested, their self times
  adding up to their root's duration;
* a forward without gradients marks the forward alone;
* a captured step's ring (`StepRecord`), its mark kernel emulated on a CPU
  tensor: R + 3 replays wrap it, and the last R replays read back;
* `annotate` records host spans.

The card's side is tests/test_torch_port_tracing_cuda.py.  This file
imports no JAX.
"""
import collections
import inspect

import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer, train_step)
from modulated_deform_conv_tpu_torch.parallel import sharding
from modulated_deform_conv_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def off_after():
    """Every test leaves the spans off and the eager record empty."""
    profiling._EAGER.__init__()
    yield
    profiling.tracing(False)
    profiling._EAGER.__init__()


def _case(requires_grad=True):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 8, 6, 6)),
            rng.uniform(-2, 2, (2, 18, 6, 6)),
            rng.uniform(0, 1, (2, 9, 6, 6)),
            rng.standard_normal((4, 8, 3, 3)) * 0.1,
            rng.standard_normal((4,))]
    return [torch.tensor(a, dtype=torch.float32,
                         requires_grad=requires_grad) for a in arrs]


def _graph_names(t):
    """The names of every node of t's autograd graph."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def _step(ins):
    out = mdt.modulated_deform_conv2d(*ins, 1, 1)
    (out * out).sum().backward()
    return out, [t.grad for t in ins]


def test_off_marks_nothing_and_adds_no_node(monkeypatch):
    assert not profiling.enabled()

    def refuse(*a, **k):
        raise AssertionError("a mark with the spans off")
    monkeypatch.setattr(profiling._EagerRecord, "_mark", refuse)
    ins = _case()
    out, grads = _step(ins)
    names = _graph_names(out)
    assert not any(n.startswith("_Bwd") for n in names), names
    monkeypatch.undo()

    ins_on = _case()
    with profiling.tracing(True):
        out_on, grads_on = _step(ins_on)
    names_on = _graph_names(out_on)
    assert names_on[0] == "_BwdBeginBackward"
    assert "_BwdEndBackward" in names_on
    assert sorted(n for n in names_on if not n.startswith("_Bwd")) == \
        sorted(names)
    assert torch.equal(out, out_on)
    for g, g_on in zip(grads, grads_on):
        assert torch.equal(g, g_on)
    # The CPU marks read the host clock: no library is loaded.
    assert not profiling._MARK


def test_removed_counters_are_gone():
    for name in ("op_stats", "halo_stats", "Counters", "counters"):
        assert not hasattr(profiling, name)
    assert not hasattr(sharding, "_count")
    assert "nvtx" not in inspect.getsource(profiling)


def test_switch_as_call_and_context():
    assert not profiling.enabled()
    profiling.tracing(True)
    assert profiling.enabled()
    with profiling.tracing(False):
        assert not profiling.enabled()
        with profiling.tracing(True):
            assert profiling.enabled()
        assert not profiling.enabled()
    assert profiling.enabled()
    profiling.tracing(False)
    assert not profiling.enabled()
    assert profiling.span("x", "cpu") is profiling.span("y", "cpu")


def _units(spans):
    units = collections.defaultdict(list)
    for s in spans:
        units[s["replay"]].append(s)
    return [units[u] for u in sorted(units)]


def _nested(unit):
    """Every span inside its parent, and self times that add up to the
    root's duration."""
    by_index = {s["index"]: s for s in unit}
    root, = [s for s in unit if s["parent"] is None]
    for s in unit:
        assert s["start_ns"] <= s["end_ns"]
        assert s["self_ns"] >= 0
        if s["parent"] is not None:
            p = by_index[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]
    assert sum(s["self_ns"] for s in unit) == \
        root["end_ns"] - root["start_ns"]
    return root


def test_train_step_spans_nest():
    torch.manual_seed(0)
    net = mdt.DCNResNet(num_classes=10, width=4, device="cpu")
    opt = make_optimizer(net)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 3, 32, 32)),
                     dtype=torch.float32)
    y = torch.tensor([1, 7])
    steps, layers = 2, 13
    with profiling.tracing(True):
        for _ in range(steps):
            train_step(net, opt, x, y)
    units = _units(profiling.spans())
    # Eager, each of the three is a root of its own: one triple a step.
    assert [_nested(u)["name"] for u in units] == [
        "mdc.train.forward", "mdc.train.backward",
        "mdc.train.optimizer"] * steps
    for fwd, bwd, upd in zip(units[0::3], units[1::3], units[2::3]):
        f = [s for s in fwd if s["name"] == "mdc.dcn.fwd"]
        b = [s for s in bwd if s["name"] == "mdc.dcn.bwd"]
        assert len(f) == len(b) == layers
        assert len(fwd) == len(bwd) == layers + 1 and len(upd) == 1
        assert all(s["parent"] == 0 for s in f + b)
        assert [s["attrs"]["call"] for s in f] == list(range(layers))
        # The backward runs the layers last first, each with its forward's
        # attributes.
        assert [s["attrs"]["call"] for s in b] == list(range(layers))[::-1]
        fa = {s["attrs"]["call"]: s["attrs"] for s in f}
        for s in b:
            assert s["attrs"] == fa[s["attrs"]["call"]]
            assert s["attrs"]["op"] == "modulated_deform_conv2d"
        for a, z in zip(f, f[1:]):
            assert a["end_ns"] <= z["start_ns"]


def test_forward_without_gradients_marks_the_forward_alone():
    ins = _case(requires_grad=False)
    with profiling.tracing(True):
        with torch.no_grad():
            out = mdt.modulated_deform_conv2d(*_case(), 1, 1)
        out2 = mdt.modulated_deform_conv2d(*ins, 1, 1)
    assert out.grad_fn is None and out2.grad_fn is None
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["mdc.dcn.fwd"] * 2
    assert [s["attrs"]["x_shape"] for s in spans] == [(2, 8, 6, 6)] * 2


def test_input_without_gradient_keeps_none():
    ins = _case()
    ins[0] = ins[0].detach()       # x needs no gradient
    with profiling.tracing(True):
        out, grads = _step(ins)
    assert grads[0] is None and all(g is not None for g in grads[1:])
    assert [s["name"] for s in profiling.spans()] == ["mdc.dcn.fwd",
                                                      "mdc.dcn.bwd"]


def test_step_ring_wraps(monkeypatch):
    """A captured step's ring, the mark kernel emulated on a CPU tensor:
    the capture's marks are replayed R + 3 times."""
    launched = []

    def emulate(device, ring, ctr, slot, rows, width, advance):
        launched.append((slot, rows, width, advance))
    monkeypatch.setattr(profiling, "_launch_mark", emulate)
    rows = 4
    rec = profiling.StepRecord("cpu", width=8, rows=rows)
    with profiling.recording(rec), profiling.tracing(True):
        root = rec.begin("mdc.step", "cpu", {})
        with profiling.span("a", "cpu"):
            with profiling.span("b", "cpu", k=1):
                pass
        sp = profiling.begin("c", "cpu")
        profiling.end(sp, "cpu")
        rec.end(root, torch.device("cpu"), last=True)
    assert [s for s, *_ in launched] == list(range(8))
    assert [a for *_, a in launched] == [False] * 7 + [True]

    buf, t = rec.buf, 1000
    for _ in range(rows + 3):          # the graph's replays
        for slot, r, w, advance in launched:
            c = int(buf[-1])
            buf[(c % r) * w + slot] = t
            t += 10 * (slot + 1)
            if advance:
                buf[-1] = c + 1
    spans = rec.read()
    units = _units(spans)
    assert sorted({s["replay"] for s in spans}) == list(range(3, rows + 3))
    starts = []
    for u in units:
        root = _nested(u)
        assert [s["name"] for s in u] == ["mdc.step", "a", "b", "c"]
        assert [s["parent"] for s in u] == [None, 0, 1, 0]
        assert u[2]["attrs"] == {"k": 1}
        starts.append(root["start_ns"])
    assert starts == sorted(starts)
    assert starts[1] - starts[0] == sum(10 * (s + 1) for s in range(8))


def test_step_record_refuses_extra_marks(monkeypatch):
    monkeypatch.setattr(profiling, "_launch_mark", lambda *a: None)
    rec = profiling.StepRecord("cpu", width=2)
    with profiling.recording(rec):
        sp = profiling.begin("a", "cpu")
        profiling.end(sp, "cpu")
        with pytest.raises(RuntimeError, match="more than the 2 marks"):
            profiling.begin("b", "cpu")


def test_annotate_records_host_spans():
    n = len(profiling.host_spans("mdc.test.host"))
    with profiling.annotate("mdc.test.host"):
        torch.ones(8).sum()
    got = profiling.host_spans("mdc.test.host")
    assert len(got) == n + 1
    assert got[-1]["start_ns"] <= got[-1]["end_ns"]


def test_clock_offsets_match_replays_by_correlation():
    """Replays of three marks, 2,000 ns apart, on a trace clock 5,000 ns
    after the device's: the trace missed the first replay and one mark of
    the third; matched from the last replay back."""
    marks = [(r, [2000 * r + 100, 2000 * r + 300, 2000 * r + 900])
             for r in range(6, 11)]
    events = [{"cat": "kernel", "name": "void mdc::trace_mark_kernel(...)",
               "ts": (v + 5000 + j) / 1e3, "args": {"correlation": r}}
              for r, row in marks[1:] for j, v in enumerate(row)
              if (r, j) != (8, 1)]
    events.append({"cat": "kernel", "name": "other", "ts": 1.0, "args": {}})
    got = profiling.clock_offsets(events, marks)
    assert got["replays_matched"] == 3
    assert got["found"] == pytest.approx(11 / 15)
    assert got["offsets_ns"] == pytest.approx([5000, 5001, 5002] * 3)
    assert got["spread_ns"] == pytest.approx(2)
    assert got["within_replay_ns"] == pytest.approx(2)


def test_clock_offsets_fit_a_rate_between_the_clocks():
    """A trace clock that runs 100 ppm fast of the device's, 0.5 ns of
    noise on every other mark: the rate and the spread about it."""
    marks = [(r, [10 ** 6 * r + 1000 * j for j in range(4)])
             for r in range(8)]
    events = [{"cat": "kernel", "name": "void mdc::trace_mark_kernel(...)",
               "ts": (v * (1 + 1e-4) + 700 + 0.5 * (j % 2)) / 1e3,
               "args": {"correlation": r}}
              for r, row in marks for j, v in enumerate(row)]
    got = profiling.clock_offsets(events, marks)
    assert got["replays_matched"] == 8
    assert got["drift_ppm"] == pytest.approx(100, rel=1e-3)
    assert got["spread_about_drift_ns"] < 1
    assert got["spread_ns"] == pytest.approx(700.3 + 0.5, abs=1)
