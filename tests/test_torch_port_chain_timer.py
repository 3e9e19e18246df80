"""The chain timer (utils/graphs.py::time_chain, the counterpart of the JAX
package's calibrate `_chain` / `_amortized` and autotune
`_time_differenced`) on the CPU, with no card.

* Its arithmetic with a stand-in capture, graph and CUDA events: the two
  chains captured at n_lo and n_hi calls, one untimed replay each, then
  lo, hi, lo, hi ... between events; each pair's sample is
  (t_hi - t_lo) / (n_hi - n_lo), so a per-replay cost common to the pair
  cancels; `summary`'s median and trimmed spread over the samples.
* `chain` calls the step n times and returns the last call's outputs.
* It raises on CPU tensors and without a card, before calling the step,
  and on chain lengths it cannot difference.
* calibrate's pair steps and autotune's variants reach it as their
  default timer (monkeypatched: no card), None leaves closed over; a
  variant whose capture fails is recorded as a failure, never timed
  eagerly.
* `calibrate.write_profile` records the timing mode and the chain
  lengths.

The card's side is tests/test_torch_port_cuda_graphs.py.
"""
import json
import statistics

import pytest
import torch

from modulated_deform_conv_tpu_torch import calibrate
from modulated_deform_conv_tpu_torch.ops import bounds
from modulated_deform_conv_tpu_torch.utils import autotune, graphs

CARD = "NVIDIA H100 80GB HBM3"


class _Clock:
    """The device's clock: replays advance it, events read it."""

    def __init__(self):
        self.now = 0.0
        self.log = []


class _Event:
    """Stands in for torch.cuda.Event on the stand-in clock."""
    clock = None

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = self.clock.now
        self.clock.log.append("event")

    def synchronize(self):
        self.clock.log.append("sync")

    def elapsed_time(self, end):
        return end.t - self.t


class _ChainGraph:
    """A captured chain of n steps: replay j (j >= 1 timed) takes the
    pair's fixed cost plus n times the pair's step time."""

    def __init__(self, clock, name, n, fixed, step):
        self.clock, self.name, self.n = clock, name, n
        self.fixed, self.step, self.replays = fixed, step, 0

    def replay(self):
        j = self.replays - 1               # -1: the untimed first replay
        self.replays += 1
        self.clock.log.append(self.name)
        if j >= 0:
            self.clock.now += self.fixed[j] + self.n * self.step[j]


def test_time_chain_differences_interleaved_replays(monkeypatch):
    clock = _Clock()
    fixed = [5.0, 0.5, 9.0, 0.1, 3.0, 7.0, 2.0]        # cancels in a pair
    step = [1.30, 1.31, 1.29, 1.50, 1.30, 1.32, 1.10]
    calls, captured = [], []

    def fake_capture(fn, *inputs):
        before = len(calls)
        out = fn(*inputs)                  # what the capture records
        n = len(calls) - before
        assert out == ("out", n)           # the last call's outputs
        name = "lo" if not captured else "hi"
        captured.append((name, n, inputs))
        g = _ChainGraph(clock, name, n, fixed, step)
        return graphs.CapturedStep(g, list(inputs), out,
                                   {"k_fwd": n, "k_bwd": n},
                                   bounds.BoundsRecord(), 0.0)

    def fn(*ins):
        calls.append(ins)
        return ("out", len(calls) - sum(n for _, n, _ in captured))

    monkeypatch.setattr(graphs, "capture", fake_capture)
    monkeypatch.setattr(_Event, "clock", clock)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    x = torch.ones(2)
    res = graphs.time_chain(fn, x, n_lo=2, n_hi=5, samples=7)

    assert [(n, c, i[0] is x) for n, c, i in captured] == [
        ("lo", 2, True), ("hi", 5, True)]
    assert clock.log[:2] == ["lo", "hi"]                 # untimed
    assert clock.log[2:] == ["event", "lo", "event",
                             "event", "hi", "event"] * 7 + ["sync"]
    assert res["samples"] == pytest.approx(step)
    assert res["ms"] == pytest.approx(statistics.median(step))
    trimmed = sorted(step)[1:-1]
    assert res["spread"] == pytest.approx(
        (max(trimmed) - min(trimmed)) / statistics.median(step))
    assert (res["n_lo"], res["n_hi"]) == (2, 5)
    assert res["kernels"] == {"lo": {"k_fwd": 2, "k_bwd": 2},
                              "hi": {"k_fwd": 5, "k_bwd": 5}}


def test_summary_median_and_trimmed_spread():
    s = graphs.summary([4.0, 1.0, 100.0, 3.0, 2.0])
    assert s["ms"] == 3.0 and s["spread"] == pytest.approx(2.0 / 3.0)
    assert s["samples"] == [4.0, 1.0, 100.0, 3.0, 2.0]
    # Three samples or fewer keep their extremes.
    assert graphs.summary([1.0, 2.0, 4.0])["spread"] == pytest.approx(1.5)
    assert graphs.summary([2.0])["spread"] == 0.0


def test_chain_calls_n_times_and_returns_the_last():
    seen = []

    def fn(a, b):
        seen.append((a, b))
        return torch.full((1,), float(len(seen)))

    run = graphs.chain(fn, 3)
    assert float(run(1, 2)) == 3.0 and seen == [(1, 2)] * 3
    assert run.__name__ == "fn x3"


def test_time_chain_refuses_cpu_and_a_missing_card(monkeypatch):
    ran = []

    def step(t):
        ran.append(1)
        return t * 2

    # Without a GPU the device is refused first; with one, the CPU tensor.
    err = RuntimeError if not torch.cuda.is_available() else ValueError
    with pytest.raises(err):
        graphs.time_chain(step, torch.ones(3))
    for kw in (dict(n_lo=0), dict(n_lo=4, n_hi=4), dict(samples=0)):
        with pytest.raises(ValueError, match="n_lo < n_hi"):
            graphs.time_chain(step, torch.ones(3), **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        graphs.time_chain(lambda: torch.ones(1))
    assert not ran


def _fake_chain(record, times=None):
    def time_chain(fn, *inputs, **kw):
        record.append((fn, inputs, kw, autotune.current()))
        t = (times or {}).get(len(record) - 1, 1.0)
        if isinstance(t, Exception):
            raise t
        return {"ms": t, "spread": 0.01, "samples": [t], "n_lo": 1,
                "n_hi": 4, "kernels": {"lo": {}, "hi": {}}}
    return time_chain


def test_calibrate_pair_times_each_step_as_chains(monkeypatch):
    rec = []
    monkeypatch.setattr(graphs, "time_chain", _fake_chain(rec))
    g = torch.Generator().manual_seed(0)
    x, off, w = (torch.randn(s, generator=g).requires_grad_(True)
                 for s in ((2, 3), (2, 3), (3,)))

    def fa(x, off, mask, w, b):
        assert mask is None and b is None
        return (x + off) * w

    def fb(x, off, mask, w, b):
        return x * off + w

    res = calibrate._pair("a", fa, "b", fb, [x, off, None, w, None])
    assert set(res) == {"a", "b"} and res["a"]["ms"] == 1.0
    assert len(rec) == 2
    for (step, inputs, kw, _), f in zip(rec, (fa, fb)):
        assert kw == {}                    # the chain timer's defaults
        assert len(inputs) == 3 and all(
            i is t for i, t in zip(inputs, (x, off, w)))
        grads = step(*inputs)
        out = f(x, off, None, w, None)
        want = torch.autograd.grad((out * out).sum(), (x, off, w))
        for got, ref in zip(grads, want):
            assert torch.equal(got, ref)


def test_autotune_default_times_fresh_chains(monkeypatch, tmp_path):
    monkeypatch.setenv("MDC_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    autotune.reset()
    rec = []
    variants = ({}, {"COLF_BLOCKS": 528}, {"COLF_ROUTE": "gather"})
    monkeypatch.setattr(graphs, "time_chain", _fake_chain(
        rec, {0: 2.0, 1: RuntimeError("CUDA graph capture failed"), 2: 1.5}))

    def fn():
        return None
    try:
        best = autotune.autotune(fn, "k", variants=variants, reps=3,
                                 device=CARD)
        assert best == {"COLF_ROUTE": "gather"}
        # One fresh chain per variant, under that variant's knobs.
        assert [(f is fn, i, kw) for f, i, kw, _ in rec] == [
            (True, (), {"samples": 3})] * 3
        assert [knobs for *_, knobs in rec] == [
            {"COLF_ROUTE": None, "COLF_BLOCKS": 0},
            {"COLF_ROUTE": None, "COLF_BLOCKS": 528},
            {"COLF_ROUTE": "gather", "COLF_BLOCKS": 0}]
        # A capture that fails is a failed variant, not an eager timing.
        rec.clear()
        monkeypatch.setattr(graphs, "time_chain", _fake_chain(
            rec, {0: RuntimeError("capture failed: host read")}))
        with pytest.raises(RuntimeError, match="capture failed: host read"):
            autotune.autotune(fn, "other", variants=({},), device=CARD)
        assert len(rec) == 1
        assert json.loads((tmp_path / "t.json").read_text()) == {
            f"{CARD}::k": best}
    finally:
        autotune.reset()


def test_write_profile_records_the_timing(tmp_path):
    res = {"kind": CARD, "profile": calibrate.derive(CARD, {}),
           "measured": {}, "timings": {}, "quick": True,
           "timing": dict(calibrate.TIMING)}
    path = str(tmp_path / "p.json")
    calibrate.write_profile(path, res)
    timing = json.loads(open(path).read())[CARD]["timing"]
    assert timing == {"mode": "chain", "n_lo": graphs.N_LO,
                      "n_hi": graphs.N_HI, "samples": graphs.SAMPLES}
    assert 1 <= timing["n_lo"] < timing["n_hi"]
