"""The captured step's CPU-side rules (utils/graphs.py, ops/bounds.py) and
the trainer's arguments around it.

* `debug_check_bounds` inside a capture records its check on the device
  (`bounds.record_bounds`, into the capturing step's `BoundsRecord`)
  instead of reading it on the host; the step's read of its loss gives the
  eager warning.  Held here with the capture faked (`bounds.capturing`
  patched, CPU tensors), against the eager op's own warning;
* `capture` refuses CPU tensors and a machine without a GPU, and never
  runs the step eagerly in its place;
* a captured step refuses an input of another shape, type or device than
  its capture's (`copy_` would broadcast or cast it without a word);
* the trainer refuses `on_step` on a captured run;
* a kernel's launch and its values are counted in one place, the launch
  table of `lib.launch` (the C side stubbed: tests/torch_launch_stub.py),
  and `capture` reads that table alone: graphs.py imports no kernel
  module but `lib`.

The card's side is tests/test_torch_port_cuda_graphs.py.
"""
import ast
import pathlib
import warnings

import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import train
from modulated_deform_conv_tpu_torch.ops import bounds
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.utils import graphs

from torch_launch_stub import stub_c_side


def _case(offscale):
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal((1, 8, 6, 6)),
            rng.uniform(-offscale, offscale, (1, 18, 6, 6)),
            rng.uniform(0, 1, (1, 9, 6, 6)),
            rng.standard_normal((4, 8, 3, 3)) * 0.1,
            rng.standard_normal((4,))]
    return [torch.tensor(a, dtype=torch.float32) for a in arrs]


def _op(ins):
    return mdt.modulated_deform_conv2d(*ins, 1, 1, offset_bound=1.0,
                                       debug_check_bounds=True)


def test_bounds_record_and_read_under_a_faked_capture(monkeypatch):
    ins = _case(3.0)
    with pytest.warns(UserWarning) as eager:
        want = _op(ins)
    monkeypatch.setattr(bounds, "capturing", lambda t: True)
    record = bounds.BoundsRecord()
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # nothing read on the host
        with bounds.recording(record):
            got = _op(ins)
            _op([ins[0], ins[1].clamp(-1, 1)] + ins[2:])
        record.seal()
    assert torch.equal(got, want)
    assert record.bounds == [1.0, 1.0]
    assert record.flags.tolist() == [
        [0.0, float(ins[1].abs().max())], [1.0, 1.0]]
    loss = (got * got).sum()
    with pytest.warns(UserWarning) as captured:
        value = record.read_with(loss)
    assert value == float(loss)
    assert [str(w.message) for w in captured] == [
        str(w.message) for w in eager]


def test_bounds_read_without_checks_or_within_bound():
    loss = torch.tensor(2.5)
    assert bounds.BoundsRecord().read_with(loss) == 2.5
    record = bounds.BoundsRecord()
    record.record(torch.tensor(True), torch.tensor(0.75), 1.0)
    record.seal()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert record.read_with(loss) == 2.5


def test_record_bounds_needs_a_capture():
    with pytest.raises(RuntimeError, match="utils.graphs.capture"):
        bounds.record_bounds(torch.tensor(True), torch.tensor(0.0), 1.0)


def test_capture_refuses_cpu_tensors():
    ran = []

    def step(t):
        ran.append(1)
        return t * 2

    # Without a GPU the device is refused first; with one, the CPU tensor.
    err = RuntimeError if not torch.cuda.is_available() else ValueError
    with pytest.raises(err):
        graphs.capture(step, torch.ones(3))
    assert not ran


class _Graph:
    """Stands in for a torch.cuda.CUDAGraph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_step_refuses_inputs_unlike_its_capture():
    static = [torch.zeros(8, 3), torch.zeros(4, dtype=torch.bfloat16)]
    graph = _Graph()
    step = graphs.CapturedStep(graph, static, static[0], {},
                               bounds.BoundsRecord(), 0.0)
    fine = [torch.ones(8, 3), torch.full((4,), 2.0, dtype=torch.bfloat16)]
    assert step(*fine) is static[0] and graph.replays == 1
    assert torch.equal(static[0], fine[0]) and torch.equal(static[1], fine[1])
    wrong = [
        [torch.ones(1, 3), fine[1]],                  # broadcasts
        [torch.ones(3), fine[1]],                     # broadcasts
        [fine[0], torch.ones(4)],                     # fp32 into bf16
        [fine[0].double(), fine[1]],                  # fp64 into fp32
        [torch.ones(8, 3, device="meta"), fine[1]],   # another device
        [fine[0], 2.0],                               # not a tensor
        [fine[0]],                                    # too few
    ]
    for args in wrong:
        with pytest.raises(ValueError):
            step(*args)
    # Nothing copied, nothing replayed.
    assert graph.replays == 1
    assert torch.equal(static[0], fine[0]) and torch.equal(static[1], fine[1])


def test_trainer_refuses_on_step_when_captured():
    with pytest.raises(ValueError, match="eager=True"):
        train(steps=1, device="cuda", on_step=lambda step, model: None)


def test_launches_and_values_are_counted_in_lib_alone(monkeypatch):
    calls = stub_c_side(monkeypatch)
    x = torch.zeros(4)
    before = lib.counts()
    lib.launch("gathermm_cols_fwd", x, (x,), (1,), values=12)
    lib.launch("groupnorm", x, (x, None), (2, 3), (1e-5,),
               entry="groupnorm_bwd")
    after = lib.counts()
    assert calls == ["gathermm_cols_fwd", "groupnorm_bwd"]
    assert after.launches - before.launches == {"gathermm_cols_fwd": 1,
                                                "groupnorm_bwd": 1}
    assert after.values - before.values == {"gathermm_cols_fwd": 12}
    # A launch the card refuses raises and counts nothing.
    stub_c_side(monkeypatch, err=700)
    with pytest.raises(RuntimeError, match="adamw: .* 700"):
        lib.launch("adamw", x, (x,), (), values=4)
    assert lib.counts() == after
    # The compiled step reads the table, and knows no kernel module.
    tree = ast.parse(pathlib.Path(graphs.__file__).read_text())
    kernel_imports = [
        (node.module, alias.name) for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom) and "cuda" in (node.module or "")
        for alias in node.names]
    assert kernel_imports == [("ops.cuda", "lib")]
