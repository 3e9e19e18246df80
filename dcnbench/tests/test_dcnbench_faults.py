"""`correct` has to come out false: a run driven on the CPU past the
harness's look for a card, with the timed path broken underneath (a step
that leaves its state unchanged; half of each batch left out, the mean
taken over the rest; a wrong backward of the deformable op; a served
answer altered where it is produced), and the control, the reference in
bfloat16 put in the program's place.  No cell spans chips, so there is
no exchange between chips to leave out."""
import time

import pytest
import torch
import torch.nn.functional as F

from dcnbench import control, harness, program

SEED = 2 ** 35 + 3


def _run(root, cell):
    c = harness.load_cell(cell, root)
    return harness.run(c, SEED, 0.3, False, time.perf_counter(),
                       device="cpu")["result"]


def test_a_sound_run_is_correct(tiny_root, eager):
    for cell in ("tiny-r50-train", "tiny-r50-serve"):
        assert _run(tiny_root, cell)["correct"] is True


@pytest.mark.parametrize("what", ["parameters", "all"])
def test_a_step_that_leaves_its_state_unchanged(tiny_root, eager,
                                                monkeypatch, what):
    """The parameters put back after the update (the optimizer's moments
    move), or nothing done at all: the change reads 1, or no gradient
    reaches the optimizer."""
    train_fn = program.train_fn

    def frozen(net, opt):
        if what == "all":
            def step(x, y):
                with torch.no_grad():
                    return F.cross_entropy(net(x), y)
            return step
        update = train_fn(net, opt)

        def step(x, y):
            before = [p.detach().clone() for p in net.parameters()]
            loss = update(x, y)
            with torch.no_grad():
                for p, b in zip(net.parameters(), before):
                    p.copy_(b)
            return loss
        return step
    monkeypatch.setattr(program, "train_fn", frozen)
    res = _run(tiny_root, "tiny-r50-train")
    assert res["correct"] is False
    assert res["checks"]["delta_gap"]["value"] >= 1.0


def test_half_of_each_batch_left_out(tiny_root, eager, monkeypatch):
    train_fn = program.train_fn

    def half(net, opt):
        step = train_fn(net, opt)
        return lambda x, y: step(x[:len(x) // 2], y[:len(y) // 2])
    monkeypatch.setattr(program, "train_fn", half)
    res = _run(tiny_root, "tiny-r50-train")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", sorted(program.BACKWARD_FAULTS))
def test_a_wrong_backward_of_the_deformable_op(tiny_root, eager, fault):
    """The op's backward hands on one input's gradient scaled by 0.9 or
    zeroed, under the captured step, as a faulty kernel would."""
    with program.broken_backward(fault):
        res = _run(tiny_root, "tiny-r50-train")
    assert res["correct"] is False, res["checks"]


def test_a_served_answer_altered_where_it_is_produced(tiny_root, eager,
                                                      monkeypatch):
    serve_fn = program.serve_fn

    def altered(net):
        forward = serve_fn(net)

        def step(x):
            out = forward(x)
            out[:, 3] += 0.05 * out.abs().max()
            return out
        return step
    monkeypatch.setattr(program, "serve_fn", altered)
    res = _run(tiny_root, "tiny-r50-serve")
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["tiny-r50-train", "tiny-r50-serve"])
def test_the_control_and_the_faults_come_out_not_correct(tiny_root, eager,
                                                       cell):
    """control.py's readings: the reference in bfloat16 and, in training,
    half of each batch and each wrong backward, each held to the cell's
    limits by the verdict the runs use."""
    c = harness.load_cell(cell, tiny_root)
    modes = ["control"] + (["half_batch", *program.BACKWARD_FAULTS]
                           if c.mix["kind"] == "train" else [])
    got = control.readings(c, SEED, harness.Device("cpu"), modes)
    assert [m for m, _ in got] == modes
    for mode, numbers in got:
        assert harness.compare.verdict(numbers, c.limits)[0] is False, mode
