"""The trainer's one-pass AdamW (ops/cuda/adamw.py) on the CPU, where the
wrapper runs its plain version.

* the plain version against torch.optim.AdamW's single-tensor path over
  five steps, on leaves of 1 value, odd lengths and DCNResNet-50's c3
  stage, in float32, bfloat16 and float64, with and without weight decay:
  the parameters, both moments and the step count;
* the state: the keys, types, shapes and devices torch's AdamW makes;
* a state zeroed in place (as the benchmark resets it) steps as a fresh
  optimizer's first step, bit for bit;
* `state_dict` round trips to and from torch.optim.AdamW, the steps after a
  load continuing from the loaded state;
* the options the kernel does not take raise, on construction, after a
  load, and at a step (a sparse gradient);
* the kernel path's checks, on meta tensors: the types, layouts and step
  counts the kernel does not take raise before any launch;
* the trainer's optimizer is this one, and the kernel path counts its
  launches and values in the launch table (`lib.counts`, which the
  compiled step reads), the C side stubbed (tests/torch_launch_stub.py).

The card's side is tests/test_torch_port_adamw_cuda.py.  This file
imports no JAX.
"""
import copy

import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer)
from modulated_deform_conv_tpu_torch.ops.cuda import adamw
from modulated_deform_conv_tpu_torch.ops.cuda import lib

from torch_launch_stub import stub_c_side

STEPS, LR = 5, 1e-3
# The most an update moves a value in the first steps: lr |m^| / sqrt(v^)
# stays below 2 lr there.
UPDATE = 2 * LR
ODD_SHAPES = [(1,), (7,), (13, 5)]


def c3_shapes():
    """The leaves of DCNResNet-50's c3 stage at its published width."""
    net = mdt.DCNResNet(num_classes=1000, width=64, device="meta")
    return [tuple(p.shape) for n, p in net.named_parameters()
            if n.startswith("c3.")]


# One rounding a value a step here, several in torch's single-tensor path
# (each op rounds to the leaf's type), and the bias corrections as
# -expm1(t log beta) here, 1 - beta^t there: at most a few units in the
# last place of the value and of the update a step.
TOL = {torch.float32: 2.0 ** -21, torch.bfloat16: 2.0 ** -7,
       torch.float64: 2.0 ** -45}


def _close(got, want, dtype, scale):
    """|got - want| <= STEPS * TOL (|want| + scale), elementwise."""
    got, want = got.double(), want.double()
    bound = STEPS * TOL[dtype] * (want.abs() + scale)
    worst = float(((got - want).abs() - bound).max())
    assert worst <= 0, f"off by {worst:.3e} past the bound"


def _leaves(shapes, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=gen) * 0.1).to(dtype) for s in shapes]


def _grads(shapes, dtype, gen):
    return [torch.randn(s, generator=gen).to(dtype) for s in shapes]


def _step_both(a, b, opt_a, opt_b, shapes, dtype, gen):
    for x, y, g in zip(a, b, _grads(shapes, dtype, gen)):
        x.grad, y.grad = g.clone(), g.clone()
    opt_a.step()
    opt_b.step()


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_plain_matches_torch_adamw(dtype, wd):
    shapes = ODD_SHAPES + c3_shapes()
    start = _leaves(shapes, dtype, 1)
    a = [p.clone().requires_grad_() for p in start]
    b = [p.clone().requires_grad_() for p in start]
    ours = adamw.AdamW(a, lr=LR, weight_decay=wd)
    theirs = torch.optim.AdamW(b, lr=LR, weight_decay=wd, foreach=False)
    gen = torch.Generator().manual_seed(2)
    for _ in range(STEPS):
        _step_both(a, b, ours, theirs, shapes, dtype, gen)
    for x, y in zip(a, b):
        _close(x.detach(), y.detach(), dtype, UPDATE)
        so, st = ours.state[x], theirs.state[y]
        for key in ("exp_avg", "exp_avg_sq"):
            _close(so[key], st[key], dtype, float(st[key].abs().max()))
        assert torch.equal(so["step"], st["step"])
        assert float(so["step"]) == STEPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_as_torch_makes_it(dtype):
    start = _leaves(ODD_SHAPES, dtype, 3)
    a = [p.clone().requires_grad_() for p in start]
    b = [p.clone().requires_grad_() for p in start]
    ours = adamw.AdamW(a, lr=LR, weight_decay=1e-4)
    theirs = torch.optim.AdamW(b, lr=LR, weight_decay=1e-4, foreach=False)
    _step_both(a, b, ours, theirs, ODD_SHAPES, dtype,
               torch.Generator().manual_seed(4))
    for x, y in zip(a, b):
        so, st = ours.state[x], theirs.state[y]
        assert so.keys() == st.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for key in so:
            assert torch.is_tensor(so[key])
            assert (so[key].dtype, so[key].shape, so[key].device) == \
                (st[key].dtype, st[key].shape, st[key].device), key
        assert so["exp_avg"].dtype == x.dtype
    assert ours.param_groups[0].keys() == theirs.param_groups[0].keys()
    net = mdt.DCNResNet(num_classes=10, width=4, device="cpu")
    opt = make_optimizer(net)
    assert isinstance(opt, adamw.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["capturable"]) == \
        (1e-3, 1e-4, False)


def test_zeroed_state_steps_as_fresh():
    shapes = ODD_SHAPES + c3_shapes()[:6]
    start = _leaves(shapes, torch.float32, 5)
    a = [p.clone().requires_grad_() for p in start]
    opt = adamw.AdamW(a, lr=LR, weight_decay=1e-4)
    gen = torch.Generator().manual_seed(6)
    for _ in range(3):
        for x, g in zip(a, _grads(shapes, torch.float32, gen)):
            x.grad = g
        opt.step()
    # The benchmark's reset (dcnbench/program.py::reset_optimizer): every
    # state tensor zeroed in place, the parameters put back.
    with torch.no_grad():
        for state in opt.state.values():
            for v in state.values():
                v.zero_()
        for x, p in zip(a, start):
            x.copy_(p)
    fresh = [p.clone().requires_grad_() for p in start]
    new = adamw.AdamW(fresh, lr=LR, weight_decay=1e-4)
    for x, y, g in zip(a, fresh, _grads(shapes, torch.float32, gen)):
        x.grad, y.grad = g.clone(), g.clone()
    opt.step()
    new.step()
    for x, y in zip(a, fresh):
        assert torch.equal(x, y)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[x][key], new.state[y][key])


@pytest.mark.parametrize("direction", ["ours_to_torch", "torch_to_ours"])
def test_state_dict_round_trip(direction):
    shapes = ODD_SHAPES + c3_shapes()[:6]
    dtype = torch.float32
    start = _leaves(shapes, dtype, 7)
    make = {"ours": lambda ps: adamw.AdamW(ps, lr=LR, weight_decay=1e-4),
            "torch": lambda ps: torch.optim.AdamW(ps, lr=LR, weight_decay=1e-4,
                                                  foreach=False)}
    src, dst = direction.split("_to_")
    a = [p.clone().requires_grad_() for p in start]
    first = make[src](a)
    gen = torch.Generator().manual_seed(8)
    for _ in range(3):
        for x, g in zip(a, _grads(shapes, dtype, gen)):
            x.grad = g
        first.step()
    # A copy, as a checkpoint holds it: load_state_dict keeps the tensors
    # it is given where their type and device fit.
    saved = copy.deepcopy(first.state_dict())
    b = [p.detach().clone().requires_grad_() for p in a]
    second = make[dst](b)
    second.load_state_dict(saved)
    for x, y in zip(a, b):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(first.state[x][key], second.state[y][key])
    # Both continue from the loaded state: the same steps within rounding.
    for _ in range(2):
        _step_both(a, b, first, second, shapes, dtype, gen)
    for x, y in zip(a, b):
        _close(x.detach(), y.detach(), dtype, UPDATE)
        assert float(second.state[y]["step"]) == 5


@pytest.mark.parametrize("option", ["amsgrad", "maximize", "differentiable",
                                    "tensor_lr"])
def test_options_the_kernel_does_not_take_raise(option):
    ps = [torch.zeros(3, requires_grad=True)]
    kw = ({"lr": torch.tensor(1e-3)} if option == "tensor_lr"
          else {option: True})
    with pytest.raises(ValueError, match="AdamW"):
        adamw.AdamW(ps, **kw)
    # A state saved with the option on raises at the step after its load.
    if option == "tensor_lr":
        return
    saved = torch.optim.AdamW([torch.zeros(3, requires_grad=True)],
                              **kw).state_dict()
    opt = adamw.AdamW(ps)
    opt.load_state_dict(saved)
    ps[0].grad = torch.ones(3)
    with pytest.raises(ValueError, match=option):
        opt.step()


def test_sparse_gradient_raises():
    p = torch.zeros(4, 2, requires_grad=True)
    opt = adamw.AdamW([p])
    p.grad = torch.ones(4, 2).to_sparse()
    with pytest.raises(RuntimeError, match="sparse"):
        opt.step()


def _meta_leaves(dtype=torch.float32, n=10):
    dev = torch.device("meta")
    p = torch.empty(n, dtype=dtype, device=dev)
    return ([p], [torch.empty_like(p)], [torch.empty_like(p)],
            [torch.empty_like(p)],
            [torch.empty((), dtype=torch.float32, device=dev)])


def _bad_leaves(case):
    p, g, m, v, s = _meta_leaves(
        {"float16": torch.float16, "float64": torch.float64}.get(
            case, torch.float32))
    if case == "grad_type":
        g = [g[0].to(torch.bfloat16)]
    elif case == "strided":
        p = [torch.empty(20, device="meta")[::2]]
    elif case == "step_type":
        s = [s[0].double()]
    elif case == "step_device":
        s = [torch.zeros(())]
    return p, g, m, v, s


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("float64", TypeError), ("grad_type", TypeError),
    ("strided", ValueError), ("step_type", TypeError),
    ("step_device", ValueError), ("no_counter", ValueError)])
def test_kernel_path_refuses_before_launch(case, error):
    leaves = _bad_leaves(case)
    done = (None if case == "no_counter"
            else torch.zeros((), dtype=torch.int32, device="meta"))
    before = lib.counts()
    with pytest.raises(error, match="adamw"):
        adamw.adamw(*leaves, lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=1e-4, done=done)
    assert lib.counts() == before


def test_update_is_a_counted_main_path_kernel(monkeypatch):
    # The launch table's keys are C entries: the twelve ports of TPU
    # kernels, and the kernels of the sources that port none.
    assert set(lib.sources()) == set(lib.KERNELS) | {
        "adamw", "groupnorm", "calibrate_fma", "trace_mark"}
    # The plain version counts nothing: a launch is the kernel's.
    p = torch.zeros(5, requires_grad=True)
    p.grad = torch.ones(5)
    before = lib.counts()
    adamw.AdamW([p]).step()
    assert lib.counts() == before
    # The kernel path: one launch a type of leaf, each counting its
    # leaves' values, under the entry "adamw".
    stub_c_side(monkeypatch, returns={"adamw_max_leaves": 64})
    leaves = [a + b + c for a, b, c in zip(
        _meta_leaves(n=5), _meta_leaves(n=3), _meta_leaves(torch.bfloat16, 4))]
    adamw.adamw(*leaves, lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=1e-4,
                done=torch.zeros((), dtype=torch.int32, device="meta"))
    after = lib.counts()
    assert after.launches - before.launches == {"adamw": 2}
    assert after.values - before.values == {"adamw": 12}
