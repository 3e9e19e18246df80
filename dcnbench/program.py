"""What the benchmark takes from the program under test, the PyTorch / CUDA
port `modulated_deform_conv_tpu_torch`, and nothing more: its models,
its trainer's step and optimizer, its compiled step (`utils/graphs.py`),
its kernel build, and its public op entries, which the traced run fences
with the benchmark's own spans.  The only module of the benchmark that
imports the program.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

import modulated_deform_conv_tpu_torch as port
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer, train_step)
from modulated_deform_conv_tpu_torch.ops import api
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.utils import graphs

from .traces import PREFIX
from .work import dcn_work

OPS = ("deform_conv2d", "modulated_deform_conv2d", "deform_conv3d",
       "modulated_deform_conv3d")


def build_kernels() -> None:
    """Every kernel of the port, one nvcc each, all at once; a no-op where
    the checkout's build/ holds them already."""
    lib.build(lib.KERNELS)


def model(spec: dict, device) -> torch.nn.Module:
    """The configuration's network, on the device, in float32."""
    return getattr(port, spec["class"])(**spec["args"], device=device)


def load(net: torch.nn.Module, params) -> None:
    with torch.no_grad():
        net.load_state_dict(params, strict=True)


def optimizer(net: torch.nn.Module) -> torch.optim.Optimizer:
    return make_optimizer(net)


def reset_optimizer(opt: torch.optim.Optimizer) -> None:
    """A fresh optimizer's state (step 0, zero moments), in place, so a
    captured step keeps its addresses."""
    with torch.no_grad():
        for state in opt.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    v.zero_()


def train_fn(net, opt):
    return functools.partial(train_step, net, opt)


def serve_fn(net):
    def forward(x):
        with torch.no_grad():
            return net(x)
    return forward


def capture(fn, *inputs):
    return graphs.capture(fn, *inputs)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Out(torch.autograd.Function):
    """Identity on the op's output; its backward, the first node of the
    op's backward, marks where that backward begins."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        _sync()
        with record_function(PREFIX + "dcn_bwd_begin"):
            pass
        return g


class _In(torch.autograd.Function):
    """Identity on the op's inputs; its backward, run once every input's
    gradient is out of the op, marks where the op's backward ends."""

    @staticmethod
    def forward(ctx, *ts):
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        _sync()
        with record_function(PREFIX + "dcn_bwd_end"):
            pass
        return gs


def _fenced(fn, modulated: bool, calls: list):
    n_in = 4 if modulated else 3   # x, offset, [mask,] weight

    @functools.wraps(fn)
    def call(*args, **kw):
        ins = list(args[:n_in])
        bias = args[n_in] if len(args) > n_in else kw.get("bias")
        live = [i for i, t in enumerate(ins) if t is not None]
        for i, t in zip(live, _In.apply(*(ins[i] for i in live))):
            ins[i] = t
        _sync()
        with record_function(PREFIX + "dcn_fwd"):
            out = fn(*ins, *args[n_in:], **kw)
            _sync()
        x, offset, weight = ins[0], ins[1], ins[-1]
        mask = ins[2] if modulated else None
        with torch.no_grad():
            calls.append({
                "work": dcn_work(
                    x.shape, offset.shape,
                    None if mask is None else mask.shape, weight.shape,
                    None if bias is None else bias.shape, out.numel(),
                    kw.get("groups", 1), x.element_size()),
                "offset_std": float(offset.float().std()),
                "offset_absmax": float(offset.abs().max()),
                "mask_std": None if mask is None else float(
                    mask.float().std())})
        return _Out.apply(out)
    return call


@contextlib.contextmanager
def fenced_ops(calls: list):
    """While open, every call of the port's public deformable ops runs
    between synchronised spans of the benchmark's (`traces.dcn_share`
    reads them) and appends to `calls` its op-level work and the spread
    of its offsets and mask.  For one eager
    step under the profiler, never inside a capture."""
    saved = {name: getattr(api, name) for name in OPS}
    try:
        for name, fn in saved.items():
            setattr(api, name, _fenced(fn, name.startswith("modulated"),
                                       calls))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(api, name, fn)


class _ScaledGrad(torch.autograd.Function):
    """Identity on a tensor; its backward hands the gradient on times
    `factor`."""

    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


# A wrong backward of the deformable op, as a faulty kernel would give it:
# the factor each of (x, offset, mask, weight)'s gradients is handed on
# with.
BACKWARD_FAULTS = {
    "grad_x_scaled": (0.9, 1.0, 1.0, 1.0),
    "grad_offset_zeroed": (1.0, 0.0, 1.0, 1.0),
    "grad_mask_zeroed": (1.0, 1.0, 0.0, 1.0),
    "grad_weight_zeroed": (1.0, 1.0, 1.0, 0.0),
}


def _broken(fn, modulated: bool, factors):
    n_in = 4 if modulated else 3
    f = factors if modulated else factors[:2] + factors[3:]

    @functools.wraps(fn)
    def call(*args, **kw):
        ins = [t if t is None or k == 1.0 else _ScaledGrad.apply(t, k)
               for t, k in zip(args[:n_in], f)]
        return fn(*ins, *args[n_in:], **kw)
    return call


@contextlib.contextmanager
def broken_backward(fault: str):
    """While open, the public deformable ops' backward hands on the
    gradients of their inputs as BACKWARD_FAULTS[fault] says: a fault
    planted under the timed path, for the control's readings and the
    tests.  Open it before the step is captured."""
    factors = BACKWARD_FAULTS[fault]
    saved = {name: getattr(api, name) for name in OPS}
    try:
        for name, fn in saved.items():
            setattr(api, name, _broken(fn, name.startswith("modulated"),
                                       factors))
        yield
    finally:
        for name, fn in saved.items():
            setattr(api, name, fn)
