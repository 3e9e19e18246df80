"""Public functional API: the four deformable-convolution ops.

Signatures follow the JAX package's ops/api.py: positional (input, offset,
[mask,] weight, bias), then stride / padding / dilation / groups /
deformable_groups / in_step, then the keywords `impl`, `precision`,
`offset_bound` and `debug_check_bounds`.  Layout is NCHW / NCDHW.  Every
op runs on the device of its input tensors.  `impl` selects the path:

* "torch"      - plain PyTorch (ops/core.py), 2D and 3D, CPU and card,
                 differentiable through autograd;
* "cuda"       - the hand-written kernels (ops/cuda/), raising where none
                 takes the config; CPU tensors run the kernels' plain
                 versions;
* "shiftblend" - the bounded-offset kernel only;
* "auto"       - a kernel on CUDA tensors wherever one takes the config,
                 else "torch".

`offset_bound` declares |offset| <= bound and enables the shift-blend
kernel, which drops the corners of offsets beyond it.

Dtype policy: fp32 and bf16 run natively.  The kernels read x, offset and
mask (and grad_out) in their own type where all three are fp32 or all bf16,
convert each value to fp32 as they load it, keep every sum in fp32 and
round to that type only where they store out and the gradients of x,
offset and mask; weight and bias are each fp32 or bf16 on their own, and
each gradient has its input's type (ops/cuda/lib.py::io_dtype).  On the
kernel paths fp16, and activations of mixed types, are upcast to fp32 first
and the result cast back; fp64 raises NotImplementedError on "cuda" /
"shiftblend" and takes "torch" under "auto".  Sampling coordinates always
accumulate in >= fp32.

Every path is differentiable in x, offset, mask, weight and bias.  On the
kernel paths the backward is a kernel too (shift-blend's or the general
gather's), summed in a fixed order: two backward runs give the same bits,
which the plain path's `torch.gather` backward (an atomic scatter on CUDA)
does not promise.

With the program's spans on (`utils/profiling.py::tracing`), each call of
a public op is the span "mdc.dcn.fwd" and, where it is differentiated, its
backward the span "mdc.dcn.bwd": from an identity autograd node on the
output to one on the inputs that need a gradient.  Both carry the op's
name, x's shape and the call's ordinal in its step.  With them off a call
tests the switch and adds no node.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import profiling
from ..utils.config import DeformConvSpec
from . import bounds, core
from .cuda import PRECISIONS, maybe_cuda

_IMPLS = ("auto", "torch", "cuda", "shiftblend")


def _dispatch(x, offset, mask, weight, bias, spec: DeformConvSpec, impl: str,
              precision: str = "tensorfloat32", out_sizes=None,
              offset_bound=None, gate_bounds=None,
              debug_check_bounds: bool = False, block_origin=None,
              stacklevel: int = 3):
    """The op on every path.  `out_sizes` (an output grid given rather than
    derived from x), `gate_bounds` (a per-dim (lo, hi) tap gate in place of
    (-1, S_d), in x's coordinates) and `block_origin` (a per-dim (shift,
    origin): x is a block of a larger input, whose row 0 is the input's row
    `origin`; a sample's position is taken and gated in the input's
    coordinates, (base + shift) + offset) are the sharding layer's block
    mode, taken by the plain path and the gather kernels; with `out_sizes`
    the shapes are not validated here, as in the JAX package.
    `stacklevel`: the bounds warning's, from `bounds.check`."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if debug_check_bounds and offset_bound is not None:
        # Opt-in guard for the bounded-offset contract.  Eager, reading the
        # check synchronises with the device; inside a captured step
        # (utils/graphs.py) the check stays on the device and the step
        # warns when its loss is read, as JAX's jax.debug.print under jit.
        bounds.check(offset, offset_bound, stacklevel=stacklevel)
    if out_sizes is None:
        spec.validate(x.shape, offset.shape, weight.shape,
                      None if mask is None else mask.shape,
                      None if bias is None else bias.shape)
    if impl != "torch":
        out = maybe_cuda(x, offset, mask, weight, bias, spec,
                         require=impl in ("cuda", "shiftblend"),
                         precision=precision, offset_bound=offset_bound,
                         impl=impl, gate_bounds=gate_bounds,
                         out_sizes=out_sizes, block_origin=block_origin)
        if out is not None:
            return out
    return core.deform_conv_nd(x, offset, mask, weight, bias, spec,
                               out_sizes=out_sizes, precision=precision,
                               gate_bounds=gate_bounds,
                               block_origin=block_origin)


class _BwdBegin(torch.autograd.Function):
    """Identity on the op's output; its backward, the first node of the
    op's backward, opens the span "mdc.dcn.bwd"."""

    @staticmethod
    def forward(ctx, out, cell, attrs):
        ctx.cell, ctx.attrs = cell, attrs
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        ctx.cell["span"] = profiling.begin("mdc.dcn.bwd", ctx.cell["at"],
                                           **ctx.attrs)
        return g, None, None


class _BwdEnd(torch.autograd.Function):
    """Identity on the op's inputs that need a gradient; its backward, run
    once each of their gradients is out of the op, closes the span."""

    @staticmethod
    def forward(ctx, cell, *ts):
        ctx.cell = cell
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        sp = ctx.cell.pop("span", None)
        if sp is not None:
            profiling.end(sp, ctx.cell["at"])
        return (None,) + gs


def _public(op: str, x, offset, mask, weight, bias, spec: DeformConvSpec,
            impl: str, precision: str, offset_bound, debug_check_bounds):
    """A public op's call: `_dispatch`, in its spans where they are on."""
    # The bounds warning points at the public op's caller.
    kw = dict(offset_bound=offset_bound,
              debug_check_bounds=debug_check_bounds, stacklevel=4)
    if not profiling.enabled():
        return _dispatch(x, offset, mask, weight, bias, spec, impl, precision,
                         **kw)
    ins = [x, offset, mask, weight, bias]
    grad = ([i for i, t in enumerate(ins) if t is not None and t.requires_grad]
            if torch.is_grad_enabled() else [])
    cell = {"at": x.device}
    if grad:
        for i, t in zip(grad, _BwdEnd.apply(cell, *(ins[i] for i in grad))):
            ins[i] = t
    sp = profiling.begin("mdc.dcn.fwd", x, op=op, x_shape=tuple(x.shape))
    sp.attrs["call"] = sp.ordinal
    out = _dispatch(*ins, spec, impl, precision, **kw)
    profiling.end(sp, out)
    return _BwdBegin.apply(out, cell, sp.attrs) if grad else out


def deform_conv2d(input: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride=1, padding=0, dilation=1, groups: int = 1,
                  deformable_groups: int = 1, in_step: int = 64, *,
                  impl: str = "auto", precision: str = "tensorfloat32",
                  offset_bound=None,
                  debug_check_bounds: bool = False) -> torch.Tensor:
    """DCNv1 2D forward.

    input (B, C, H, W); offset (B, dg*2*kh*kw, OH, OW); weight
    (O, C/g, kh, kw); bias (O,) or None.  Returns (B, O, OH, OW)."""
    spec = DeformConvSpec.make(2, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step,
                               modulated=False)
    return _public("deform_conv2d", input, offset, None, weight, bias,
                   spec, impl, precision, offset_bound, debug_check_bounds)


def modulated_deform_conv2d(input: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, stride=1,
                            padding=0, dilation=1, groups: int = 1,
                            deformable_groups: int = 1, in_step: int = 64,
                            *, impl: str = "auto",
                            precision: str = "tensorfloat32",
                            offset_bound=None,
                            debug_check_bounds: bool = False) -> torch.Tensor:
    """DCNv2 2D forward.  mask (B, dg*kh*kw, OH, OW)."""
    spec = DeformConvSpec.make(2, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step,
                               modulated=True)
    return _public("modulated_deform_conv2d", input, offset, mask, weight,
                   bias, spec, impl, precision, offset_bound,
                   debug_check_bounds)


def deform_conv3d(input: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride=1, padding=0, dilation=1, groups: int = 1,
                  deformable_groups: int = 1, in_step: int = 64, *,
                  impl: str = "auto", precision: str = "tensorfloat32",
                  offset_bound=None,
                  debug_check_bounds: bool = False) -> torch.Tensor:
    """3D deformable conv.

    input (B, C, H, W, L); offset (B, dg*3*kh*kw*kl, OH, OW, OL);
    weight (O, C/g, kh, kw, kl)."""
    spec = DeformConvSpec.make(3, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step,
                               modulated=False)
    return _public("deform_conv3d", input, offset, None, weight, bias,
                   spec, impl, precision, offset_bound, debug_check_bounds)


def modulated_deform_conv3d(input: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, stride=1,
                            padding=0, dilation=1, groups: int = 1,
                            deformable_groups: int = 1, in_step: int = 64,
                            *, impl: str = "auto",
                            precision: str = "tensorfloat32",
                            offset_bound=None,
                            debug_check_bounds: bool = False) -> torch.Tensor:
    """Modulated 3D deformable conv.  mask (B, dg*kh*kw*kl, OH, OW, OL)."""
    spec = DeformConvSpec.make(3, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step,
                               modulated=True)
    return _public("modulated_deform_conv3d", input, offset, mask, weight,
                   bias, spec, impl, precision, offset_bound,
                   debug_check_bounds)
