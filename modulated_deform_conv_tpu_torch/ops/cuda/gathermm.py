"""General-offset kernels: `gathermm_fwd` (csrc/gathermm_fwd.cu) and
`gathermm_bwd` (csrc/gathermm_bwd.cu).

Counterparts of the JAX package's `ops/pallas/gathermm.py` fused pair
(`deform_conv_fused`, kernels `_fwd_fused_kernel` and `_bwd_fused_kernel`,
joined by the custom VJP `fused_conv`).  The row semantics of its `_prep`
(floor and fraction per dim, the open-interval gate folded with the mask
into the corner weights) are the corner rules the CUDA kernels apply
(csrc/deform_tile.cuh::tap_weights, and tap_grad for their derivative).

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version (`*_reference`) on CPU tensors only.  `_GathermmFwd` joins the two
as one differentiable op.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ...utils.config import DeformConvSpec
from .. import core
from . import lib

# The corner table holds K * 64 entries of 20 bytes in shared memory next to
# the 66 KB column and weight tiles (csrc/gathermm_fwd.cu).
_MAX_TAPS = 128
# Output positions per tile of the kernels (csrc/deform_tile.cuh kTP): the
# backward keeps one corner range per tile.
_TILE_P = 64


def ineligible_reason(x: torch.Tensor, spec: DeformConvSpec) -> Optional[str]:
    """None if the general kernel path takes this config, else a reason."""
    if spec.ndim not in (2, 3):
        return "cuda kernels support 2D and 3D only"
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return f"unsupported dtype {x.dtype}"
    if x.shape[1] % spec.deformable_groups:
        return "channels not divisible by deformable_groups"
    if spec.tap_count > _MAX_TAPS:
        return (f"more than {_MAX_TAPS} kernel taps do not fit the "
                "shared-memory corner table")
    return None


def gathermm_fwd_reference(x, offset, mask, weight, bias,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function on the same
    float32 tensors (columns by gather, grouped contraction with fp32
    accumulation; "bfloat16" rounds both operands to bf16)."""
    return core._deform_conv_nd(x, offset, mask, weight, bias, spec,
                                precision=precision)


def gathermm_fwd(x, offset, mask, weight, bias, spec: DeformConvSpec,
                 precision: str = "tensorfloat32") -> torch.Tensor:
    """General-offset DCN forward, (B, O, *OS) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        return gathermm_fwd_reference(x, offset, mask, weight, bias, spec,
                                      precision)
    lib.check_inputs("gathermm_fwd", x, offset, mask, weight, bias, spec)
    reason = ineligible_reason(x, spec)
    if reason is not None:
        raise NotImplementedError(f"gathermm_fwd: {reason}")
    B, C, H, W = x.shape
    O = weight.shape[0]
    OH, OW = spec.out_sizes((H, W))
    out = torch.empty((B, O, OH, OW), dtype=torch.float32, device=x.device)
    wt = lib.grouped_weight(weight, spec.groups)
    lib.launch("gathermm_fwd", x, (x, offset, mask, wt, bias, out), (
        B, C, H, W, O, OH, OW, spec.groups, spec.deformable_groups,
        *spec.kernel, *spec.stride, *spec.padding, *spec.dilation,
        lib.PRECISION_CODES[precision]))
    gathermm_fwd.launches += 1
    return out


gathermm_fwd.launches = 0


def gathermm_bwd_reference(x, offset, mask, weight, grad_out,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32"):
    """Plain PyTorch version of the backward kernel: autograd through
    `gathermm_fwd_reference` without bias.  Returns (grad_x, grad_offset,
    grad_mask or None, grad_weight)."""
    return core.conv_vjp(x, offset, mask, weight, grad_out, spec, precision)


def gathermm_bwd(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
                 precision: str = "tensorfloat32", needs=(True,) * 4):
    """General-offset DCN backward without the bias: (grad_x, grad_offset,
    grad_mask, grad_weight), float32, each None where `needs` says it is
    not wanted (grad_mask also without a mask).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        grads = gathermm_bwd_reference(x, offset, mask, weight, grad_out,
                                       spec, precision)
        return tuple(g if n else None for g, n in zip(grads, needs))
    lib.check_inputs("gathermm_bwd", x, offset, mask, weight, None, spec)
    reason = ineligible_reason(x, spec)
    if reason is not None:
        raise NotImplementedError(f"gathermm_bwd: {reason}")
    B, C, H, W = x.shape
    O = weight.shape[0]
    OH, OW = spec.out_sizes((H, W))
    lib.check_grad_out("gathermm_bwd", grad_out, x, (B, O, OH, OW))
    gx, goff, gmask, gwt, gcols, part, splits = lib.bwd_buffers(
        x, offset, mask, weight, spec, OH * OW, needs)
    ranges = (torch.empty((B, spec.deformable_groups,
                           -(-(OH * OW) // _TILE_P), 2),
                          dtype=torch.int32, device=x.device)
              if gx is not None else None)
    wk = lib.tap_major_weight(weight, spec.groups)
    lib.launch("gathermm_bwd", x, (
        x, offset, mask, wk, grad_out, gcols, ranges, part, gx, goff, gmask,
        gwt), (B, C, H, W, O, OH, OW, spec.groups, spec.deformable_groups,
               *spec.kernel, *spec.stride, *spec.padding, *spec.dilation,
               splits, lib.PRECISION_CODES[precision]))
    gathermm_bwd.launches += 1
    gw = None if gwt is None else lib.ungrouped_weight(gwt, weight.shape)
    return gx, goff, gmask, gw


gathermm_bwd.launches = 0


class _GathermmFwd(torch.autograd.Function):
    """The general-offset op without its dtype casts: forward and backward
    kernels.  x, offset, mask and weight are saved; the columns are
    recomputed in the backward, never saved."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, spec, precision):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.spec, ctx.precision = spec, precision
        return gathermm_fwd(x, offset, mask, weight, bias, spec, precision)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad
        gx, goff, gmask, gw = gathermm_bwd(
            x, offset, mask, weight, grad_out.contiguous(), ctx.spec,
            ctx.precision, needs[:4])
        gb = grad_out.sum((0, 2, 3)) if needs[4] else None
        return gx, goff, gmask, gw, gb, None, None


def deform_conv_fused(x, offset, mask, weight, bias, spec: DeformConvSpec,
                      precision: str = "tensorfloat32") -> torch.Tensor:
    """Full general-offset deformable conv with bias (dispatch entry).

    bf16 and fp16 inputs are upcast to fp32 for the kernels; the result
    has x's dtype, and so do the gradients of each input."""
    f32 = lib.as_f32
    out = _GathermmFwd.apply(f32(x), f32(offset), f32(mask), f32(weight),
                             f32(bias), spec, precision)
    return out.to(x.dtype)
