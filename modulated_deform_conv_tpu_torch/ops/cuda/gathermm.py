"""General-offset kernels: `gathermm_fwd` / `gathermm_bwd` (2D,
csrc/gathermm_fwd.cu, csrc/gathermm_bwd.cu) and `gathermm3d_fwd` /
`gathermm3d_bwd` (3D, csrc/gathermm3d_*.cu).

Counterparts of the JAX package's `ops/pallas/gathermm.py` fused pair
(`deform_conv_fused`, kernels `_fwd_fused_kernel` and `_bwd_fused_kernel`,
joined by the custom VJP `fused_conv`), in its 2D mode and its 3D flat and
planar modes.  The row semantics of its `_prep` (floor and fraction per dim,
the open-interval gate folded with the mask into the corner weights) are
the corner rules the CUDA kernels apply (csrc/deform_tile.cuh::tap_weights
and csrc/deform_tile3d.cuh::weights3_at, and tap_grad / grad3_at for their
derivatives).

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version (`*_reference`, one for both ranks) on CPU tensors only.
`_GathermmFwd` joins the two as one differentiable op.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ...utils.config import DeformConvSpec, effective_step
from .. import core
from . import lib

# The corner table holds K * 64 entries of 20 bytes (2D) or 36 bytes (3D) in
# shared memory next to the 66 KB column and weight tiles
# (csrc/gathermm_fwd.cu, csrc/gathermm3d_fwd.cu): at most 128 and 71 taps.
_MAX_TAPS = {2: 128, 3: 71}
# Output positions per tile of the kernels (csrc/deform_tile.cuh kTP): the
# 2D backward keeps one corner range per tile; the 3D one a box per 4 x 4 x 4
# output brick (6 ints).
_TILE_P = 64
_BRICK, _BOX_INTS = 4, 6


def ineligible_reason(x: torch.Tensor, spec: DeformConvSpec) -> Optional[str]:
    """None if the general kernel path takes this config, else a reason."""
    if spec.ndim not in (2, 3):
        return "cuda kernels support 2D and 3D only"
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return f"unsupported dtype {x.dtype}"
    if x.shape[1] % spec.deformable_groups:
        return "channels not divisible by deformable_groups"
    if spec.tap_count > _MAX_TAPS[spec.ndim]:
        return (f"more than {_MAX_TAPS[spec.ndim]} kernel taps do not fit "
                "the shared-memory corner table")
    return None


def gathermm_fwd_reference(x, offset, mask, weight, bias,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function on the same
    float32 tensors (columns by gather, grouped contraction with fp32
    accumulation; "bfloat16" rounds both operands to bf16)."""
    return core._deform_conv_nd(x, offset, mask, weight, bias, spec,
                                precision=precision)


def _geometry(x, weight, spec: DeformConvSpec):
    """The kernels' leading int arguments: B, C, *S, O, *OS, groups, dg,
    *kernel, *stride, *padding, *dilation."""
    return (*x.shape, weight.shape[0], *spec.out_sizes(x.shape[2:]),
            spec.groups, spec.deformable_groups, *spec.kernel, *spec.stride,
            *spec.padding, *spec.dilation)


def _fwd(name, x, offset, mask, weight, bias, spec, precision):
    lib.check_inputs(name, x, offset, mask, weight, bias, spec)
    reason = ineligible_reason(x, spec)
    if reason is not None:
        raise NotImplementedError(f"{name}: {reason}")
    out = torch.empty((x.shape[0], weight.shape[0])
                      + spec.out_sizes(x.shape[2:]), dtype=torch.float32,
                      device=x.device)
    wt = lib.grouped_weight(weight, spec.groups)
    lib.launch(name, x, (x, offset, mask, wt, bias, out), (
        *_geometry(x, weight, spec), lib.PRECISION_CODES[precision]))
    return out


def gathermm_fwd(x, offset, mask, weight, bias, spec: DeformConvSpec,
                 precision: str = "tensorfloat32") -> torch.Tensor:
    """General-offset 2D DCN forward, (B, O, OH, OW) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        return gathermm_fwd_reference(x, offset, mask, weight, bias, spec,
                                      precision)
    out = _fwd("gathermm_fwd", x, offset, mask, weight, bias, spec,
               precision)
    gathermm_fwd.launches += 1
    return out


gathermm_fwd.launches = 0


def gathermm3d_fwd(x, offset, mask, weight, bias, spec: DeformConvSpec,
                   precision: str = "tensorfloat32") -> torch.Tensor:
    """General-offset 3D DCN forward, (B, O, OD, OH, OW) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        return gathermm3d_fwd_reference(x, offset, mask, weight, bias, spec,
                                        precision)
    out = _fwd("gathermm3d_fwd", x, offset, mask, weight, bias, spec,
               precision)
    gathermm3d_fwd.launches += 1
    return out


gathermm3d_fwd.launches = 0


def gathermm_bwd_reference(x, offset, mask, weight, grad_out,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32"):
    """Plain PyTorch version of the backward kernel: autograd through
    `gathermm_fwd_reference` without bias.  Returns (grad_x, grad_offset,
    grad_mask or None, grad_weight)."""
    return core.conv_vjp(x, offset, mask, weight, grad_out, spec, precision)


# The plain versions take either rank.
gathermm3d_fwd_reference = gathermm_fwd_reference
gathermm3d_bwd_reference = gathermm_bwd_reference


def _bwd(name, x, offset, mask, weight, grad_out, spec, precision, needs):
    lib.check_inputs(name, x, offset, mask, weight, None, spec)
    reason = ineligible_reason(x, spec)
    if reason is not None:
        raise NotImplementedError(f"{name}: {reason}")
    B, dg = x.shape[0], spec.deformable_groups
    OS = spec.out_sizes(x.shape[2:])
    lib.check_grad_out(name, grad_out, x, (B, weight.shape[0]) + OS)
    # The 3D kernel runs gcols and the gradients read from it in batch
    # chunks of gcd(B, in_step): a memory knob that does not change the
    # result, since each of those gradients belongs to one sample.
    b_step = effective_step(B, spec.in_step) if spec.ndim == 3 else None
    gx, goff, gmask, gwt, gcols, part, splits = lib.bwd_buffers(
        x, offset, mask, weight, spec, math.prod(OS), needs, b_step)
    if gx is None:
        tiles = None
    elif b_step is None:       # one flat corner range per 64-position tile
        tiles = torch.empty((B, dg, -(-math.prod(OS) // _TILE_P), 2),
                            dtype=torch.int32, device=x.device)
    else:                      # one box per output brick
        tiles = torch.empty((b_step, dg, math.prod(-(-o // _BRICK)
                                                   for o in OS), _BOX_INTS),
                            dtype=torch.int32, device=x.device)
    wk = lib.tap_major_weight(weight, spec.groups)
    lib.launch(name, x, (
        x, offset, mask, wk, grad_out, gcols, tiles, part, gx, goff, gmask,
        gwt), (*_geometry(x, weight, spec),
               *(() if b_step is None else (b_step,)), splits,
               lib.PRECISION_CODES[precision]))
    gw = None if gwt is None else lib.ungrouped_weight(gwt, weight.shape)
    return gx, goff, gmask, gw


def gathermm_bwd(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
                 precision: str = "tensorfloat32", needs=(True,) * 4):
    """General-offset 2D DCN backward without the bias: (grad_x,
    grad_offset, grad_mask, grad_weight), float32, each None where `needs`
    says it is not wanted (grad_mask also without a mask).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        grads = gathermm_bwd_reference(x, offset, mask, weight, grad_out,
                                       spec, precision)
        return tuple(g if n else None for g, n in zip(grads, needs))
    grads = _bwd("gathermm_bwd", x, offset, mask, weight, grad_out, spec,
                 precision, needs)
    gathermm_bwd.launches += 1
    return grads


gathermm_bwd.launches = 0


def gathermm3d_bwd(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
                   precision: str = "tensorfloat32", needs=(True,) * 4):
    """General-offset 3D DCN backward without the bias, as `gathermm_bwd`.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        grads = gathermm3d_bwd_reference(x, offset, mask, weight, grad_out,
                                         spec, precision)
        return tuple(g if n else None for g, n in zip(grads, needs))
    grads = _bwd("gathermm3d_bwd", x, offset, mask, weight, grad_out, spec,
                 precision, needs)
    gathermm3d_bwd.launches += 1
    return grads


gathermm3d_bwd.launches = 0


class _GathermmFwd(torch.autograd.Function):
    """The general-offset op without its dtype casts: the forward and
    backward kernels of the config's rank.  x, offset, mask and weight are
    saved; the columns are recomputed in the backward, never saved."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, spec, precision):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.spec, ctx.precision = spec, precision
        fwd = gathermm_fwd if spec.ndim == 2 else gathermm3d_fwd
        return fwd(x, offset, mask, weight, bias, spec, precision)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad
        bwd = gathermm_bwd if ctx.spec.ndim == 2 else gathermm3d_bwd
        gx, goff, gmask, gw = bwd(
            x, offset, mask, weight, grad_out.contiguous(), ctx.spec,
            ctx.precision, needs[:4])
        gb = (grad_out.sum((0,) + tuple(range(2, grad_out.ndim)))
              if needs[4] else None)
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
