"""Bounded-offset kernels: `shiftblend_fwd` (csrc/shiftblend_fwd.cu) and
`shiftblend_bwd` (csrc/shiftblend_bwd.cu).

Counterparts of the JAX package's `ops/pallas/shiftblend.py` unrolled pair
(`deform_conv_shift`, kernels `_fwd_kernel_cols` and `_bwd_kernel`, joined
by the custom VJP `shift_conv`), for stride-1, size-preserving configs
under the bounded-offset contract |offset| <= b.

The contract drops corners per axis: with (lo, W) = `_axis_window(b)`,
corner c of a tap on axis d is kept only if
lo <= floor(pos_d) - anchor_d + c <= lo + W - 1.  Offsets beyond the bound
therefore lose their corners (all of them past b + 1), like taps outside
the image lose theirs, in value and in gradient.  `offsets_within_bound`
checks the contract.

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version (`*_reference`) on CPU tensors only.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ...utils.config import DeformConvSpec
from .. import core
from . import lib

# Shared-memory layout of csrc/shiftblend_fwd.cu, in floats: column and
# weight tiles of rows_cap rows, the corner table, and an 8-channel
# halo-extended 8 x 8 x tile.
_TILE, _CHUNK, _ROWS, _TP, _WSTRIDE = 8, 8, 128, 64, 68
_MAX_SMEM_FLOATS = 227 * 1024 // 4


def _axis_window(b: float) -> Tuple[int, int]:
    """(lo, W): corner-row window along one axis for |off| <= b.

    floor(pos) - anchor ranges over [-ceil(b), floor(b)]; the high corner
    adds one row.  When b is an integer the top row (b + 1) carries value
    weight exactly 0 (floor(off) == b only at off == b, where the fraction
    is 0), so it is dropped: W = 2b + 1."""
    lo = -math.ceil(b)
    W = math.ceil(b) + math.floor(b) + 2
    if b == math.floor(b):
        W -= 1
    return lo, W


def _bounds(offset_bound, nd: int) -> Tuple[float, ...]:
    bounds = (tuple(offset_bound) if isinstance(offset_bound, (tuple, list))
              else (offset_bound,) * nd)
    if len(bounds) != nd or any(float(b) < 0 for b in bounds):
        raise ValueError(f"offset_bound must be >= 0, one value or one per "
                         f"spatial dim, got {offset_bound!r}")
    return tuple(float(b) for b in bounds)


def corner_windows(spec: DeformConvSpec, offset_bound):
    """Per-axis (lo, W) of the bounded-offset contract."""
    return tuple(_axis_window(b) for b in _bounds(offset_bound, spec.ndim))


def _halo(spec: DeformConvSpec, windows) -> Tuple[int, ...]:
    """Per-axis reach of a tile's corners beyond the tile: pad plus the
    window's farthest row (the tap anchors span [-pad, pad] when 2*pad ==
    dilation*(k-1))."""
    return tuple(p + max(-lo, lo + w - 1)
                 for p, (lo, w) in zip(spec.padding, windows))


def _smem_floats(spec: DeformConvSpec, halo) -> int:
    K = spec.tap_count
    rows = min(_CHUNK * K, _ROWS)
    return (rows * (_TP + _WSTRIDE) + K * _TP * 5
            + _CHUNK * math.prod(_TILE + 2 * r for r in halo))


def ineligible_reason(x: torch.Tensor, spec: DeformConvSpec,
                      offset_bound) -> Optional[str]:
    """None if the shift-blend kernel takes this config, else a reason.

    The semantic rules of the JAX package's `SBPlan.ineligible_reason`
    (stride 1, output size == input size, C/dg % 8 == 0, C/dg <= 256,
    dg % groups == 0), so both packages pick the same path for the same
    config, plus this kernel's own shared-memory limit on the halo tile."""
    if offset_bound is None:
        return "no offset_bound provided (shiftblend needs bounded offsets)"
    if spec.ndim not in (2, 3):
        return "shiftblend supports 2D and 3D only"
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return f"unsupported dtype {x.dtype}"
    C, S = x.shape[1], tuple(x.shape[2:])
    if C % spec.deformable_groups:
        return "channels not divisible by deformable_groups"
    if any(s != 1 for s in spec.stride):
        return "shiftblend requires stride=1"
    if spec.out_sizes(S) != S:
        return "shiftblend requires size-preserving padding (OS == S)"
    Cg = C // spec.deformable_groups
    if Cg % 8:
        return "channels per deformable group must be a multiple of 8"
    if Cg > 256:
        return ("channel slab too wide for the register sweep "
                "(C/deformable_groups > 256; use the gathermm path)")
    if spec.deformable_groups % spec.groups:
        return "deformable_groups must be a multiple of groups"
    windows = corner_windows(spec, offset_bound)
    if _smem_floats(spec, _halo(spec, windows)) > _MAX_SMEM_FLOATS:
        return ("offset_bound window too large for the shared-memory halo "
                "tile")
    return None


def offsets_within_bound(offset: torch.Tensor, offset_bound) -> torch.Tensor:
    """0-dim bool tensor: do all offsets satisfy |off| <= offset_bound?

    The kernel drops the corners of offsets beyond the bound; this is the
    check.  Reading the result on the host synchronises with the device."""
    bounds = (offset_bound if isinstance(offset_bound, (tuple, list))
              else (offset_bound,))
    if len(bounds) == 1:
        return offset.abs().max() <= bounds[0]
    nd = len(bounds)
    # offset channel layout: dg * (K * nd) with dim d at channel nd*f + d
    ch = offset.shape[1]
    lim = torch.as_tensor(bounds, dtype=offset.dtype,
                          device=offset.device)[
        torch.arange(ch, device=offset.device) % nd]
    lim = lim.reshape((1, ch) + (1,) * (offset.ndim - 2))
    return (offset.abs() <= lim).all()


def shiftblend_fwd_reference(x, offset, mask, weight, bias,
                             spec: DeformConvSpec, precision: str,
                             offset_bound) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the reference gather with the
    bounded contract's per-axis corner window, then the grouped
    contraction with fp32 accumulation ("bfloat16" rounds both operands)."""
    return core._deform_conv_nd(
        x, offset, mask, weight, bias, spec, precision=precision,
        corner_window=corner_windows(spec, offset_bound))


def shiftblend_fwd(x, offset, mask, weight, bias, spec: DeformConvSpec,
                   precision: str, offset_bound) -> torch.Tensor:
    """Bounded-offset DCN forward, (B, O, H, W) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        return shiftblend_fwd_reference(x, offset, mask, weight, bias, spec,
                                        precision, offset_bound)
    lib.check_inputs("shiftblend_fwd", x, offset, mask, weight, bias, spec)
    reason = ineligible_reason(x, spec, offset_bound)
    if reason is not None:
        raise NotImplementedError(f"shiftblend_fwd: {reason}")
    (lo_y, win_y), (lo_x, win_x) = windows = corner_windows(spec,
                                                            offset_bound)
    ry, rx = _halo(spec, windows)
    B, C, H, W = x.shape
    O = weight.shape[0]
    out = torch.empty((B, O, H, W), dtype=torch.float32, device=x.device)
    wt = lib.grouped_weight(weight, spec.groups)
    lib.launch("shiftblend_fwd", x, (x, offset, mask, wt, bias, out), (
        B, C, H, W, O, spec.groups, spec.deformable_groups, *spec.kernel,
        *spec.padding, *spec.dilation, lo_y, win_y, lo_x, win_x, ry, rx,
        lib.PRECISION_CODES[precision]))
    shiftblend_fwd.launches += 1
    return out


shiftblend_fwd.launches = 0


def shiftblend_bwd_reference(x, offset, mask, weight, grad_out,
                             spec: DeformConvSpec, precision: str,
                             offset_bound):
    """Plain PyTorch version of the backward kernel: autograd through
    `shiftblend_fwd_reference` without bias, so dropped corners carry no
    gradient.  Returns (grad_x, grad_offset, grad_mask or None,
    grad_weight)."""
    return core.conv_vjp(x, offset, mask, weight, grad_out, spec, precision,
                         corner_window=corner_windows(spec, offset_bound))


def shiftblend_bwd(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
                   precision: str, offset_bound, needs=(True,) * 4):
    """Bounded-offset DCN backward without the bias: (grad_x, grad_offset,
    grad_mask, grad_weight), float32, each None where `needs` says it is
    not wanted (grad_mask also without a mask).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        grads = shiftblend_bwd_reference(x, offset, mask, weight, grad_out,
                                         spec, precision, offset_bound)
        return tuple(g if n else None for g, n in zip(grads, needs))
    lib.check_inputs("shiftblend_bwd", x, offset, mask, weight, None, spec)
    reason = ineligible_reason(x, spec, offset_bound)
    if reason is not None:
        raise NotImplementedError(f"shiftblend_bwd: {reason}")
    (lo_y, win_y), (lo_x, win_x) = windows = corner_windows(spec,
                                                            offset_bound)
    ry, rx = _halo(spec, windows)
    B, C, H, W = x.shape
    O = weight.shape[0]
    lib.check_grad_out("shiftblend_bwd", grad_out, x, (B, O, H, W))
    gx, goff, gmask, gwt, gcols, part, splits = lib.bwd_buffers(
        x, offset, mask, weight, spec, H * W, needs)
    wk = lib.tap_major_weight(weight, spec.groups)
    lib.launch("shiftblend_bwd", x, (
        x, offset, mask, wk, grad_out, gcols, part, gx, goff, gmask, gwt), (
        B, C, H, W, O, spec.groups, spec.deformable_groups, *spec.kernel,
        *spec.padding, *spec.dilation, lo_y, win_y, lo_x, win_x, ry, rx,
        splits, lib.PRECISION_CODES[precision]))
    shiftblend_bwd.launches += 1
    gw = None if gwt is None else lib.ungrouped_weight(gwt, weight.shape)
    return gx, goff, gmask, gw


shiftblend_bwd.launches = 0


class _ShiftblendFwd(torch.autograd.Function):
    """The bounded-offset op without its dtype casts: forward and backward
    kernels.  x, offset, mask and weight are saved; the columns are
    recomputed in the backward, never saved."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, spec, precision,
                offset_bound):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.spec, ctx.precision, ctx.offset_bound = (spec, precision,
                                                     offset_bound)
        return shiftblend_fwd(x, offset, mask, weight, bias, spec, precision,
                              offset_bound)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad
        gx, goff, gmask, gw = shiftblend_bwd(
            x, offset, mask, weight, grad_out.contiguous(), ctx.spec,
            ctx.precision, ctx.offset_bound, needs[:4])
        gb = grad_out.sum((0, 2, 3)) if needs[4] else None
        return gx, goff, gmask, gw, gb, None, None, None


def deform_conv_shift(x, offset, mask, weight, bias, spec: DeformConvSpec,
                      precision: str = "tensorfloat32",
                      offset_bound=2.0) -> torch.Tensor:
    """Full shift-blend deformable conv with bias (dispatch entry).

    bf16 and fp16 inputs are upcast to fp32 for the kernels, as the JAX
    kernel does; the result has x's dtype, and so do the gradients of each
    input."""
    reason = ineligible_reason(x, spec, offset_bound)
    if reason is not None:
        raise NotImplementedError(f"shiftblend: {reason}")
    f32 = lib.as_f32
    out = _ShiftblendFwd.apply(f32(x), f32(offset), f32(mask), f32(weight),
                               f32(bias), spec, precision, offset_bound)
    return out.to(x.dtype)
