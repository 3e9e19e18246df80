"""Bounded-offset kernels: the wrappers `fwd` / `bwd`, each taking the
kernel of its spec's rank, `shiftblend_fwd` / `shiftblend_bwd` in 2D
(csrc/shiftblend_fwd.cu, csrc/shiftblend_bwd.cu) and `shiftblend3d_fwd` /
`shiftblend3d_bwd` in 3D (csrc/shiftblend3d_*.cu).

Counterparts of the JAX package's `ops/pallas/shiftblend.py`
(`deform_conv_shift`, joined by the custom VJP `shift_conv`): in 2D its
unrolled pair `_fwd_kernel_cols` / `_bwd_kernel`, in 3D its loop pair
`_fwd_kernel_loop` / `_bwd_kernel_loop` (and the unrolled pair where a 3D
window has at most 640 (tap, window) pairs, and the lead-chunked mode where
a volume outgrows VMEM: all compute one function, which the 3D kernels
compute in one launch), for stride-1, size-preserving configs under the
bounded-offset contract |offset| <= b.

The contract drops corners per axis: with (lo, W) = `_axis_window(b)`,
corner c of a tap on axis d is kept only if
lo <= floor(pos_d) - anchor_d + c <= lo + W - 1.  Offsets beyond the bound
therefore lose their corners (all of them past b + 1), like taps outside
the image lose theirs, in value and in gradient.  `offsets_within_bound`
checks the contract.

**The lead mode** (the JAX package's `shift_conv(..., lead=(R, S0))`,
which its sharding layer enters through `sharded_lead_reason` and
`deform_conv_shift_sharded`): the op on one shard's halo-extended
leading-dim block, the shard's output rows plus R = halo rows of each
neighbour (zeros past the image), inner dims whole, stride 1.  Here it is
the sharding layer's block mode (`sharding.block_args`): the local spec
with padding 0 on the leading dim, the shard's output grid `out_sizes`, the
tap gate `gate_bounds` at the whole input's border and the block's
placement `block_origin`.  A position is taken in the whole input's
coordinates, so the window stays around the tap's anchor there, and a
kept corner must also lie inside the whole input's image, as the JAX
kernel checks its corners against the global leading extent.  The four
kernels take it (csrc/shiftblend*.cu); `deform_conv_shift_sharded` is its
entry, which the sharding layer calls directly.

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version (`*_reference`, one for both ranks) on CPU tensors only.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ...utils.config import DeformConvSpec, effective_step
from .. import core
from . import lib

# The JAX package's loop-path rule (shiftblend.py:341-343): past this many
# (tap, window) pairs its kernels roll the leading window axis, which needs
# a 3D config with a plane stride that is a multiple of 128 (a TPU lane
# tiling, kept so that both packages take the same path), and its shift set
# stays within 4096 distinct shifts (:347).
_UNROLL_PAIRS = 640
_MAX_SHIFTS = 4096


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
    """Per-axis reach of a tile's corners beyond the centre of its taps'
    rows (csrc/deform_tile.cuh, reach_shift): half the taps' span,
    dilation*(k-1)/2 (the pad of a size-preserving config, whose anchors
    span [-pad, pad]), plus the window's farthest row."""
    return tuple(dl * (k - 1) // 2 + max(-lo, lo + w - 1)
                 for k, dl, (lo, w) in zip(spec.kernel, spec.dilation,
                                           windows))


@functools.lru_cache(maxsize=256)
def _loop_path_reason(spec: DeformConvSpec, S, windows) -> Optional[str]:
    """The JAX package's rules on the window (SBPlan.ineligible_reason):
    more than 640 (tap, window) pairs need the rolled-loop kernel, which
    takes only 3D configs whose plane stride is a multiple of 128 (a 2D
    plan is never loopable), and the distinct flat shifts stay within
    4096.  Cached: counting the shift set takes about 0.5 ms of host time
    at a 3x3x3 kernel and bound 2, and a training step checks it up to
    three times."""
    loopable = spec.ndim == 3 and (S[1] * S[2]) % 128 == 0
    if (spec.tap_count * math.prod(w for _, w in windows) > _UNROLL_PAIRS
            and not loopable):
        return ("window too large to unroll and the plane stride is not "
                "128-aligned for the rolled-loop kernel")
    qstride = tuple(math.prod(S[d + 1:]) for d in range(spec.ndim))
    anchors = itertools.product(*[
        sorted({i * dl - p + lo + dy for i in range(k) for dy in range(w)})
        for k, dl, p, (lo, w) in zip(spec.kernel, spec.dilation,
                                     spec.padding, windows)])
    if len({sum(a * q for a, q in zip(av, qstride))
            for av in anchors}) > _MAX_SHIFTS:
        return "offset_bound window too large (shift set explodes)"
    return None


def ineligible_reason(x: torch.Tensor, spec: DeformConvSpec,
                      offset_bound, out_sizes=None,
                      lead=None) -> Optional[str]:
    """None if the shift-blend kernel takes this config, else a reason.

    The semantic rules of the JAX package's `SBPlan.ineligible_reason`
    (stride 1, output size == input size, C/dg % 8 == 0, C/dg <= 256,
    dg % groups == 0, its loop-path and shift-set rules), so both
    packages pick the same path for the same config.  The kernels fit any
    tap count and window, so they add no rule of their own; JAX's VMEM
    residency and residual budgets are the TPU's and have no counterpart
    here.  An output grid `out_sizes` other than the plan's is not taken,
    as in the JAX package.

    `lead` = (R, S0_global): x is a lead-mode block of the whole op `spec`
    (R halo rows each side of the S[0] - 2R output rows; S0_global, the
    whole input's leading extent, sets no rule).  Every dim of `spec` must
    then be size-preserving, the leading one as the sharding layer's
    alignment contract makes it and the inner ones because the block keeps
    them whole."""
    if offset_bound is None:
        return "no offset_bound provided (shiftblend needs bounded offsets)"
    if spec.ndim not in (2, 3):
        return "shiftblend supports 2D and 3D only"
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return f"unsupported dtype {x.dtype}"
    C, S = x.shape[1], tuple(x.shape[2:])
    if C % spec.deformable_groups:
        return "channels not divisible by deformable_groups"
    OS = spec.out_sizes(S)
    if lead is not None:
        R = int(lead[0])
        if R < 0 or S[0] - 2 * R < 1:
            return (f"lead mode needs R >= 0 halo rows each side of at least "
                    f"one output row (R={R}, leading extent {S[0]})")
        OS = (S[0] - 2 * R,) + S[1:]
    if out_sizes is not None and tuple(out_sizes) != OS:
        return "out_sizes overrides not supported by shiftblend"
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
    return _loop_path_reason(spec, S, windows)


def sharded_lead_reason(x_ext_shape, dtype, spec: DeformConvSpec,
                        offset_bound, halo: int,
                        S0_global: int) -> Optional[str]:
    """None if the lead mode takes a halo-extended spatial shard, else a
    reason: the JAX package's `sharded_lead_reason` (shiftblend.py:1676).
    `x_ext_shape` is the local block's shape (B, C, Hs + 2*halo, *inner)
    and `spec` the whole op's."""
    if offset_bound is None or (not isinstance(offset_bound, (tuple, list))
                                and offset_bound <= 0):
        return "no offset_bound (shiftblend needs bounded offsets)"
    x = torch.empty(tuple(x_ext_shape), dtype=dtype, device="meta")
    return ineligible_reason(x, spec, offset_bound, lead=(halo, S0_global))


def _launch_reason(x, spec: DeformConvSpec, offset_bound, out_sizes=None,
                   block_origin=None) -> Optional[str]:
    """None if the kernels take this launch, else a reason: the unsharded
    rules, or on a block (`out_sizes` or `block_origin` given) the lead
    mode's (`sharded_lead_reason`), with the halo and the whole op read off
    the block as `sharding.block_args` builds it: the leading dim's padding
    0 there, the whole op's the size-preserving dilation*(k-1)/2."""
    if out_sizes is None and block_origin is None:
        return ineligible_reason(x, spec, offset_bound)
    S = tuple(x.shape[2:])
    OS = S if out_sizes is None else tuple(int(o) for o in out_sizes)
    placed = block_origin or [(0.0, 0.0)] * spec.ndim
    if (len(OS) != len(S) or OS[1:] != S[1:] or (S[0] - OS[0]) % 2
            or spec.padding[0] != 0
            or any(tuple(p) != (0.0, 0.0) for p in placed[1:])):
        return ("shiftblend's block mode takes leading-dim blocks only "
                "(sharding.block_args' form: padding 0 and the halo on the "
                "leading dim, inner dims whole)")
    span = spec.dilation[0] * (spec.kernel[0] - 1)
    if span % 2:
        return "shiftblend requires size-preserving padding (OS == S)"
    whole = dataclasses.replace(spec, padding=(span // 2,) + spec.padding[1:])
    return sharded_lead_reason(x.shape, x.dtype, whole, offset_bound,
                               (S[0] - OS[0]) // 2, None)


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
                             offset_bound, out_sizes=None, gate_bounds=None,
                             block_origin=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the reference gather with the
    bounded contract's per-axis corner window (on a lead-mode block: the
    block's output grid, gate and placement), then the grouped contraction
    with fp32 accumulation ("bfloat16" rounds both operands).  bf16 inputs
    are read in fp32 (`lib.widen`) and the result is cast to x's type, as
    the kernel reads and stores them."""
    w = lib.widen
    return core._deform_conv_nd(
        w(x), w(offset), w(mask), w(weight), w(bias), spec,
        out_sizes=out_sizes, precision=precision, gate_bounds=gate_bounds,
        corner_window=corner_windows(spec, offset_bound),
        block_origin=block_origin).to(x.dtype)


def _geometry(x, weight, spec: DeformConvSpec, offset_bound, out_sizes):
    """The kernels' leading int arguments: B, C, *S, O, *OS, groups, dg,
    *kernel, *padding, *dilation, (lo, win) per axis, and in 2D the halo
    reach per axis (the 3D kernels find each tap's reach themselves)."""
    windows = corner_windows(spec, offset_bound)
    return (*x.shape, weight.shape[0], *lib.out_grid(x, spec, out_sizes),
            spec.groups, spec.deformable_groups,
            *spec.kernel, *spec.padding, *spec.dilation,
            *(v for w in windows for v in w),
            *(_halo(spec, windows) if spec.ndim == 2 else ()))


# The 2D forward takes its halo route on planes of at least this many
# positions (32 of its 8 x 8 tiles a sample); see halo_route.
_HALO_MIN_POSITIONS = 2048


def halo_route(S) -> bool:
    """Whether the 2D forward stages the halo of its 8 x 8 output tiles
    (else it reads the corners from channels-last x, as gathermm_fwd does,
    with the bounded window): only on output grids of at least 2048
    positions.
    Timed side by side on an H100 at B=8, bound 2 (chip_smoke.py, its route
    phase), the halo route ran 10-24% faster at 56 x 56 and 48 x 48; from
    32 x 32 down to 14 x 14 the two routes came within 16% of each other,
    the xt route ahead in most runs."""
    return math.prod(S) >= _HALO_MIN_POSITIONS


def fwd(x, offset, mask, weight, bias, spec: DeformConvSpec, precision: str,
        offset_bound, out_sizes=None, gate_bounds=None, block_origin=None,
        halo=None) -> torch.Tensor:
    """Bounded-offset DCN forward, (B, O, *OS) of x's type: OS = S, or on a
    lead-mode block (`out_sizes`, `gate_bounds`, `block_origin` as
    `sharding.block_args` gives them) its output grid; the kernel
    `shiftblend_fwd` (2D) or `shiftblend3d_fwd` (3D, the whole volume or
    block in one launch).  `halo` (2D only) forces the 2D kernel's route,
    None for halo_route's choice.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: x, offset and mask float32 or bfloat16 (one type,
    which the result has), weight and bias float32 or bfloat16,
    contiguous, on one device."""
    floats = lib.block_floats(spec, x.shape[2:], gate_bounds, block_origin)
    if x.device.type == "cpu":
        return shiftblend_fwd_reference(x, offset, mask, weight, bias, spec,
                                        precision, offset_bound, out_sizes,
                                        gate_bounds, block_origin)
    name = "shiftblend_fwd" if spec.ndim == 2 else "shiftblend3d_fwd"
    lib.check_inputs(name, x, offset, mask, weight, bias, spec, out_sizes)
    reason = _launch_reason(x, spec, offset_bound, out_sizes, block_origin)
    if reason is not None:
        raise NotImplementedError(f"{name}: {reason}")
    OS = lib.out_grid(x, spec, out_sizes)
    out = torch.empty((x.shape[0], weight.shape[0]) + OS, dtype=x.dtype,
                      device=x.device)
    route = ()
    if spec.ndim == 2:
        route = (int(halo_route(OS) if halo is None else halo),)
    xt, part, splits = lib.fwd_buffers(x, weight, spec, out)
    lib.launch(name, x, (x, offset, mask, lib.fwd_weight(weight, spec.groups),
                         lib.as_f32(bias), out, xt, part),
               (*_geometry(x, weight, spec, offset_bound, out_sizes), *route,
                splits, lib.PRECISION_CODES[precision],
                lib.IO_CODES[x.dtype]), floats)
    return out


def shiftblend_bwd_reference(x, offset, mask, weight, grad_out,
                             spec: DeformConvSpec, precision: str,
                             offset_bound, out_sizes=None, gate_bounds=None,
                             block_origin=None):
    """Plain PyTorch version of the backward kernel: autograd through
    `shiftblend_fwd_reference` without bias, on the inputs read in fp32,
    so dropped corners carry no gradient.  Returns (grad_x, grad_offset,
    grad_mask or None, grad_weight), each in its input's type."""
    w = lib.widen
    grads = core.conv_vjp(w(x), w(offset), w(mask), w(weight), w(grad_out),
                          spec, precision,
                          corner_window=corner_windows(spec, offset_bound),
                          out_sizes=out_sizes, gate_bounds=gate_bounds,
                          block_origin=block_origin)
    return lib.cast_grads(grads, (x, offset, mask, weight))


def bwd(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
        precision: str, offset_bound, needs=(True,) * 4, out_sizes=None,
        gate_bounds=None, block_origin=None):
    """Bounded-offset DCN backward without the bias, the kernel
    `shiftblend_bwd` (2D) or `shiftblend3d_bwd` (3D): (grad_x,
    grad_offset, grad_mask, grad_weight), each in its input's type, each
    None where `needs` says it is not wanted (grad_mask also without a
    mask); on a lead-mode block as `fwd`, grad_x over the whole block.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: as `fwd`'s, grad_out of x's type."""
    floats = lib.block_floats(spec, x.shape[2:], gate_bounds, block_origin)
    if x.device.type == "cpu":
        grads = shiftblend_bwd_reference(x, offset, mask, weight, grad_out,
                                         spec, precision, offset_bound,
                                         out_sizes, gate_bounds, block_origin)
        return tuple(g if n else None for g, n in zip(grads, needs))
    name = "shiftblend_bwd" if spec.ndim == 2 else "shiftblend3d_bwd"
    lib.check_inputs(name, x, offset, mask, weight, None, spec, out_sizes)
    reason = _launch_reason(x, spec, offset_bound, out_sizes, block_origin)
    if reason is not None:
        raise NotImplementedError(f"{name}: {reason}")
    OS = lib.out_grid(x, spec, out_sizes)
    B, P = x.shape[0], math.prod(OS)
    lib.check_grad_out(name, grad_out, x, (B, weight.shape[0]) + OS)
    # The 3D kernel runs gcols and the gradients read from it in batch
    # chunks of gcd(B, in_step): a memory knob that does not change the
    # result, since each of those gradients belongs to one sample.
    b_step = effective_step(B, spec.in_step) if spec.ndim == 3 else None
    gx, goff, gmask, gwt, gcols, xt, part, splits = lib.bwd_buffers(
        x, offset, mask, weight, spec, P, needs, b_step)
    wk = lib.tap_major_weight(weight, spec.groups)
    lib.launch(name, x, (
        x, offset, mask, wk, grad_out, gcols, xt, part, gx, goff, gmask,
        gwt), (
        *_geometry(x, weight, spec, offset_bound, out_sizes),
        *(() if b_step is None else (b_step,)), splits,
        lib.PRECISION_CODES[precision], lib.IO_CODES[x.dtype]), floats)
    gw = (None if gwt is None else
          lib.ungrouped_weight(gwt, weight.shape).to(weight.dtype))
    return gx, goff, gmask, gw


class _ShiftblendFwd(torch.autograd.Function):
    """The bounded-offset op without any dtype cast: the forward and
    backward kernels of the config's rank, on a lead-mode block where
    `out_sizes`, `gate_bounds` and `block_origin` are given, on the tensors
    `lib.kernel_inputs` gives.  x, offset, mask and weight are saved as the
    caller passed them; the columns are recomputed in the backward, never
    saved."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, spec, precision,
                offset_bound, out_sizes=None, gate_bounds=None,
                block_origin=None):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.spec, ctx.precision, ctx.offset_bound = (spec, precision,
                                                     offset_bound)
        ctx.block = (out_sizes, gate_bounds, block_origin)
        return fwd(x, offset, mask, weight, bias, spec, precision,
                   offset_bound, *ctx.block)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad
        gx, goff, gmask, gw = bwd(
            x, offset, mask, weight, grad_out.contiguous(), ctx.spec,
            ctx.precision, ctx.offset_bound, needs[:4], *ctx.block)
        gb = lib.bias_grad(grad_out, ctx.bias_dtype) if needs[4] else None
        return gx, goff, gmask, gw, gb, None, None, None, None, None, None


def deform_conv_shift(x, offset, mask, weight, bias, spec: DeformConvSpec,
                      precision: str = "tensorfloat32",
                      offset_bound=2.0) -> torch.Tensor:
    """Full shift-blend deformable conv with bias (dispatch entry).

    The kernels take x, offset and mask in their own type where all three
    are float32 or all bfloat16 (`lib.io_dtype`), and weight and bias each
    float32 or bfloat16, as the JAX kernels do; float16 and mixed
    activation types are upcast to float32 first, as the JAX kernel
    upcasts float16.  The result has x's dtype, and each gradient its
    input's."""
    reason = ineligible_reason(x, spec, offset_bound)
    if reason is not None:
        raise NotImplementedError(f"shiftblend: {reason}")
    out = _ShiftblendFwd.apply(*lib.kernel_inputs(x, offset, mask, weight,
                                                  bias),
                               spec, precision, offset_bound)
    return out.to(x.dtype)


def deform_conv_shift_sharded(x_ext, offset, mask, weight, bias,
                              spec: DeformConvSpec, precision: str,
                              offset_bound, out_sizes, gate_bounds,
                              block_origin) -> torch.Tensor:
    """The lead mode on one shard's halo-extended leading-dim block, with
    bias: the JAX package's `deform_conv_shift_sharded` (shiftblend.py:
    1702).  `spec`, `out_sizes`, `gate_bounds` and `block_origin` are the
    block's, as `sharding.block_args` builds them (the JAX entry takes the
    halo, the global extent and the shard's origin and builds the same
    plan).  Dtypes as `deform_conv_shift`; grad_x covers the whole block.

    The caller decides that the lead mode takes the block, as the sharding
    layer does once per shard (`sharded_lead_reason`); on CUDA tensors the
    kernels' wrappers raise where it does not."""
    out = _ShiftblendFwd.apply(*lib.kernel_inputs(x_ext, offset, mask, weight,
                                                  bias),
                               spec, precision, offset_bound, tuple(out_sizes),
                               gate_bounds, block_origin)
    return out.to(x_ext.dtype)
