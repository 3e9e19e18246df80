"""General-offset kernels: the fused pair `fused_fwd` / `fused_bwd`
(kernels `gathermm_fwd` / `gathermm_bwd` in 2D, csrc/gathermm_*.cu, and
`gathermm3d_fwd` / `gathermm3d_bwd` in 3D, csrc/gathermm3d_*.cu), and the
column pair `cols_fwd` / `cols_bwd` (kernels `gathermm_cols_*` in 2D,
`gathermm3d_cols_*` in 3D), each wrapper taking the kernel of its spec's
rank.

Counterparts of the JAX package's `ops/pallas/gathermm.py`: its fused pair
(kernels `_fwd_fused_kernel` and `_bwd_fused_kernel`, joined by the custom
VJP `fused_conv`) and its columns path (kernels `_fwd_kernel` and
`_bwd_kernel`, joined by `fused_columns`, with the grouped GEMM outside
them), in its 2D mode and its 3D flat and planar modes.
`deform_conv_fused` takes the columns path where the device profile's
fuse rule is false (plan.py::fuse_ok: the JAX package's `_fuse_ok` under
the reference profile).  The row semantics of its `_prep` (floor and
fraction per dim, the open-interval gate folded with the mask into the
corner weights) are the corner rules the CUDA kernels apply
(csrc/deform_tile.cuh::tap_weights and csrc/deform_tile3d.cuh::weights3_at,
and tap_grad / grad3_at for their derivatives).

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version (`*_reference`, one for both ranks) on CPU tensors only.  Every
wrapper also takes the JAX package's sharded-block mode (`_prep(gates)`,
gathermm.py:374-405): `out_sizes`, an output grid given rather than derived
from x, and `gate_bounds`, a per-dim (lo, hi) tap gate in place of the open
interval (-1, S_d), with -1 <= lo < hi <= S_d (lib.block_floats checks it).
Corners outside the block still count zero.
`_GathermmFwd` joins the fused pair as one differentiable op, and
`_GathermmCols` the column pair; `_ColumnsGemm` is the columns path's
grouped product (cuBLAS), in the precision mode asked for.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ...utils.config import DeformConvSpec, effective_step
from .. import core
from . import lib
from .plan import fuse_ok, jax_fuse_ok  # noqa: F401  (tests)

# The fused backward kernels' corner boxes: the 2D one keeps one box (4
# ints) per 4 x 4 output tile (csrc/deform_bwd.cuh kBoxTile), the 3D one a
# box (6 ints) per 4 x 4 x 4 output brick, followed by a box per tap.
_BOX_TILE = 4
_BRICK, _BOX_INTS = 4, 6

# The columns backward's tables (csrc/deform_cols_bwd.cuh): candidates a
# warp bins (kColCB), channels a pull block takes (kColCc), entries a piece
# (kColCap), the most pixels an input tile holds, the tiles of larger
# planes and volumes, and the largest shared-memory block an H100 grants
# (bytes).
_COL_RUN, _COL_CHANS, _COL_CAP, _COL_TILE_MAX = 256, 32, 128, 256
_COL_TILE_2D, _COL_TILE_3D = (1, 8, 16), (4, 4, 8)
_SMEM_MAX = 232448


class ColsBwdPlan(NamedTuple):
    """How the column backward kernels tile and size their scratch."""
    tile: tuple        # (tz, ty, tx) input pixels of a tile (tz = 1 in 2D)
    tiles: int         # tiles of a plane or volume
    runs: int          # runs of _COL_RUN candidates a (sample, group) bins
    chunks: int        # channel chunks of a deformable group
    pool_per_bd: int   # table entries a (sample, group) may need at most
    entry_ints: int    # int32 words of a table entry
    corners: int       # corners of a tap: the correlation's partials
    rec: int           # u16 words of a piece's pixel lists
    smem: int          # shared memory of a pull block (bytes), with x


def cols_bwd_plan(spec: DeformConvSpec, S, OS, C: int) -> ColsBwdPlan:
    """The column backward's tiling and scratch sizes for input sizes S,
    output sizes OS and C channels: the whole plane (or volume) one tile
    where it has at most 256 pixels, else tiles of 8 x 16 pixels (2D) or 4
    x 4 x 8 voxels (3D), cut to the input.  A candidate goes to at most one
    tile per kept corner, so a (sample, group) needs at most corners x K x
    P entries, rounded up to whole pieces of _COL_CAP, and a piece more per
    tile (each tile starts on a piece); a piece's pixel lists hold a first
    hit per pixel and up to corners hits per entry."""
    S = tuple(S)
    if math.prod(S) <= _COL_TILE_MAX:
        tile = (1,) * (3 - len(S)) + S
    else:
        full = (1,) + S if spec.ndim == 2 else S
        tile = tuple(min(t, s) for t, s in zip(
            _COL_TILE_2D if spec.ndim == 2 else _COL_TILE_3D, full))
    full = (1,) * (3 - len(S)) + S
    tiles = math.prod(-(-s // t) for s, t in zip(full, tile))
    K, P = spec.tap_count, math.prod(OS)
    corners = 2 ** spec.ndim
    entry_ints = 4 + 4 * (corners // 4)
    tq = math.prod(tile)
    rec = -(-(tq + 1) // 8) * 8 + _COL_CAP * corners
    xq = math.prod(min(t + 1, s) for t, s in zip(tile[3 - spec.ndim:], S))
    floats = (xq * _COL_CHANS + 2 * _COL_CAP * _COL_CHANS
              + 3 * _COL_CAP * entry_ints + 3 * rec // 2)
    return ColsBwdPlan(tile, tiles, -(-K * P // _COL_RUN),
                       -(-(C // spec.deformable_groups) // _COL_CHANS),
                       -(-corners * K * P // _COL_CAP) * _COL_CAP
                       + tiles * _COL_CAP, entry_ints, corners, rec,
                       4 * floats)


# The column forward (csrc/deform_cols_fwd.cuh): threads a block (each
# holds one item: a tap at 4 consecutive columns); the plane route's
# largest plane or volume (floats: 200 KB, about a 226 x 226 plane); the
# offset reach a tile's nominal corner box allows for; the most channels a stage holds;
# the shared memory the stages of a block may take, 2D and 3D (four and
# three blocks an SM, as the kernel's launch bounds); the blocks a launch
# aims at (eight an SM).
_COLF_THREADS = 256
_COLF_PLANE_MAX = 51200
_COLF_REACH = 3
_COLF_CHANS = 32
_COLF_SMEM = {2: 48 * 1024, 3: 72 * 1024}
_COLF_BLOCKS = 8 * 132
# Process-wide knobs of the column forward that leave its bits as they are
# (each column value is written once, whatever the route or split), set by
# utils/autotune.py: the route where the shapes admit it (None: the plan's
# choice) and the block target (0: _COLF_BLOCKS).
_COLF_ROUTE_OVERRIDE: Optional[str] = None
_COLF_BLOCKS_OVERRIDE = 0


class ColsFwdPlan(NamedTuple):
    """How the column forward kernels split their work."""
    route: str   # "plane" (staged corner boxes) or "gather" (corners from x)
    gt: int      # column groups (4 consecutive columns b * P + p) a tile
    tiles: int   # tiles of the B * P columns
    nbm: int     # samples a tile's columns may belong to
    splits: int  # channel splits of a deformable group
    cps: int     # channels a split
    cc: int      # channels a stage of shared memory
    slot: int    # floats a staged channel holds: the corner box, at most
    smem: int    # dynamic shared memory of a block (bytes)

    def ints(self):
        """The C entries' plan arguments: plane, gt, ..., smem."""
        return (int(self.route == "plane"),) + tuple(self)[1:]


def _nominal_box(spec: DeformConvSpec, S, OS, n: int) -> int:
    """Floats of the staged corner box of a tile of n consecutive output
    positions whose offsets stay below _COLF_REACH: the input rows (2D),
    or planes x rows (3D), that its taps' corners reach, at full width,
    each plane's run with up to 8 more floats for 16-byte copies.  In 3D a
    tile that divides a plane, or that whole planes divide, holds whole
    rows of whole planes (its start is then a multiple of its size)."""
    def reach(n_out, a):
        return min(S[a], (n_out - 1) * spec.stride[a]
                   + (spec.kernel[a] - 1) * spec.dilation[a] + 1
                   + 2 * _COLF_REACH)
    rows_of = lambda m: min(OS[-2], -(-m // OS[-1]) + 1)  # noqa: E731
    if spec.ndim == 2:
        return reach(rows_of(n), 0) * S[1] + 8
    plane = OS[1] * OS[2]
    whole = math.prod(OS) % 4 == 0 and (plane % n == 0 or n % plane == 0)
    planes = min(OS[0], -(-n // plane) + (0 if whole else 1))
    rows = OS[1] if planes > 1 else rows_of(n)
    return reach(planes, 0) * (reach(rows, 1) * S[2] + 8)


def cols_fwd_plan(spec: DeformConvSpec, S, OS, B: int, C: int,
                  route: Optional[str] = None) -> ColsFwdPlan:
    """The column forward's route and work split for input sizes S, output
    sizes OS, B samples and C channels.  The plane route where one (sample,
    channel) plane or volume has at most _COLF_PLANE_MAX values and K <=
    256 (a tile holds every tap; the grid and its int column indices need
    dg < 2^16 and B * P + 4 < 2^31), else the gather route; `route` forces
    one where the shapes admit it.  A plane-route tile holds gt column
    groups of the B * P columns over all K taps, K * gt <= 256 items (in
    3D, where one divides a plane, whole output rows), of up to nbm
    samples; a (channel, sample) slot holds the tile's nominal corner box
    (_nominal_box; the whole plane where a tile spans samples), the whole
    plane, or a 32nd of the rank's _COLF_SMEM over nbm, whichever is
    smallest; a stage holds up to 32 channels in half of it; the group's
    channels split over enough blocks for _COLF_BLOCKS, whole stages
    each.  The autotune knobs `_COLF_ROUTE_OVERRIDE` and
    `_COLF_BLOCKS_OVERRIDE` replace the default route (where the shapes
    admit it) and the block target."""
    S, OS = tuple(S), tuple(OS)
    K, P, dg = spec.tap_count, math.prod(OS), spec.deformable_groups
    plane_ok = (math.prod(S) <= _COLF_PLANE_MAX and K <= _COLF_THREADS
                and B * P + 4 < 2 ** 31 and dg < 2 ** 16)
    if route is None and _COLF_ROUTE_OVERRIDE in ("plane", "gather"):
        route = ("gather" if _COLF_ROUTE_OVERRIDE == "gather" or not plane_ok
                 else "plane")
    if route is None:
        route = "plane" if plane_ok else "gather"
    if route not in ("plane", "gather") or (route == "plane"
                                             and not plane_ok):
        raise ValueError(f"column forward: route {route!r} does not take "
                         f"S={S}, K={K}")
    if route == "gather":
        return ColsFwdPlan("gather", *(0,) * 8)
    groups = -(-B * P // 4)        # column groups of the B * P columns
    cap = _COLF_THREADS // K
    gt = cap
    if spec.ndim == 3:
        plane = OS[1] * OS[2]
        gt = next((n for n in range(cap, (cap - 1) // 2, -1)
                   if plane % (4 * n) == 0), cap)
    gt = min(gt, groups)
    tiles = -(-groups // gt)
    n = 4 * gt                     # columns a tile
    if P % n == 0 or n % P == 0:   # tiles start on samples, or inside one
        nbm = max(1, n // P)
    else:
        nbm = -(-n // P) + 1
    nbm = min(nbm, B)
    budget = _COLF_SMEM[spec.ndim]
    # A tile of more than one sample stages the union of their boxes.
    box = math.prod(S) if nbm > 1 else _nominal_box(spec, S, OS, n)
    slot = -(-min(math.prod(S), box, budget // (32 * nbm)) // 4) * 4
    Cdg = C // dg
    cc = max(1, min(_COLF_CHANS, Cdg, budget // (2 * 4 * nbm * slot)))
    chunks = -(-Cdg // cc)
    target = _COLF_BLOCKS_OVERRIDE or _COLF_BLOCKS
    splits = min(chunks, max(1, -(-target // (dg * tiles))))
    per = -(-chunks // splits)
    splits = -(-chunks // per)
    return ColsFwdPlan("plane", gt, tiles, nbm, splits, per * cc, cc, slot,
                       (2 if per > 1 else 1) * cc * nbm * slot * 4)


def ineligible_reason(x: torch.Tensor, spec: DeformConvSpec,
                      out_sizes=None) -> Optional[str]:
    """None if the general kernel path takes this config, else a reason.
    Any output grid `out_sizes` is taken."""
    if spec.ndim not in (2, 3):
        return "cuda kernels support 2D and 3D only"
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return f"unsupported dtype {x.dtype}"
    if x.shape[1] % spec.deformable_groups:
        return "channels not divisible by deformable_groups"
    return None


def gathermm_fwd_reference(x, offset, mask, weight, bias,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32", out_sizes=None,
                           gate_bounds=None,
                           block_origin=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function on the same
    tensors (columns by gather, grouped contraction with fp32
    accumulation; "bfloat16" rounds both operands to bf16).  bf16 inputs
    are read in fp32 (`lib.widen`) and the result is cast to x's type, as
    the kernel reads and stores them."""
    w = lib.widen
    return core._deform_conv_nd(w(x), w(offset), w(mask), w(weight), w(bias),
                                spec, out_sizes=out_sizes,
                                precision=precision, gate_bounds=gate_bounds,
                                block_origin=block_origin).to(x.dtype)


def _geometry(x, weight, spec: DeformConvSpec, out_sizes=None):
    """The kernels' leading int arguments: B, C, *S, O, *OS, groups, dg,
    *kernel, *stride, *padding, *dilation."""
    return (*x.shape, weight.shape[0], *lib.out_grid(x, spec, out_sizes),
            spec.groups, spec.deformable_groups, *spec.kernel, *spec.stride,
            *spec.padding, *spec.dilation)


def fused_fwd(x, offset, mask, weight, bias, spec: DeformConvSpec,
              precision: str = "tensorfloat32", out_sizes=None,
              gate_bounds=None, block_origin=None) -> torch.Tensor:
    """General-offset DCN forward, (B, O, *OS) of x's type, on the output
    grid `out_sizes` (None: derived from x) with the tap gate `gate_bounds`
    (None: the open interval (-1, S_d)): the kernel `gathermm_fwd` (2D) or
    `gathermm3d_fwd` (3D), as the spec's rank.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: x, offset and mask float32 or bfloat16 (one type,
    which the result has), weight and bias float32 or bfloat16,
    contiguous, on one device."""
    floats = lib.block_floats(spec, x.shape[2:], gate_bounds, block_origin)
    if x.device.type == "cpu":
        return gathermm_fwd_reference(x, offset, mask, weight, bias, spec,
                                      precision, out_sizes, gate_bounds,
                                      block_origin)
    name = "gathermm_fwd" if spec.ndim == 2 else "gathermm3d_fwd"
    lib.check_inputs(name, x, offset, mask, weight, bias, spec, out_sizes)
    reason = ineligible_reason(x, spec, out_sizes)
    if reason is not None:
        raise NotImplementedError(f"{name}: {reason}")
    out = torch.empty((x.shape[0], weight.shape[0])
                      + lib.out_grid(x, spec, out_sizes), dtype=x.dtype,
                      device=x.device)
    xt, part, splits = lib.fwd_buffers(x, weight, spec, out)
    lib.launch(name, x, (x, offset, mask, lib.fwd_weight(weight, spec.groups),
                         lib.as_f32(bias), out, xt, part),
               (*_geometry(x, weight, spec, out_sizes), splits,
                lib.PRECISION_CODES[precision], lib.IO_CODES[x.dtype]),
               floats)
    return out


def gathermm_bwd_reference(x, offset, mask, weight, grad_out,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32", out_sizes=None,
                           gate_bounds=None, block_origin=None):
    """Plain PyTorch version of the backward kernel: autograd through
    `gathermm_fwd_reference` without bias, on the inputs read in fp32.
    Returns (grad_x, grad_offset, grad_mask or None, grad_weight), each in
    its input's type."""
    w = lib.widen
    grads = core.conv_vjp(w(x), w(offset), w(mask), w(weight), w(grad_out),
                          spec, precision, out_sizes=out_sizes,
                          gate_bounds=gate_bounds, block_origin=block_origin)
    return lib.cast_grads(grads, (x, offset, mask, weight))


def fused_bwd(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
              precision: str = "tensorfloat32", needs=(True,) * 4,
              out_sizes=None, gate_bounds=None, block_origin=None):
    """General-offset DCN backward without the bias, the kernel
    `gathermm_bwd` (2D) or `gathermm3d_bwd` (3D): (grad_x, grad_offset,
    grad_mask, grad_weight), each in its input's type, each None where
    `needs` says it is not wanted (grad_mask also without a mask).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: as `fused_fwd`'s, grad_out of x's type."""
    floats = lib.block_floats(spec, x.shape[2:], gate_bounds, block_origin)
    if x.device.type == "cpu":
        grads = gathermm_bwd_reference(x, offset, mask, weight, grad_out,
                                       spec, precision, out_sizes,
                                       gate_bounds, block_origin)
        return tuple(g if n else None for g, n in zip(grads, needs))
    name = "gathermm_bwd" if spec.ndim == 2 else "gathermm3d_bwd"
    lib.check_inputs(name, x, offset, mask, weight, None, spec, out_sizes)
    reason = ineligible_reason(x, spec, out_sizes)
    if reason is not None:
        raise NotImplementedError(f"{name}: {reason}")
    B, dg = x.shape[0], spec.deformable_groups
    OS = lib.out_grid(x, spec, out_sizes)
    lib.check_grad_out(name, grad_out, x, (B, weight.shape[0]) + OS)
    # The 3D kernel runs gcols and the gradients read from it in batch
    # chunks of gcd(B, in_step): a memory knob that does not change the
    # result, since each of those gradients belongs to one sample.
    b_step = effective_step(B, spec.in_step) if spec.ndim == 3 else None
    gx, goff, gmask, gwt, gcols, xt, part, splits = lib.bwd_buffers(
        x, offset, mask, weight, spec, math.prod(OS), needs, b_step)
    if gx is None:
        tiles = None
    elif b_step is None:       # one corner box per 4 x 4 output tile
        tiles = torch.empty((B, dg, math.prod(-(-o // _BOX_TILE) for o in OS),
                             4), dtype=torch.int32, device=x.device)
    else:                      # a box per output brick, then one per tap
        tiles = torch.empty((b_step, dg, math.prod(-(-o // _BRICK)
                                                   for o in OS),
                             1 + spec.tap_count, _BOX_INTS),
                            dtype=torch.int32, device=x.device)
    wk = lib.tap_major_weight(weight, spec.groups)
    lib.launch(name, x, (
        x, offset, mask, wk, grad_out, gcols, xt, tiles, part, gx, goff,
        gmask, gwt), (*_geometry(x, weight, spec, out_sizes),
               *(() if b_step is None else (b_step,)), splits,
               lib.PRECISION_CODES[precision], lib.IO_CODES[x.dtype]),
        floats)
    gw = (None if gwt is None else
          lib.ungrouped_weight(gwt, weight.shape).to(weight.dtype))
    return gx, goff, gmask, gw


class _GathermmFwd(torch.autograd.Function):
    """The general-offset op without any dtype cast: the forward and
    backward kernels of the config's rank, on the output grid `out_sizes`
    with the tap gate `gate_bounds` (None: the defaults), on the tensors
    `lib.kernel_inputs` gives.  x, offset, mask and weight are saved as the
    caller passed them; the columns are recomputed in the backward, never
    saved."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, spec, precision,
                out_sizes=None, gate_bounds=None, block_origin=None):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.spec, ctx.precision = spec, precision
        ctx.out_sizes, ctx.gate_bounds = out_sizes, gate_bounds
        ctx.block_origin = block_origin
        return fused_fwd(x, offset, mask, weight, bias, spec, precision,
                         out_sizes, gate_bounds, block_origin)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad
        gx, goff, gmask, gw = fused_bwd(
            x, offset, mask, weight, grad_out.contiguous(), ctx.spec,
            ctx.precision, needs[:4], ctx.out_sizes, ctx.gate_bounds,
            ctx.block_origin)
        gb = lib.bias_grad(grad_out, ctx.bias_dtype) if needs[4] else None
        return gx, goff, gmask, gw, gb, None, None, None, None, None


# ---- the columns path ------------------------------------------------------


def _cols_dtype(precision: str) -> torch.dtype:
    """The columns' (and their cotangent's) dtype: the GEMM's operand type,
    bf16 in "bfloat16" and fp32 otherwise (the JAX package's `cols_dtype`)."""
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


def gathermm_cols_reference(x, offset, mask, spec: DeformConvSpec,
                            precision: str = "tensorfloat32", out_sizes=None,
                            gate_bounds=None,
                            block_origin=None) -> torch.Tensor:
    """Plain PyTorch version of the column kernels, either rank:
    `core.deform_conv_columns` on the inputs read in fp32, laid out as the
    kernels lay the columns out, (C * K, B * P) with row c * K + k and
    column b * P + p, in the mode's columns dtype."""
    w = lib.widen
    cols = core.deform_conv_columns(w(x), w(offset), w(mask), spec, out_sizes,
                                    gate_bounds=gate_bounds,
                                    block_origin=block_origin)  # (B, P, C, K)
    cols = cols.permute(2, 3, 0, 1).reshape(x.shape[1] * spec.tap_count, -1)
    return cols.to(_cols_dtype(precision)).contiguous()


def gathermm_cols_bwd_reference(x, offset, mask, gcols, spec: DeformConvSpec,
                                precision: str = "tensorfloat32",
                                out_sizes=None, gate_bounds=None,
                                block_origin=None):
    """Plain PyTorch version of the column backward kernels: autograd's VJP
    of `gathermm_cols_reference` for the cotangent gcols.  Returns (grad_x,
    grad_offset, grad_mask or None), each in its input's type."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in (x, offset, mask)]
        cols = gathermm_cols_reference(*ins, spec, precision, out_sizes,
                                       gate_bounds, block_origin)
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(cols, live, gcols))
    return tuple(None if t is None else next(grads) for t in ins)


def _cols_geometry(x, spec: DeformConvSpec, out_sizes=None):
    """The column kernels' int arguments: B, C, *S, *OS, dg, *kernel,
    *stride, *padding, *dilation."""
    return (*x.shape, *lib.out_grid(x, spec, out_sizes),
            spec.deformable_groups, *spec.kernel, *spec.stride,
            *spec.padding, *spec.dilation)


def _cols_check(name, x, offset, mask, spec, out_sizes=None):
    lib.check_inputs(name, x, offset, mask, None, None, spec, out_sizes)
    # The kernels keep a (tap, batch, position) index in an int.
    if spec.tap_count * x.shape[0] * math.prod(
            lib.out_grid(x, spec, out_sizes)) >= 2 ** 31:
        raise NotImplementedError(f"{name}: K * B * P must stay below 2^31")


def cols_fwd(x, offset, mask, spec: DeformConvSpec,
             precision: str = "tensorfloat32", out_sizes=None,
             gate_bounds=None, block_origin=None,
             route: Optional[str] = None) -> torch.Tensor:
    """The deformable columns of the unfused path, (C * K, B * P) with row
    c * K + k and column b * P + p: float32, bf16 in "bfloat16" (the
    mode's type, whatever x's), on the output grid `out_sizes` with the tap
    gate `gate_bounds` (None: the defaults); the kernel
    `gathermm_cols_fwd` (2D) or `gathermm3d_cols_fwd` (3D), which counts
    the column values it writes.  `route` ("plane" or "gather") forces the
    kernel's route, None for cols_fwd_plan's choice.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: x, offset and mask float32 or bfloat16 (one type),
    contiguous, on one device."""
    floats = lib.block_floats(spec, x.shape[2:], gate_bounds, block_origin)
    if x.device.type == "cpu":
        return gathermm_cols_reference(x, offset, mask, spec, precision,
                                       out_sizes, gate_bounds, block_origin)
    name = "gathermm_cols_fwd" if spec.ndim == 2 else "gathermm3d_cols_fwd"
    _cols_check(name, x, offset, mask, spec, out_sizes)
    OS = lib.out_grid(x, spec, out_sizes)
    plan = cols_fwd_plan(spec, x.shape[2:], OS, x.shape[0], x.shape[1],
                         route)
    cols = torch.empty((x.shape[1] * spec.tap_count,
                        x.shape[0] * math.prod(OS)),
                       dtype=_cols_dtype(precision), device=x.device)
    lib.launch(name, x, (x, offset, mask, cols), (
        *_cols_geometry(x, spec, OS), *plan.ints(),
        lib.PRECISION_CODES[precision], lib.IO_CODES[x.dtype]), floats,
        values=cols.numel())
    return cols


def cols_bwd(x, offset, mask, gcols, spec: DeformConvSpec,
             precision: str = "tensorfloat32", needs=(True,) * 3,
             out_sizes=None, gate_bounds=None, block_origin=None):
    """The VJP of the columns for the cotangent gcols (the columns' layout
    and dtype), the kernel `gathermm_cols_bwd` (2D) or
    `gathermm3d_cols_bwd` (3D): (grad_x, grad_offset, grad_mask), each in
    its input's type, each None where `needs` says it is not wanted
    (grad_mask also without a mask).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: as `cols_fwd`'s."""
    floats = lib.block_floats(spec, x.shape[2:], gate_bounds, block_origin)
    if x.device.type == "cpu":
        grads = gathermm_cols_bwd_reference(x, offset, mask, gcols, spec,
                                            precision, out_sizes,
                                            gate_bounds, block_origin)
        return tuple(g if n else None for g, n in zip(grads, needs))
    name = "gathermm_cols_bwd" if spec.ndim == 2 else "gathermm3d_cols_bwd"
    _cols_check(name, x, offset, mask, spec, out_sizes)
    OS = lib.out_grid(x, spec, out_sizes)
    want = (x.shape[1] * spec.tap_count, x.shape[0] * math.prod(OS))
    if (tuple(gcols.shape) != want or gcols.dtype != _cols_dtype(precision)
            or gcols.device != x.device or not gcols.is_contiguous()):
        raise ValueError(f"{name}: gcols must be a contiguous "
                         f"{_cols_dtype(precision)} {want} tensor on "
                         f"{x.device}, got {gcols.dtype} "
                         f"{tuple(gcols.shape)} on {gcols.device}")
    B, C, dg = x.shape[0], x.shape[1], spec.deformable_groups
    plan = cols_bwd_plan(spec, x.shape[2:], OS, C)
    if plan.pool_per_bd >= 2 ** 31:
        raise NotImplementedError(f"{name}: corners * K * P must stay below "
                                  f"2^31")
    gx = torch.empty_like(x) if needs[0] else None
    goff = torch.empty_like(offset) if needs[1] else None
    gmask = (torch.empty_like(mask) if needs[2] and mask is not None
             else None)
    # Scratch (csrc/deform_cols_bwd.cuh): the binning counts, each tile's
    # entry count and first entry, the tables, the pixel lists (for
    # grad_x) and the correlation's partials (for grad_offset, grad_mask).
    BD, NT = B * dg, plan.tiles
    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=x.device)
    cnt = empty(BD * NT * plan.runs, torch.int32)
    tcount, tstart = empty(BD * NT, torch.int32), empty(BD * NT, torch.int64)
    pool = empty(BD * plan.pool_per_bd * plan.entry_ints, torch.int32)
    csr = (empty(BD * plan.pool_per_bd // _COL_CAP * plan.rec, torch.int16)
           if gx is not None else None)
    part = (empty(BD * plan.chunks * spec.tap_count * math.prod(OS)
                  * plan.corners, torch.float32)
            if goff is not None or gmask is not None else None)
    lib.launch(name, x, (
        x, offset, mask, gcols, cnt, tcount, tstart, pool, csr, part, gx,
        goff, gmask), (*_cols_geometry(x, spec, OS),
                       *plan.tile[3 - spec.ndim:],
                       lib.PRECISION_CODES[precision],
                       lib.IO_CODES[x.dtype]), floats)
    return gx, goff, gmask


class _GathermmCols(torch.autograd.Function):
    """(x, offset, mask) -> columns through the column kernels of the
    config's rank, on the output grid `out_sizes` with the tap gate
    `gate_bounds`; the counterpart of the JAX package's `fused_columns`.
    x, offset and mask are saved as the caller passed them."""

    @staticmethod
    def forward(ctx, x, offset, mask, spec, precision, out_sizes=None,
                gate_bounds=None, block_origin=None):
        ctx.save_for_backward(x, offset, mask)
        ctx.spec, ctx.precision = spec, precision
        ctx.out_sizes, ctx.gate_bounds = out_sizes, gate_bounds
        ctx.block_origin = block_origin
        return cols_fwd(x, offset, mask, spec, precision, out_sizes,
                        gate_bounds, block_origin)

    @staticmethod
    @once_differentiable
    def backward(ctx, gcols):
        x, offset, mask = ctx.saved_tensors
        gx, goff, gmask = cols_bwd(x, offset, mask, gcols.contiguous(),
                                   ctx.spec, ctx.precision,
                                   ctx.needs_input_grad[:3], ctx.out_sizes,
                                   ctx.gate_bounds, ctx.block_origin)
        return gx, goff, gmask, None, None, None, None, None


@contextlib.contextmanager
def _matmul_mode(precision: str):
    """cuBLAS in the mode's arithmetic whatever the global flags say: TF32
    only in "tensorfloat32", and no reduced-precision bf16 reductions; the
    flags are restored afterwards."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = precision == "tensorfloat32"
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def _bmm(a, b, out_dtype=torch.float32):
    """a @ b per batch.  bf16 operands accumulate in fp32 and give an fp32
    result where out_dtype asks for it (on the CPU: the fp32 product of the
    bf16 values, the same arithmetic)."""
    if a.dtype == torch.bfloat16 and out_dtype == torch.float32:
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b)


class _ColumnsGemm(torch.autograd.Function):
    """The columns path's grouped product, outside any kernel as in the
    JAX package (gathermm.py:1087-1100): out (B, O, *OS) = W (g, O/g,
    C/g * K) @ cols (g, C/g * K, B * P), one batched cuBLAS call, fp32
    result.  "float32": IEEE fp32; "tensorfloat32": TF32; "bfloat16": bf16
    operands, fp32 accumulation.  Its backward computes gcols (in the
    columns' dtype) and grad_weight in the same mode."""

    @staticmethod
    def forward(ctx, cols, weight, groups, precision, B, OS):
        ctx.save_for_backward(cols, weight)
        ctx.groups, ctx.precision, ctx.B, ctx.OS = groups, precision, B, OS
        O = weight.shape[0]
        w = weight.reshape(groups, O // groups, -1).to(cols.dtype)
        with _matmul_mode(precision):
            out = _bmm(w, cols.view(groups, w.shape[2], -1))   # (g, O/g, BP)
        return out.view(O, B, *OS).transpose(0, 1).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        cols, weight = ctx.saved_tensors
        g, O = ctx.groups, weight.shape[0]
        w = weight.reshape(g, O // g, -1).to(cols.dtype)
        go = (gout.transpose(0, 1).reshape(g, O // g, -1).to(cols.dtype)
              .contiguous())
        cols_g = cols.view(g, w.shape[2], -1)
        gcols = gw = None
        with _matmul_mode(ctx.precision):
            if ctx.needs_input_grad[0]:
                gcols = _bmm(w.transpose(1, 2), go, cols.dtype).view(
                    cols.shape)
            if ctx.needs_input_grad[1]:
                gw = (_bmm(go, cols_g.transpose(1, 2)).reshape(weight.shape)
                      .to(weight.dtype))
        return gcols, gw, None, None, None, None


def deform_conv_cols(x, offset, mask, weight, bias, spec: DeformConvSpec,
                     precision: str = "tensorfloat32", out_sizes=None,
                     gate_bounds=None, block_origin=None) -> torch.Tensor:
    """General-offset deformable conv with bias by the columns path: the
    column kernels, the grouped product, then the bias, as the JAX
    package's unfused branch (gathermm.py:1087-1100).  Dtypes, `out_sizes`
    and `gate_bounds` as in `deform_conv_fused`: the column kernels read x,
    offset and mask in their type; the product's fp32 result plus the bias
    is cast to x's type, the one cast of this path, as in JAX."""
    xi, oi, mi, wi, bi = lib.kernel_inputs(x, offset, mask, weight, bias)
    cols = _GathermmCols.apply(xi, oi, mi, spec, precision, out_sizes,
                               gate_bounds, block_origin)
    out = _ColumnsGemm.apply(cols, wi, spec.groups, precision, x.shape[0],
                             lib.out_grid(x, spec, out_sizes))
    if bi is not None:
        out = out + bi.to(torch.float32).reshape((1, -1) + (1,) * spec.ndim)
    return out.to(x.dtype)


def deform_conv_fused(x, offset, mask, weight, bias, spec: DeformConvSpec,
                      precision: str = "tensorfloat32", out_sizes=None,
                      gate_bounds=None, block_origin=None,
                      profile=None) -> torch.Tensor:
    """Full general-offset deformable conv with bias (dispatch entry).

    The fused pair where the profile's fuse rule (`plan.fuse_ok`; `profile`
    None: the profile of x's device) holds on the output grid, the columns
    path (`deform_conv_cols`) elsewhere; under the reference profile, as
    the JAX package's `deform_conv_fused` decides (gathermm.py:1068).
    `out_sizes` gives the output grid (None: derived from x) and `gate_bounds` the
    per-dim (lo, hi) tap gate (None: (-1, S_d)): the sharding layer's block
    mode.  The kernels take x, offset and mask in their own type where all
    three are float32 or all bfloat16 (`lib.io_dtype`), and weight and bias
    each float32 or bfloat16, as the JAX kernels do; float16 and mixed
    activation types are upcast to float32 first.  The result has x's
    dtype, and each gradient its input's."""
    if out_sizes is not None:
        out_sizes = tuple(int(o) for o in out_sizes)
    if gate_bounds is not None:
        gate_bounds = tuple((float(lo), float(hi)) for lo, hi in gate_bounds)
    if block_origin is not None:
        block_origin = tuple((float(a), float(o)) for a, o in block_origin)
    if not fuse_ok(x, spec, weight.shape[0], out_sizes, profile):
        return deform_conv_cols(x, offset, mask, weight, bias, spec,
                                precision, out_sizes, gate_bounds,
                                block_origin)
    return deform_conv_fused_pair(x, offset, mask, weight, bias, spec,
                                  precision, out_sizes, gate_bounds,
                                  block_origin)


def deform_conv_fused_pair(x, offset, mask, weight, bias,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32", out_sizes=None,
                           gate_bounds=None,
                           block_origin=None) -> torch.Tensor:
    """The fused gather pair (`_GathermmFwd`) whatever the fuse rule says;
    arguments and dtypes as `deform_conv_fused`."""
    out = _GathermmFwd.apply(*lib.kernel_inputs(x, offset, mask, weight, bias),
                             spec, precision, out_sizes, gate_bounds,
                             block_origin)
    return out.to(x.dtype)
