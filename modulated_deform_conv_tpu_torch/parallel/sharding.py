"""Mesh sharding and halo exchange for deformable convolutions, on
torch.distributed.

Counterpart of the JAX package's `parallel/sharding.py`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named axes (`make_mesh`):
each axis has its own process group, and a rank's coordinate on it is its
shard index.  The layer shards

* the batch over `batch_axis`;
* any spatial dim (H, W, or the third of a 3D op) over a mesh axis, with a
  ring **halo exchange** (`dist.batch_isend_irecv` on the axis's group), so
  that the offset-displaced taps near a shard's border can read their
  corners from the neighbours; two or three dims at once on as many axes
  (the exchanges run in dim order, and a later one carries the earlier
  ones' halo rows, so the corner blocks are exact);
* the channels over `group_axis`: group-aligned (the axis divides groups
  and deformable_groups: x, offset, mask, weight and output all split, no
  collective) or within-group tensor parallelism (groups == 1, O split, x
  offset and mask replicated on the axis).

**SPMD convention.**  Unlike JAX's `shard_map`, which takes global arrays,
every rank passes **its own shard** and receives its own shard of the
output, laid out as the JAX package's PartitionSpecs lay it: x, offset and
mask (batch_axis, [group_axis if group-aligned], *spatial axes), in
contiguous equal blocks in mesh-coordinate order; weight and bias whole, or
their O split on group_axis; the output (batch_axis, [group_axis], *spatial
axes).  The global sizes follow from the local ones and the mesh, and the
shape contract and the JAX package's divisibility and alignment errors are
checked on them (`shard_plan`).  `shard_slices` / `local_shard` cut a
global tensor into this layout.

**Gradients.**  The halo exchange is an autograd Function whose backward
sends every neighbour's halo gradient back and adds it onto the rows it
came from.  Weight and bias, which every shard of the split axes uses, go
through the identity with a summing backward over those axes (what
`shard_map` does to replicated inputs); in within-group TP x, offset and
mask do too, over the group axis.  Every sum gathers the parts and adds
them in rank order, so every rank gets the same bits and two backward runs
give the same bits.

**Bounded-offset contract.**  Spatial sharding exchanges `required_halo`
rows; samples displaced past them are dropped as if outside the image, as
in the JAX package.  Pass a larger `max_offset` (or `halo`), or shard the
batch only.

**Per-shard compute** (`block_conv`) is a function of the exchanged block
and the shard's integer coordinates alone: local padding 0 on the sharded
dims, the output grid of the shard, a tap gate at the global image border
and the block's placement in the whole input, then the op's dispatch.  A
sample's position is taken in the whole input's coordinates, (base +
shift) + offset, and gated there; only its integer low corner moves to
the block's (less the block's origin).  So the shards round every position
as the unsharded op does.  (The JAX package folds the shift into the
offsets instead, offset + delta in fp32, which can move a position by an
ulp across a grid line, where the offset gradient jumps.)  On CUDA tensors
it runs the gather kernels' block mode (`out_sizes`, `gate_bounds`,
`block_origin`): the fused pair or the columns path as the JAX package's
`_fuse_ok` decides on the local grid.

**Shift-blend's lead mode** (`_local_conv`, the JAX package's
sharding.py:179-210): with one split, of the leading spatial dim, and
max_offset > 0, a narrow slab (C/dg <= the device profile's
`sb_lead_crossover_cg`, 128 in the reference profile) whose block the
lead mode takes (`shiftblend.sharded_lead_reason`) runs the
shift-blend kernels on the same block arguments
(`shiftblend.deform_conv_shift_sharded`) under impl="auto" on CUDA
tensors, the counterpart of the JAX package's on-TPU rule; impl=
"shiftblend" forces it (on CPU tensors its plain version) and raises
where it does not apply.  impl="cuda" keeps the gather kernels' block
mode, so both pairs can run on one layout.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import api as ops_api
from ..ops.cuda import shiftblend as _sb
from ..utils.config import DeformConvSpec
from ..utils.device import DeviceProfile, current_profile


def make_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "space"),
              device_type: str = "cuda"):
    """A named DeviceMesh of the first prod(shape) ranks of the initialized
    world ("cuda" with NCCL, "cpu" with gloo)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if world == n:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axis_names))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def required_halo(spec: DeformConvSpec, max_offset: float,
                  dim: int = 0) -> int:
    """Halo rows needed on each side of a shard of spatial dim `dim`.

    The upper side needs `pad + ceil(max_offset)` rows; the lower side the
    kernel-footprint overshoot `(k-1)*dil + 1 - stride - pad` (can be
    negative) plus `ceil(max_offset)`.  The larger is exchanged."""
    k, s, p, d = (spec.kernel[dim], spec.stride[dim], spec.padding[dim],
                  spec.dilation[dim])
    m = int(math.ceil(max(0.0, float(max_offset))))
    up = p + m
    dn = max(0, (k - 1) * d + 1 - s - p) + m
    return max(up, dn, 0)


class _SpatialShard(NamedTuple):
    """One sharded spatial dim."""
    dim: int          # spatial dim index (0 = H)
    axis_name: str    # mesh axis
    n_shards: int
    halo: int
    out_local: int    # output rows per shard along dim
    in_local: int     # input rows per shard along dim


class ShardPlan(NamedTuple):
    """What a sharded call does, from the global shapes and the mesh's axis
    sizes alone."""
    spec: DeformConvSpec          # the per-shard spec (groups split)
    shards: Tuple[_SpatialShard, ...]
    batch_axis: Optional[str]     # None where the batch is not split
    group_axis: Optional[str]     # None where the channels are not split
    group_aligned: bool

    def split_axes(self) -> List[str]:
        """The axes the data is split over: the batch's and the spatial
        dims'.  Weight and bias gradients are summed over them."""
        return ([self.batch_axis] if self.batch_axis else []) + [
            sh.axis_name for sh in self.shards]

    def placements(self) -> Dict[str, Dict[int, str]]:
        """Tensor dim -> mesh axis of each argument and of the output:
        "x" (offset and mask alike), "out", "weight", "bias"."""
        sp = {2 + sh.dim: sh.axis_name for sh in self.shards}
        b = {0: self.batch_axis} if self.batch_axis else {}
        g = {1: self.group_axis} if self.group_axis else {}
        return {"x": {**b, **(g if self.group_aligned else {}), **sp},
                "out": {**b, **g, **sp},
                "weight": {0: self.group_axis} if self.group_axis else {},
                "bias": {0: self.group_axis} if self.group_axis else {}}


def _dim_names(spatial_axis, nd: int) -> List[Optional[str]]:
    """One optional mesh-axis name per spatial dim: a string shards dim 0,
    a sequence names one axis per dim."""
    if spatial_axis is None:
        return [None] * nd
    if isinstance(spatial_axis, str):
        return [spatial_axis] + [None] * (nd - 1)
    names = list(spatial_axis) + [None] * (nd - len(spatial_axis))
    if len(names) > nd:
        raise ValueError(f"spatial_axis names {len(names)} dims, op has {nd}")
    return names


def shard_plan(x_shape, offset_shape, weight_shape, mask_shape, bias_shape,
               spec: DeformConvSpec, sizes: Dict[str, int],
               batch_axis: Optional[str] = "data", spatial_axis="space",
               max_offset: float = 0.0, halo=None,
               group_axis: Optional[str] = None) -> ShardPlan:
    """The shard plan of a call with these GLOBAL shapes on a mesh of these
    axis sizes, raising the JAX package's errors (sharding.py:317-367)."""
    spec.validate(x_shape, offset_shape, weight_shape, mask_shape,
                  bias_shape)
    nd = spec.ndim
    B, O = x_shape[0], weight_shape[0]
    OS = spec.out_sizes(x_shape[2:])
    g, dg = spec.groups, spec.deformable_groups
    n_b = sizes[batch_axis] if batch_axis else 1
    n_g = sizes[group_axis] if group_axis else 1
    if B % n_b:
        raise ValueError(f"batch {B} not divisible by mesh axis {n_b}")
    dim_names = _dim_names(spatial_axis, nd)
    sharded = [d for d, name in enumerate(dim_names)
               if name is not None and sizes[name] > 1]
    if halo is None:
        halos = {d: required_halo(spec, max_offset, dim=d) for d in sharded}
    elif isinstance(halo, int):
        halos = {d: halo for d in sharded}
    else:
        if len(halo) != len(sharded):
            raise ValueError(f"halo sequence has {len(halo)} entries for "
                             f"{len(sharded)} sharded spatial dims")
        halos = dict(zip(sharded, halo))
    shards = []
    for d in sharded:
        n_d = sizes[dim_names[d]]
        S_d, OS_d = x_shape[2 + d], OS[d]
        if S_d % n_d or OS_d % n_d:
            raise ValueError(
                f"spatial dim {d}: size {S_d}/out {OS_d} not divisible by "
                f"mesh axis {dim_names[d]}={n_d}")
        if (OS_d // n_d) * spec.stride[d] != S_d // n_d:
            raise ValueError(
                f"spatial sharding of dim {d} requires OS_local*stride == "
                f"S_local (got OS/n={OS_d // n_d}, stride={spec.stride[d]}, "
                f"S/n={S_d // n_d}); use batch-only sharding for this "
                "config")
        shards.append(_SpatialShard(d, dim_names[d], n_d, halos[d],
                                    OS_d // n_d, S_d // n_d))
    lspec, aligned = spec, False
    if n_g > 1:
        if g % n_g == 0 and dg % n_g == 0:
            aligned = True
            if O % n_g:
                raise ValueError(f"out channels {O} not divisible by "
                                 f"group mesh axis {n_g}")
            lspec = DeformConvSpec(
                ndim=nd, kernel=spec.kernel, stride=spec.stride,
                padding=spec.padding, dilation=spec.dilation,
                groups=g // n_g, deformable_groups=dg // n_g,
                in_step=spec.in_step, modulated=spec.modulated)
        elif not (g == 1 and O % n_g == 0):
            raise ValueError(
                f"group_axis size {n_g} must divide groups={g} and "
                f"deformable_groups={dg} (group-aligned mode), or groups "
                f"must be 1 with O % {n_g} == 0 (within-group TP)")
    return ShardPlan(lspec, tuple(shards), batch_axis if n_b > 1 else None,
                     group_axis if n_g > 1 else None, aligned)


def shard_slices(shape, placement: Dict[int, str], coords: Dict[str, int],
                 sizes: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a global tensor of `shape` that the rank at mesh
    coordinates `coords` holds, each dim in `placement` split in equal
    contiguous blocks over its axis."""
    out = []
    for d, n in enumerate(shape):
        axis = placement.get(d)
        if axis is None or sizes[axis] == 1:
            out.append(slice(None))
        else:
            step = n // sizes[axis]
            out.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    return tuple(out)


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate}."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def local_shard(t: torch.Tensor, placement: Dict[int, str], mesh):
    """This rank's shard of the global tensor t (a contiguous copy)."""
    if t is None:
        return None
    sl = shard_slices(t.shape, placement, mesh_coords(mesh), axis_sizes(mesh))
    return t[sl].contiguous()


# ---- the per-shard compute -------------------------------------------------


def block_args(spec: DeformConvSpec, shards, coords, ext_sizes):
    """The per-shard spec (padding 0 on the sharded dims), the block's
    placement (shift, origin) per spatial dim and the tap gate per spatial
    dim, for the exchanged block of spatial sizes `ext_sizes` of the shard
    at `coords` (one index per entry of `shards`).  Along a sharded dim d,
    the global sample coordinate of output o_g = i*OSl + o_l is o_g*stride
    - pad + t*dil + off: the local base o_l*stride + t*dil plus the shift
    i*OSl*stride - pad.  The block starts at the origin i*Sl - halo.  The
    gate is the global (-1, S) in the block's coordinates, cut to the
    block's (-1, S_ext) (sharding.py:231-256)."""
    nd = spec.ndim
    placement = [(0.0, 0.0)] * nd
    padding = list(spec.padding)
    gates = [(-1.0, float(s)) for s in ext_sizes]
    for sh, i in zip(shards, coords):
        d = sh.dim
        origin = i * sh.in_local - sh.halo       # block row 0, globally
        placement[d] = (float(i * sh.out_local * spec.stride[d]
                              - spec.padding[d]), float(origin))
        padding[d] = 0
        gates[d] = (max(-1.0, -1.0 - origin),
                    min(float(ext_sizes[d]),
                        float(sh.in_local * sh.n_shards - origin)))
    local = DeformConvSpec(
        ndim=nd, kernel=spec.kernel, stride=spec.stride,
        padding=tuple(padding), dilation=spec.dilation, groups=spec.groups,
        deformable_groups=spec.deformable_groups, in_step=spec.in_step,
        modulated=spec.modulated)
    return local, tuple(placement), tuple(gates)


def block_conv(x_ext, off_l, mask_l, weight, bias, spec: DeformConvSpec,
               shards, coords, impl: str = "auto",
               precision: str = "tensorfloat32"):
    """The op on one shard's exchanged block x_ext (its rows and `halo`
    rows of each neighbour per sharded dim, zeros past the image), for the
    shard at `coords`.  offset and mask are the shard's own, on its output
    grid, as they are."""
    local, placement, gates = block_args(spec, shards, coords,
                                         tuple(x_ext.shape[2:]))
    return ops_api._dispatch(x_ext, off_l, mask_l, weight, bias, local, impl,
                             precision, out_sizes=tuple(off_l.shape[2:]),
                             gate_bounds=gates, block_origin=placement)


def cut_block(x: torch.Tensor, shards, coords) -> torch.Tensor:
    """The exchanged block of the shard at `coords`, cut from the global
    tensor x: what the ring delivers, zero rows past the image."""
    for sh, i in zip(shards, coords):
        axis = 2 + sh.dim
        lo, hi = i * sh.in_local - sh.halo, (i + 1) * sh.in_local + sh.halo
        n = x.shape[axis]
        x = x.narrow(axis, max(lo, 0), min(hi, n) - max(lo, 0))
        pad = [0, 0] * (x.ndim - axis - 1) + [max(0, -lo), max(0, hi - n)]
        x = F.pad(x, pad)
    return x.contiguous()


# ---- collectives -----------------------------------------------------------


class _Ring(NamedTuple):
    """A mesh axis as the ring exchange sees it."""
    group: object     # the axis's process group
    ranks: tuple      # global ranks along the axis, in coordinate order
    index: int        # this rank's coordinate


def _ring(mesh, axis_name: str) -> _Ring:
    a = mesh.mesh_dim_names.index(axis_name)
    coord = list(mesh.get_coordinate())
    ranks = []
    for j in range(mesh.shape[a]):
        coord[a] = j
        ranks.append(int(mesh.mesh[tuple(coord)]))
    return _Ring(mesh.get_group(axis_name), tuple(ranks),
                 mesh.get_local_rank(axis_name))


def _p2p(sends, recvs, group) -> None:
    """Post every (tensor, global peer) send and receive at once; wait."""
    ops = ([dist.P2POp(dist.isend, t, p, group) for t, p in sends]
           + [dist.P2POp(dist.irecv, t, p, group) for t, p in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _pieces(halo: int, hs: int, n: int) -> List[int]:
    """Rows the block takes from the neighbour j hops away, j = 1, 2, ...:
    min(hs, what is left of the halo); past the ring's end, none."""
    rows, left = [], halo
    for _ in range(min(-(-halo // hs), n - 1)):
        rows.append(min(hs, left))
        left -= rows[-1]
    return rows


class _HaloExchange(torch.autograd.Function):
    """x (the shard) -> its block: `halo` rows of the lower neighbours, x,
    `halo` rows of the upper neighbours along `axis`, zeros past either
    end of the image.  Where the halo is wider than a shard the rows come
    from several hops (the JAX package's multi-hop ring).  The backward
    sends each neighbour's rows' gradient back and adds, in a fixed order,
    what comes back onto the rows it was taken from."""

    @staticmethod
    def forward(ctx, x, halo, axis, ring):
        hs, n, i = x.shape[axis], len(ring.ranks), ring.index
        rows = _pieces(halo, hs, n)
        ctx.halo, ctx.axis, ctx.ring, ctx.rows = halo, axis, ring, rows

        def buf(r):
            shape = list(x.shape)
            shape[axis] = r
            return x.new_zeros(shape)
        lo = [buf(r) for r in rows]       # from i - j
        hi = [buf(r) for r in rows]       # from i + j
        sends, recvs = [], []
        for j, r in enumerate(rows, 1):
            if i + j < n:
                sends.append((x.narrow(axis, hs - r, r).contiguous(),
                              ring.ranks[i + j]))
                recvs.append((hi[j - 1], ring.ranks[i + j]))
            if i - j >= 0:
                sends.append((x.narrow(axis, 0, r).contiguous(),
                              ring.ranks[i - j]))
                recvs.append((lo[j - 1], ring.ranks[i - j]))
        _p2p(sends, recvs, ring.group)
        pad = buf(halo - sum(rows))
        return torch.cat([pad] + lo[::-1] + [x] + hi + [pad], dim=axis)

    @staticmethod
    def backward(ctx, g):
        halo, axis, ring, rows = ctx.halo, ctx.axis, ctx.ring, ctx.rows
        n, i = len(ring.ranks), ring.index
        hs = g.shape[axis] - 2 * halo
        gx = g.narrow(axis, halo, hs).clone()
        sends, recvs, adds = [], [], []
        at_lo, at_hi = halo, halo + hs
        for j, r in enumerate(rows, 1):
            at_lo -= r
            if i - j >= 0:     # rows from i - j: their gradient goes back
                sends.append((g.narrow(axis, at_lo, r).contiguous(),
                              ring.ranks[i - j]))
                back = gx.new_empty(gx.narrow(axis, 0, r).shape)
                recvs.append((back, ring.ranks[i - j]))
                adds.append((0, back))
            if i + j < n:
                sends.append((g.narrow(axis, at_hi, r).contiguous(),
                              ring.ranks[i + j]))
                back = gx.new_empty(gx.narrow(axis, 0, r).shape)
                recvs.append((back, ring.ranks[i + j]))
                adds.append((hs - r, back))
            at_hi += r
        _p2p(sends, recvs, ring.group)
        for start, back in adds:
            gx.narrow(axis, start, back.shape[axis]).add_(back)
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, axis: int, mesh,
                  axis_name: str) -> torch.Tensor:
    """Ring halo exchange of x along tensor dim `axis` over mesh axis
    `axis_name` (differentiable)."""
    if halo == 0:
        return x
    return _HaloExchange.apply(x.contiguous(), halo, axis,
                               _ring(mesh, axis_name))


def _all_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum of t over each process group in turn: the parts gathered
    and added in rank order, so that every rank gets the same bits."""
    for group in groups:
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = parts[0].clone()
        for p in parts[1:]:
            t += p
    return t


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the groups: a
    tensor every shard of those axes uses, as `shard_map` transposes a
    replicated input."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_sum(g, ctx.groups), None


class _AllSum(torch.autograd.Function):
    """The sum over the groups, replicated on every rank; its backward sums
    the gradients the same way."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_sum(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_sum(g, ctx.groups), None


def _groups(mesh, axes) -> list:
    return [mesh.get_group(a) for a in axes]


def sum_grad(t: Optional[torch.Tensor], mesh, axes) -> Optional[torch.Tensor]:
    """t, with its gradient summed over the mesh axes `axes`."""
    if t is None or not axes:
        return t
    return _SumGrad.apply(t, _groups(mesh, axes))


def all_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of t over the mesh axes `axes` (differentiable)."""
    if not axes:
        return t
    return _AllSum.apply(t, _groups(mesh, axes))


# ---- the sharded op --------------------------------------------------------


def lead_prefers(x_l, spec: DeformConvSpec, shards, max_offset: float,
                 profile: DeviceProfile = None) -> bool:
    """Whether "auto" on CUDA tensors takes shift-blend's lead mode for
    this shard (the JAX package's rule, sharding.py:179-203, with the
    constant of `profile`; None: the profile of x_l's device): one split,
    of the leading spatial dim, max_offset > 0, a block the lead mode
    takes and C/dg <= `sb_lead_crossover_cg`.  A shape rule: x_l may lie
    on any device (meta included)."""
    if not (max_offset > 0 and len(shards) == 1 and shards[0].dim == 0):
        return False
    prof = profile or current_profile(x_l)
    return (x_l.shape[1] // spec.deformable_groups
            <= prof.sb_lead_crossover_cg
            and _lead_reason(x_l, spec, shards[0], max_offset) is None)


def _lead_reason(x_l, spec: DeformConvSpec, sh, max_offset: float):
    ext = ((x_l.shape[0], x_l.shape[1], x_l.shape[2] + 2 * sh.halo)
           + tuple(x_l.shape[3:]))
    return _sb.sharded_lead_reason(ext, x_l.dtype, spec, float(max_offset),
                                   sh.halo, sh.out_local * sh.n_shards)


def _lead_mode(x_l, spec: DeformConvSpec, shards, max_offset: float,
               impl: str) -> bool:
    """Whether the shard runs shift-blend's lead mode: under "auto", CUDA
    tensors (the JAX package's on-TPU condition) and `lead_prefers`; under
    "shiftblend", forced, raising, before any exchange, where it does not
    apply."""
    if impl == "shiftblend":
        if not (max_offset > 0 and len(shards) == 1 and shards[0].dim == 0):
            raise NotImplementedError(
                "shiftblend shard path covers single-axis leading-dim "
                "spatial sharding with max_offset > 0 only, in its lead "
                f"mode (got dims {[s.dim for s in shards]}, max_offset "
                f"{max_offset}); use impl='auto' or 'cuda'")
        reason = _lead_reason(x_l, spec, shards[0], max_offset)
        if reason is not None:
            raise NotImplementedError(
                f"shiftblend shard path (lead mode) unavailable: {reason}")
        return True
    return (impl == "auto" and x_l.is_cuda
            and lead_prefers(x_l, spec, shards, max_offset))


def shard_conv(x_ext, off_l, mask_l, weight, bias, spec: DeformConvSpec,
               shards, coords, max_offset: float = 0.0, impl: str = "auto",
               precision: str = "tensorfloat32", lead=None):
    """The sharded op's per-shard function on the exchanged block of the
    shard at `coords`: where `lead` (`_lead_mode`'s decision, taken here
    when None) holds, shift-blend's lead mode on `block_conv`'s block
    arguments with the bounded-offset contract at `max_offset`, else
    `block_conv`.  One card can run every shard with it on blocks cut by
    `cut_block`."""
    if lead is None:
        x_l = x_ext
        for sh in shards:
            x_l = x_l.narrow(2 + sh.dim, sh.halo, sh.in_local)
        lead = _lead_mode(x_l, spec, shards, max_offset, impl)
    if lead:
        local, placement, gates = block_args(spec, shards, coords,
                                             tuple(x_ext.shape[2:]))
        return _sb.deform_conv_shift_sharded(
            x_ext, off_l, mask_l, weight, bias, local, precision,
            float(max_offset), tuple(off_l.shape[2:]), gates, placement)
    return block_conv(x_ext, off_l, mask_l, weight, bias, spec, shards,
                      coords, impl, precision)


def _local_conv(x_l, off_l, mask_l, weight, bias, spec: DeformConvSpec,
                shards, mesh, max_offset: float = 0.0, impl: str = "auto",
                precision: str = "tensorfloat32"):
    """Per-shard computation with spatial shards: the exchanges in dim
    order, then `shard_conv`.  The lead mode is decided once, before any
    exchange (`_lead_mode`), so a forced "shiftblend" it does not take
    raises there."""
    lead = _lead_mode(x_l, spec, shards, max_offset, impl)
    x_ext = x_l
    for sh in shards:
        x_ext = halo_exchange(x_ext, sh.halo, 2 + sh.dim, mesh, sh.axis_name)
    coords = [mesh.get_local_rank(sh.axis_name) for sh in shards]
    return shard_conv(x_ext, off_l, mask_l, weight, bias, spec, shards,
                      coords, max_offset, impl, precision, lead)


def sharded_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                        mask: Optional[torch.Tensor], weight: torch.Tensor,
                        bias: Optional[torch.Tensor], spec: DeformConvSpec,
                        mesh, batch_axis: Optional[str] = "data",
                        spatial_axis="space", max_offset: float = 0.0,
                        halo=None, group_axis: Optional[str] = None,
                        impl: str = "auto",
                        precision: str = "tensorfloat32") -> torch.Tensor:
    """Deformable conv over a (batch, spatial..., group) sharded mesh.

    SPMD: every argument is this rank's shard (module docstring), and so is
    the result.  `impl` is the per-shard path ("auto", "torch", "cuda",
    "shiftblend"; with a spatial split "shiftblend" is the lead mode, which
    takes one leading-dim split with max_offset > 0 and raises otherwise).
    With a positive `max_offset` the contract doubles as the bounded-offset
    declaration: batch- or group-only layouts dispatch with
    `offset_bound=max_offset`.

    `spatial_axis`: a string names the mesh axis sharding the first
    spatial dim; a sequence of optional names gives one per spatial dim,
    e.g. (None, "space") shards W only, ("sh", "sw") H and W.  `halo`
    overrides the exchange width (an int, or one per sharded dim in dim
    order).  `max_offset` is the bounded-offset contract: samples displaced
    beyond ceil(max_offset) rows past the shard's halo count as outside the
    image."""
    sizes = axis_sizes(mesh)
    nd = spec.ndim
    n_b = sizes[batch_axis] if batch_axis else 1
    n_g = sizes[group_axis] if group_axis else 1
    aligned = (n_g > 1 and spec.groups % n_g == 0
               and spec.deformable_groups % n_g == 0)
    names = _dim_names(spatial_axis, nd)
    n_s = [sizes[a] if a is not None else 1 for a in names]
    n_c = n_g if aligned else 1

    def glob(shape, n_lead, n_chan, spatial):
        if shape is None:
            return None
        s = [shape[0] * n_lead, shape[1] * n_chan] + list(shape[2:])
        if spatial:
            s[2:] = [v * k for v, k in zip(s[2:], n_s)]
        return tuple(s)

    wshape = (weight.shape[0] * n_g,) + tuple(weight.shape[1:])
    plan = shard_plan(
        glob(x.shape, n_b, n_c, True), glob(offset.shape, n_b, n_c, True),
        wshape, glob(None if mask is None else mask.shape, n_b, n_c, True),
        None if bias is None else (bias.shape[0] * n_g,), spec, sizes,
        batch_axis, spatial_axis, max_offset, halo, group_axis)

    split = plan.split_axes()
    weight, bias = sum_grad(weight, mesh, split), sum_grad(bias, mesh, split)
    if plan.group_axis and not plan.group_aligned:
        # Within-group TP: every rank of the group axis reads all of x,
        # offset and mask.
        tp = [plan.group_axis]
        x, offset, mask = (sum_grad(t, mesh, tp) for t in (x, offset, mask))
    if plan.shards:
        return _local_conv(x, offset, mask, weight, bias, plan.spec,
                           plan.shards, mesh, max_offset, impl, precision)
    return ops_api._dispatch(
        x, offset, mask, weight, bias, plan.spec, impl, precision,
        offset_bound=float(max_offset) if max_offset > 0 else None)


def sharded_deform_conv2d(x, offset, weight, bias=None, *, mesh, stride=1,
                          padding=0, dilation=1, groups=1,
                          deformable_groups=1, in_step=64, batch_axis="data",
                          spatial_axis="space", max_offset=0.0, halo=None,
                          group_axis=None, impl="auto",
                          precision="tensorfloat32"):
    spec = DeformConvSpec.make(2, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step, False)
    return sharded_deform_conv(x, offset, None, weight, bias, spec, mesh,
                               batch_axis, spatial_axis, max_offset, halo,
                               group_axis, impl, precision)


def sharded_modulated_deform_conv2d(x, offset, mask, weight, bias=None, *,
                                    mesh, stride=1, padding=0, dilation=1,
                                    groups=1, deformable_groups=1, in_step=64,
                                    batch_axis="data", spatial_axis="space",
                                    max_offset=0.0, halo=None,
                                    group_axis=None, impl="auto",
                                    precision="tensorfloat32"):
    spec = DeformConvSpec.make(2, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step, True)
    return sharded_deform_conv(x, offset, mask, weight, bias, spec, mesh,
                               batch_axis, spatial_axis, max_offset, halo,
                               group_axis, impl, precision)


def sharded_deform_conv3d(x, offset, weight, bias=None, *, mesh, stride=1,
                          padding=0, dilation=1, groups=1,
                          deformable_groups=1, in_step=64, batch_axis="data",
                          spatial_axis="space", max_offset=0.0, halo=None,
                          group_axis=None, impl="auto",
                          precision="tensorfloat32"):
    spec = DeformConvSpec.make(3, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step, False)
    return sharded_deform_conv(x, offset, None, weight, bias, spec, mesh,
                               batch_axis, spatial_axis, max_offset, halo,
                               group_axis, impl, precision)


def sharded_modulated_deform_conv3d(x, offset, mask, weight, bias=None, *,
                                    mesh, stride=1, padding=0, dilation=1,
                                    groups=1, deformable_groups=1, in_step=64,
                                    batch_axis="data", spatial_axis="space",
                                    max_offset=0.0, halo=None,
                                    group_axis=None, impl="auto",
                                    precision="tensorfloat32"):
    spec = DeformConvSpec.make(3, weight.shape[2:], stride, padding, dilation,
                               groups, deformable_groups, in_step, True)
    return sharded_deform_conv(x, offset, mask, weight, bias, spec, mesh,
                               batch_axis, spatial_axis, max_offset, halo,
                               group_axis, impl, precision)


# ---- dense layers on the same shards (the modules' predictors, ConvBN) ------


def data_axes(mesh, batch_axis, spatial_axis, nd: int) -> List[str]:
    """The mesh axes (of size > 1) a module's input is split over."""
    sizes = axis_sizes(mesh)
    axes = [batch_axis] if batch_axis and sizes[batch_axis] > 1 else []
    return axes + [a for a in _dim_names(spatial_axis, nd)
                   if a is not None and sizes[a] > 1]


def sharded_conv(x, weight, bias, stride, padding, dilation, mesh,
                 batch_axis="data", spatial_axis="space"):
    """A dense convolution (torch's conv2d / conv3d) of the rank's shard,
    equal to its shard of the global convolution: each sharded dim gets a
    halo exchange of `required_halo(., 0)` rows and padding 0; weight and
    bias gradients are summed over the split axes.  Needs S_local =
    OS_local * stride on the sharded dims."""
    nd = x.ndim - 2
    spec = DeformConvSpec.make(nd, weight.shape[2:], stride, padding,
                               dilation)
    sizes = axis_sizes(mesh)
    pad, rows = list(spec.padding), {}
    for d, name in enumerate(_dim_names(spatial_axis, nd)):
        if name is None or sizes[name] == 1:
            continue
        h, axis, hs = required_halo(spec, 0.0, d), 2 + d, x.shape[2 + d]
        if hs % spec.stride[d]:
            raise ValueError(f"spatial dim {d}: shard size {hs} not a "
                             f"multiple of stride {spec.stride[d]}")
        # Block row h - pad is the first input row of the shard's first
        # output row; padding 0 there.
        x = halo_exchange(x, h, axis, mesh, name)
        x = x.narrow(axis, h - pad[d], hs + h + pad[d])
        pad[d], rows[d] = 0, hs // spec.stride[d]
    axes = data_axes(mesh, batch_axis, spatial_axis, nd)
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(x, sum_grad(weight, mesh, axes), sum_grad(bias, mesh, axes),
             spec.stride, tuple(pad), spec.dilation)
    for d, n in rows.items():
        y = y.narrow(2 + d, 0, n)
    return y


def sharded_group_norm(x, norm, mesh, batch_axis="data",
                       spatial_axis="space"):
    """`norm` (a torch GroupNorm) of the rank's shard with the statistics
    of the whole sample: the per-group sums are summed over the sharded
    spatial axes (two passes: mean, then the centred second moment);
    weight and bias gradients are summed over the split axes."""
    nd = x.ndim - 2
    sizes = axis_sizes(mesh)
    spatial = [a for a in _dim_names(spatial_axis, nd)
               if a is not None and sizes[a] > 1]
    B, C = x.shape[:2]
    G = norm.num_groups
    xg = x.reshape(B, G, -1)
    count = xg.shape[-1] * math.prod(sizes[a] for a in spatial)
    mean = all_sum(xg.sum(-1, keepdim=True), mesh, spatial) / count
    xc = xg - mean
    var = all_sum((xc * xc).sum(-1, keepdim=True), mesh, spatial) / count
    y = (xc * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    axes = data_axes(mesh, batch_axis, spatial_axis, nd)
    if norm.affine:
        shape = (1, C) + (1,) * nd
        y = (y * sum_grad(norm.weight, mesh, axes).reshape(shape)
             + sum_grad(norm.bias, mesh, axes).reshape(shape))
    return y
