"""Module layer: the eight deformable-conv modules as `torch.nn.Module`s.

Counterparts of the JAX package's flax modules (models/modules.py):

explicit-offset modules (forward takes x + offset [+ mask]):
  DeformConv2d, ModulatedDeformConv2d, DeformConv3d, ModulatedDeformConv3d
"Pack" modules (learn the offset / mask predictor convs internally):
  DeformConv2dPack, ModulatedDeformConv2dPack, DeformConv3dPack,
  ModulatedDeformConv3dPack

Parameters are `weight`, `bias`, `conv_offset.*` and `conv_mask.*`, laid
out OIHW / OIDHW like the flax modules' (models/torch_compat.py carries
them over).
Initialization follows the flax modules:

* weight ~ U(-s, s) with s = 1/sqrt(C_in * prod(kernel)); bias = 0;
* the Pack predictor convs use the same uniform init with zero bias.  They
  are not zero-initialized and the mask gets no sigmoid by default; the
  opt-in flags `zero_init_offset=True` (which zeroes conv_mask as well) and
  `sigmoid_mask=True` give the usual DCN practice.

Constructors take `device=` (default "cuda") and `dtype=`; nothing is moved
to another device silently.

Mesh-sharded execution: with `mesh` (a named DeviceMesh, parallel.make_mesh)
the op runs through parallel/sharding.py (batch sharding, spatial halo
exchange, group tensor parallelism), `max_offset` being its bounded-offset
contract.  SPMD: every rank calls the module on its own shard, as
`sharded_deform_conv` takes it, and the parameters stay whole on every rank;
their gradients are summed over the axes the data is split over, so every
rank holds the same, global, gradient.  A Pack module takes x with all
channels on every rank of `group_axis`, and its predictors run on the
spatial shards with a halo exchange of their own (`sharding.sharded_conv`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops import api as ops_api
from ..utils.config import DeformConvSpec, ntuple

IntOrSeq = Union[int, Sequence[int]]


def _fan_in_uniform_(t: torch.Tensor, fan_in: int) -> None:
    stdv = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-stdv, stdv)


class _DeformConvBase(nn.Module):
    """Shared plumbing for the modules."""
    _ndim = 2
    _modulated = False

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, deformable_groups: int = 1,
                 bias: bool = False, in_step: int = 64, impl: str = "auto",
                 offset_bound: Optional[float] = None, *, mesh=None,
                 batch_axis: Optional[str] = "data", spatial_axis="space",
                 group_axis: Optional[str] = None, max_offset: float = 0.0,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        if in_channels % groups:
            raise ValueError("in_channels not divisible by groups")
        if out_channels % groups:
            raise ValueError("out_channels not divisible by groups")
        if in_channels % deformable_groups:
            raise ValueError("in_channels not divisible by deformable_groups")
        nd = self._ndim
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = ntuple(kernel_size, nd)
        self.stride = ntuple(stride, nd)
        self.padding = ntuple(padding, nd)
        self.dilation = ntuple(dilation, nd)
        self.groups, self.deformable_groups = groups, deformable_groups
        self.in_step, self.impl = in_step, impl
        # Bounded-offset contract enabling the shift-blend kernel; None
        # keeps the general kernel.
        self.offset_bound = offset_bound
        self.mesh, self.batch_axis = mesh, batch_axis
        self.spatial_axis, self.group_axis = spatial_axis, group_axis
        self.max_offset = max_offset
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size,
            device=device, dtype=dtype))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)
        _fan_in_uniform_(self.weight,
                         in_channels * math.prod(self.kernel_size))

    def _spec(self) -> DeformConvSpec:
        return DeformConvSpec.make(
            self._ndim, self.kernel_size, self.stride, self.padding,
            self.dilation, self.groups, self.deformable_groups, self.in_step,
            modulated=self._modulated)

    def _group_split(self):
        """(size, coordinate) of group_axis on the mesh, (1, 0) without."""
        if self.mesh is None or self.group_axis is None:
            return 1, 0
        from ..parallel.sharding import axis_sizes
        return (axis_sizes(self.mesh)[self.group_axis],
                self.mesh.get_local_rank(self.group_axis))

    def _sharded_conv(self, x, offset, mask):
        """The op on this rank's shards; weight and bias cut to the rank's
        output channels where group_axis splits them."""
        from ..parallel import sharding
        weight, bias = self.weight, self.bias
        n_g, i_g = self._group_split()
        if n_g > 1:
            rows = self.out_channels // n_g
            weight, bias = (None if t is None else sharding.sum_grad(
                t, self.mesh, [self.group_axis]).narrow(0, i_g * rows, rows)
                for t in (weight, bias))
        return sharding.sharded_deform_conv(
            x, offset, mask if self._modulated else None, weight, bias,
            self._spec(), self.mesh, batch_axis=self.batch_axis,
            spatial_axis=self.spatial_axis, max_offset=self.max_offset,
            group_axis=self.group_axis, impl=self.impl)

    def _conv(self, x, offset, mask):
        if self.mesh is not None:
            return self._sharded_conv(x, offset, mask)
        kwargs = dict(stride=self.stride, padding=self.padding,
                      dilation=self.dilation, groups=self.groups,
                      deformable_groups=self.deformable_groups,
                      in_step=self.in_step, impl=self.impl,
                      offset_bound=self.offset_bound)
        if self._modulated:
            op = (ops_api.modulated_deform_conv2d if self._ndim == 2
                  else ops_api.modulated_deform_conv3d)
            return op(x, offset, mask, self.weight, self.bias, **kwargs)
        op = (ops_api.deform_conv2d if self._ndim == 2
              else ops_api.deform_conv3d)
        return op(x, offset, self.weight, self.bias, **kwargs)


class DeformConv2d(_DeformConvBase):
    """Explicit-offset DCNv1 2D."""

    def forward(self, x, offset):
        return self._conv(x, offset, None)


class ModulatedDeformConv2d(_DeformConvBase):
    """Explicit-offset DCNv2 2D."""
    _modulated = True

    def forward(self, x, offset, mask):
        return self._conv(x, offset, mask)


class DeformConv3d(_DeformConvBase):
    """Explicit-offset DCNv1 3D."""
    _ndim = 3

    def forward(self, x, offset):
        return self._conv(x, offset, None)


class ModulatedDeformConv3d(_DeformConvBase):
    """Explicit-offset DCNv2 3D."""
    _ndim = 3
    _modulated = True

    def forward(self, x, offset, mask):
        return self._conv(x, offset, mask)


class _PackBase(_DeformConvBase):
    """Pack variant: offset (and mask) come from predictor convs applied to
    x, sharing the main conv's stride / padding / dilation so they live on
    the output grid.  The predictors are ordinary convolutions (nn.Conv2d /
    nn.Conv3d), as the JAX package computes them outside its kernels."""

    def __init__(self, *args, zero_init_offset: bool = False,
                 sigmoid_mask: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.sigmoid_mask = sigmoid_mask
        K = math.prod(self.kernel_size)
        factory = dict(device=self.weight.device, dtype=self.weight.dtype)
        self.conv_offset = self._predictor(
            self.deformable_groups * self._ndim * K, zero_init_offset,
            factory)
        if self._modulated:
            self.conv_mask = self._predictor(self.deformable_groups * K,
                                             zero_init_offset, factory)

    def _predictor(self, out_ch: int, zero_init: bool, factory) -> nn.Module:
        conv_cls = nn.Conv2d if self._ndim == 2 else nn.Conv3d
        conv = conv_cls(self.in_channels, out_ch, self.kernel_size,
                        stride=self.stride, padding=self.padding,
                        dilation=self.dilation, bias=True, **factory)
        with torch.no_grad():
            if zero_init:
                conv.weight.zero_()
            else:
                _fan_in_uniform_(conv.weight, self.in_channels
                                 * math.prod(self.kernel_size))
            conv.bias.zero_()
        return conv

    def _predict(self, conv: nn.Module, x):
        """A predictor conv in x's dtype, as the JAX package's
        `_PredictorConv`: weight and bias cast to x's dtype.  With a mesh,
        on the rank's spatial shard (`sharding.sharded_conv`)."""
        w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
        if self.mesh is None:
            return conv._conv_forward(x, w, b)
        from ..parallel import sharding
        if self._aligned():
            # Each rank of the group axis reads its own channels of the
            # prediction.
            w, b = (sharding.sum_grad(t, self.mesh, [self.group_axis])
                    for t in (w, b))
        return sharding.sharded_conv(x, w, b, self.stride, self.padding,
                                     self.dilation, self.mesh,
                                     self.batch_axis, self.spatial_axis)

    def _aligned(self) -> bool:
        """Does group_axis split the groups (group-aligned mode)?"""
        n_g, _ = self._group_split()
        return (n_g > 1 and self.groups % n_g == 0
                and self.deformable_groups % n_g == 0)

    def forward(self, x):
        aligned = self._aligned()
        if aligned:
            # Every rank of the group axis holds all of x and uses its own
            # channels of it: its gradient is summed over the axis.
            from ..parallel.sharding import sum_grad
            x = sum_grad(x, self.mesh, [self.group_axis])
        offset = self._predict(self.conv_offset, x)
        mask = None
        if self._modulated:
            mask = self._predict(self.conv_mask, x)
            if self.sigmoid_mask:
                mask = torch.sigmoid(mask)
        if aligned:
            n_g, i_g = self._group_split()
            x, offset, mask = (None if t is None else t.narrow(
                1, i_g * (t.shape[1] // n_g), t.shape[1] // n_g)
                for t in (x, offset, mask))
        return self._conv(x, offset, mask)


class DeformConv2dPack(_PackBase):
    """Learned-offset DCNv1 2D."""


class ModulatedDeformConv2dPack(_PackBase):
    """Learned offset + mask DCNv2 2D."""
    _modulated = True


class DeformConv3dPack(_PackBase):
    """Learned-offset DCNv1 3D."""
    _ndim = 3


class ModulatedDeformConv3dPack(_PackBase):
    """Learned offset + mask DCNv2 3D."""
    _ndim = 3
    _modulated = True
