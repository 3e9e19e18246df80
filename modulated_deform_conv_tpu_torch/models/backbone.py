"""DCN backbones: ResNet bottleneck stages with DCNv2 in c3-c5, and the
small video network with 3D DCNv2 in its deeper stages.

Counterparts of the JAX package's flax classes in models/backbone.py
(`ConvBN`, `DCNBottleneck`, `DCNStage`, `DCNResNet`; `ConvBN3d`,
`DCN3dBottleneck`, `DCNVideoNet`): the classic "DCN in ResNet stages 3-5"
recipe of the DCN papers, NCHW throughout, and its video analog, NCTHW.
The 3x3 conv of every c3-c5 bottleneck is a `ModulatedDeformConv2dPack`
(the 3x3x3 conv of every video bottleneck past the first stage a
`ModulatedDeformConv3dPack`) with zero-init offset / mask predictors and a
sigmoid mask.  Without `offset_bound` the general gather kernels run
forward and backward on CUDA tensors, at stride 2 in the first block of
each ResNet stage as well.

Defaults that differ between the frameworks are pinned here to flax's:
GroupNorm eps is 1e-6 (torch: 1e-5); the ResNet stem's max pool pads with
-inf (what `MaxPool2d` does); the video net pools (1, 2, 2) with padding
VALID (`MaxPool3d` without padding).  models/torch_compat.py carries flax
parameters over; submodule names follow flax's where flax names them
(`stem`, `c2`..`c5`, `block<i>`, `s<i>b<j>`, `dcn`, `conv2`, `proj`,
`fc`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import ModulatedDeformConv2dPack, ModulatedDeformConv3dPack


def _promote(x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """x in the result type of x and the parameters, as flax's `nn.Conv`
    and `nn.GroupNorm` promote their input (bf16 input, fp32 parameters:
    fp32)."""
    return x.to(torch.promote_types(x.dtype, param.dtype))


class ConvBN(nn.Module):
    """kxk conv (no bias, pad k//2) + GroupNorm(min(32, C)) + optional
    ReLU.  With `mesh`, on the rank's shard of the (batch, spatial) split:
    the conv with a halo exchange, the norm with the whole sample's
    statistics (parallel/sharding.py)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, relu: bool = True, *, mesh=None,
                 batch_axis="data", spatial_axis="space", device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride,
                              kernel // 2, bias=False, **factory)
        self.norm = nn.GroupNorm(min(32, out_channels), out_channels,
                                 eps=1e-6, **factory)
        self.relu = relu
        self.mesh, self.batch_axis = mesh, batch_axis
        self.spatial_axis = spatial_axis

    def forward(self, x):
        x = _promote(x, self.conv.weight)
        if self.mesh is None:
            y = self.norm(self.conv(x))
        else:
            from ..parallel import sharding
            c = self.conv
            y = sharding.sharded_conv(x, c.weight, None, c.stride, c.padding,
                                      c.dilation, self.mesh, self.batch_axis,
                                      self.spatial_axis)
            y = sharding.sharded_group_norm(y, self.norm, self.mesh,
                                            self.batch_axis,
                                            self.spatial_axis)
        return F.relu(y) if self.relu else y


class DCNBottleneck(nn.Module):
    """ResNet bottleneck whose 3x3 conv is a DCNv2 Pack module (zero-init
    offsets + sigmoid mask), or a plain 3x3 ConvBN when
    `deformable=False`.  `mesh`, `max_offset`, `batch_axis` and
    `spatial_axis` go to every layer (models/modules.py)."""

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 deformable_groups: int = 1, stride: int = 1,
                 deformable: bool = True, impl: str = "auto", *, mesh=None,
                 max_offset: float = 0.0, batch_axis="data",
                 spatial_axis="space", device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        shard = dict(mesh=mesh, batch_axis=batch_axis,
                     spatial_axis=spatial_axis)
        self.conv1 = ConvBN(in_channels, channels, 1, **shard, **factory)
        if deformable:
            self.dcn = ModulatedDeformConv2dPack(
                channels, channels, 3, stride=stride, padding=1,
                deformable_groups=deformable_groups, impl=impl,
                zero_init_offset=True, sigmoid_mask=True,
                max_offset=max_offset, **shard, **factory)
        else:
            self.conv2 = ConvBN(channels, channels, 3, stride, **shard,
                                **factory)
        self.conv3 = ConvBN(channels, out_channels, 1, relu=False, **shard,
                            **factory)
        self.proj = (ConvBN(in_channels, out_channels, 1, stride, relu=False,
                            **shard, **factory)
                     if in_channels != out_channels or stride != 1 else None)

    def forward(self, x):
        y = self.conv1(x)
        y = self.dcn(y) if hasattr(self, "dcn") else self.conv2(y)
        y = self.conv3(F.relu(y))
        identity = x if self.proj is None else self.proj(x)
        return F.relu(y + identity)


class DCNStage(nn.Sequential):
    """`blocks` bottlenecks (one ResNet stage), the first with `stride`,
    named block0, block1, ...; the mesh fields go to every block."""

    def __init__(self, blocks: int, in_channels: int, channels: int,
                 out_channels: int, deformable_groups: int = 1,
                 stride: int = 1, deformable: bool = True,
                 impl: str = "auto", *, mesh=None, max_offset: float = 0.0,
                 batch_axis="data", spatial_axis="space", device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(blocks):
            self.add_module(f"block{i}", DCNBottleneck(
                in_channels if i == 0 else out_channels, channels,
                out_channels, deformable_groups, stride if i == 0 else 1,
                deformable, impl, mesh=mesh, max_offset=max_offset,
                batch_axis=batch_axis, spatial_axis=spatial_axis,
                device=device, dtype=dtype))


class DCNResNet(nn.Module):
    """ResNet with DCNv2 in stages c3-c5 (Dai et al. 2017 §4.1; Zhu et al.
    2018 §5.1).  depth 50 / 101 / 152 -> blocks (3, 4, 6, 3) /
    (3, 4, 23, 3) / (3, 8, 36, 3).  NCHW in, class logits out, or the
    (c2, c3, c4, c5) features with `features_only=True`."""

    BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

    def __init__(self, num_classes: int = 1000, depth: int = 50,
                 deformable_groups: int = 1, width: int = 64,
                 features_only: bool = False, impl: str = "auto", *,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in self.BLOCKS:
            raise ValueError(f"depth must be one of {sorted(self.BLOCKS)}, "
                             f"got {depth}")
        factory = dict(device=device, dtype=dtype)
        w = width
        self.features_only = features_only
        # stem: 7x7/2 conv + 3x3/2 max pool
        self.stem = ConvBN(3, w, 7, 2, **factory)
        self.pool = nn.MaxPool2d(3, 2, 1)
        cin = w
        for i, n in enumerate(self.BLOCKS[depth]):
            cout = w * 4 * 2 ** i
            self.add_module(f"c{i + 2}", DCNStage(
                n, cin, w * 2 ** i, cout, deformable_groups,
                stride=1 if i == 0 else 2, deformable=i >= 1, impl=impl,
                **factory))
            cin = cout
        self.fc = None if features_only else nn.Linear(cin, num_classes,
                                                       **factory)

    def forward(self, x):
        y = self.pool(self.stem(x))
        feats = []
        for stage in (self.c2, self.c3, self.c4, self.c5):
            y = stage(y)
            feats.append(y)
        if self.features_only:
            return tuple(feats)
        return self.fc(y.mean((2, 3)))


class ConvBN3d(nn.Module):
    """1x1x1 or 3x3x3 conv (no bias, pad k//2) + GroupNorm(min(32, C)) +
    optional ReLU, NCTHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, relu: bool = True, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.conv = nn.Conv3d(in_channels, out_channels, kernel, stride,
                              kernel // 2, bias=False, **factory)
        self.norm = nn.GroupNorm(min(32, out_channels), out_channels,
                                 eps=1e-6, **factory)
        self.relu = relu

    def forward(self, x):
        y = self.norm(self.conv(_promote(x, self.conv.weight)))
        return F.relu(y) if self.relu else y


class DCN3dBottleneck(nn.Module):
    """3D bottleneck whose 3x3x3 conv is a modulated 3D DCN Pack module
    (zero-init offsets + sigmoid mask), or a plain 3x3x3 ConvBN3d when
    `deformable=False`; stride 1."""

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 deformable_groups: int = 1, deformable: bool = True,
                 impl: str = "auto", *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.conv1 = ConvBN3d(in_channels, channels, 1, **factory)
        if deformable:
            self.dcn = ModulatedDeformConv3dPack(
                channels, channels, 3, padding=1,
                deformable_groups=deformable_groups, impl=impl,
                zero_init_offset=True, sigmoid_mask=True, **factory)
        else:
            self.conv2 = ConvBN3d(channels, channels, 3, **factory)
        self.conv3 = ConvBN3d(channels, out_channels, 1, relu=False,
                              **factory)
        self.proj = (ConvBN3d(in_channels, out_channels, 1, relu=False,
                              **factory)
                     if in_channels != out_channels else None)

    def forward(self, x):
        y = self.conv1(x)
        y = self.dcn(y) if hasattr(self, "dcn") else self.conv2(y)
        y = self.conv3(F.relu(y))
        identity = x if self.proj is None else self.proj(x)
        return F.relu(y + identity)


class DCNVideoNet(nn.Module):
    """Small video-classification backbone with deformable 3D convs in
    every stage but the first: a 3x3x3 stem of `width` channels, then per
    stage i `blocks[i]` bottlenecks of width * 2**i channels (out: twice
    that), named s<i>b<j>, a (1, 2, 2) max pool between stages, the mean
    over (T, H, W) and `fc`.  NCTHW in (T = frames), class logits out."""

    def __init__(self, num_classes: int = 400, width: int = 32,
                 blocks=(1, 1, 1), deformable_groups: int = 1,
                 impl: str = "auto", *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.blocks = tuple(blocks)
        self.stem = ConvBN3d(3, width, 3, **factory)
        self.pool = nn.MaxPool3d((1, 2, 2), (1, 2, 2))
        cin = width
        for i, n in enumerate(self.blocks):
            cout = width * 2 * 2 ** i
            for j in range(n):
                self.add_module(f"s{i}b{j}", DCN3dBottleneck(
                    cin, width * 2 ** i, cout, deformable_groups,
                    deformable=i >= 1, impl=impl, **factory))
                cin = cout
        self.fc = nn.Linear(cin, num_classes, **factory)

    def forward(self, x):
        y = self.stem(x)
        for i, n in enumerate(self.blocks):
            for j in range(n):
                y = getattr(self, f"s{i}b{j}")(y)
            if i < len(self.blocks) - 1:
                y = self.pool(y)
        return self.fc(y.mean((2, 3, 4)))
