"""DCN backbones: ResNet bottleneck stages with DCNv2 in c3-c5, 2D and 3D,
and the small video network with 3D DCNv2 in its deeper stages.

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

`DCNResNet3d` has no JAX counterpart: the 3D ResNet of Hara et al. 2018
(arXiv:1711.09577) with DCNv2 placed as in `DCNResNet` (arXiv:1811.11168
§4), built from the same stages with 3D bottlenecks.  With the program's
spans on (`utils/profiling.py::tracing`) its stem and stages are the spans
"mdc.model.stem" and "mdc.model.c2" .. "mdc.model.c5".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.groupnorm import group_norm_act
from ..utils import profiling
from .modules import ModulatedDeformConv2dPack, ModulatedDeformConv3dPack


def _promote(x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """x in the result type of x and the parameters, as flax's `nn.Conv`
    and `nn.GroupNorm` promote their input (bf16 input, fp32 parameters:
    fp32)."""
    return x.to(torch.promote_types(x.dtype, param.dtype))


def _norm_act(y: torch.Tensor, norm: nn.GroupNorm, identity, relu: bool):
    """act(norm(y) [+ identity]) as one op (ops/cuda/groupnorm.py)."""
    return group_norm_act(y, norm.num_groups, norm.weight, norm.bias,
                          norm.eps, identity, relu)


class ConvBN(nn.Module):
    """kxk conv (no bias, pad k//2) + GroupNorm(min(32, C)) [+ identity]
    + optional ReLU.  Without `mesh` the norm and its epilogue are one op
    (ops/cuda/groupnorm.py: one kernel each way on the card).  With `mesh`,
    on the rank's shard of the (batch, spatial) split: the conv with a halo
    exchange, the norm with the whole sample's statistics
    (parallel/sharding.py), then the add and the ReLU."""

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

    def forward(self, x, identity=None):
        x = _promote(x, self.conv.weight)
        if self.mesh is None:
            return _norm_act(self.conv(x), self.norm, identity, self.relu)
        from ..parallel import sharding
        c = self.conv
        y = sharding.sharded_conv(x, c.weight, None, c.stride, c.padding,
                                  c.dilation, self.mesh, self.batch_axis,
                                  self.spatial_axis)
        y = sharding.sharded_group_norm(y, self.norm, self.mesh,
                                        self.batch_axis, self.spatial_axis)
        if identity is not None:
            y = y + identity
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
        # conv3's norm takes the residual add and the block's ReLU.
        self.conv3 = ConvBN(channels, out_channels, 1, **shard, **factory)
        self.proj = (ConvBN(in_channels, out_channels, 1, stride, relu=False,
                            **shard, **factory)
                     if in_channels != out_channels or stride != 1 else None)

    def forward(self, x):
        y = self.conv1(x)
        # conv2 applies its ReLU; the DCN branch's comes here.
        y = F.relu(self.dcn(y)) if hasattr(self, "dcn") else self.conv2(y)
        identity = x if self.proj is None else self.proj(x)
        return self.conv3(y, identity)


class DCNStage(nn.Sequential):
    """`blocks` bottlenecks (one ResNet stage), the first with `stride`,
    named block0, block1, ...: `DCNBottleneck`s, each given the mesh
    fields, or with `ndim=3` `DCN3dBottleneck`s, which take no mesh."""

    def __init__(self, blocks: int, in_channels: int, channels: int,
                 out_channels: int, deformable_groups: int = 1,
                 stride: int = 1, deformable: bool = True,
                 impl: str = "auto", *, mesh=None, max_offset: float = 0.0,
                 batch_axis="data", spatial_axis="space", device="cuda",
                 dtype: torch.dtype = torch.float32, ndim: int = 2):
        super().__init__()
        if ndim == 2:
            block = DCNBottleneck
            shard = dict(mesh=mesh, max_offset=max_offset,
                         batch_axis=batch_axis, spatial_axis=spatial_axis)
        elif ndim == 3 and mesh is None:
            block, shard = DCN3dBottleneck, {}
        else:
            raise ValueError(f"a stage is 2D, or 3D without a mesh; got "
                             f"ndim={ndim}, mesh={mesh}")
        for i in range(blocks):
            self.add_module(f"block{i}", block(
                in_channels if i == 0 else out_channels, channels,
                out_channels, deformable_groups,
                stride=stride if i == 0 else 1, deformable=deformable,
                impl=impl, device=device, dtype=dtype, **shard))


def _add_resnet_stages(net: nn.Module, depth: int, width: int,
                       deformable_groups: int, impl: str, ndim: int,
                       factory: dict) -> int:
    """Stages c2-c5 of a ResNet of `depth` on `net`: width * 2**i channels
    inside, four times that out, DCN in c3-c5, the first block of c3-c5 at
    stride 2.  Returns c5's channels."""
    cin = width
    for i, n in enumerate(DCNResNet.BLOCKS[depth]):
        cout = width * 4 * 2 ** i
        net.add_module(f"c{i + 2}", DCNStage(
            n, cin, width * 2 ** i, cout, deformable_groups,
            stride=1 if i == 0 else 2, deformable=i >= 1, impl=impl,
            ndim=ndim, **factory))
        cin = cout
    return cin


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
        self.features_only = features_only
        # stem: 7x7/2 conv + 3x3/2 max pool
        self.stem = ConvBN(3, width, 7, 2, **factory)
        self.pool = nn.MaxPool2d(3, 2, 1)
        cin = _add_resnet_stages(self, depth, width, deformable_groups, impl,
                                 2, factory)
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
    """k x k x k conv (no bias, pad k//2) at `stride` (an int, or one per
    axis (T, H, W)) + GroupNorm(min(32, C)) [+ identity] + optional ReLU,
    NCTHW; the norm and its epilogue as one op, as in `ConvBN`."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride=1, relu: bool = True, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.conv = nn.Conv3d(in_channels, out_channels, kernel, stride,
                              kernel // 2, bias=False, **factory)
        self.norm = nn.GroupNorm(min(32, out_channels), out_channels,
                                 eps=1e-6, **factory)
        self.relu = relu

    def forward(self, x, identity=None):
        return _norm_act(self.conv(_promote(x, self.conv.weight)), self.norm,
                         identity, self.relu)


class DCN3dBottleneck(nn.Module):
    """3D bottleneck whose 3x3x3 conv is a modulated 3D DCN Pack module
    (zero-init offsets + sigmoid mask), or a plain 3x3x3 ConvBN3d when
    `deformable=False`.  `stride` is the 3x3x3 conv's, and the strided 1x1x1
    projection's, which is there where the channels or the stride change
    (Hara et al.'s shortcut type B)."""

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 deformable_groups: int = 1, deformable: bool = True,
                 impl: str = "auto", stride: int = 1, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.conv1 = ConvBN3d(in_channels, channels, 1, **factory)
        if deformable:
            self.dcn = ModulatedDeformConv3dPack(
                channels, channels, 3, stride=stride, padding=1,
                deformable_groups=deformable_groups, impl=impl,
                zero_init_offset=True, sigmoid_mask=True, **factory)
        else:
            self.conv2 = ConvBN3d(channels, channels, 3, stride, **factory)
        # conv3's norm takes the residual add and the block's ReLU.
        self.conv3 = ConvBN3d(channels, out_channels, 1, **factory)
        self.proj = (ConvBN3d(in_channels, out_channels, 1, stride,
                              relu=False, **factory)
                     if in_channels != out_channels or stride != 1 else None)

    def forward(self, x):
        y = self.conv1(x)
        # conv2 applies its ReLU; the DCN branch's comes here.
        y = F.relu(self.dcn(y)) if hasattr(self, "dcn") else self.conv2(y)
        identity = x if self.proj is None else self.proj(x)
        return self.conv3(y, identity)


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


class DCNResNet3d(nn.Module):
    """3D ResNet (Hara et al. 2018, arXiv:1711.09577: the 3D ResNet-50 of
    its Kinetics-400 table) with modulated 3D DCN in stages c3-c5, placed as
    `DCNResNet` places it.  A 7x7x7 stem at stride (1, 2, 2) and a 3x3x3 /
    2 max pool, stages c2-c5 of `DCNResNet.BLOCKS[depth]` bottlenecks (the
    first of c3-c5 at stride 2 in T, H and W, on its 3x3x3 conv and its
    projection), the mean over (T, H, W) and `fc`.  GroupNorm(min(32, C))
    stands in for BatchNorm3d.  NCTHW in (T = frames), class logits out."""

    def __init__(self, num_classes: int = 400, depth: int = 50,
                 width: int = 64, deformable_groups: int = 1,
                 impl: str = "auto", *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in DCNResNet.BLOCKS:
            raise ValueError(f"depth must be one of "
                             f"{sorted(DCNResNet.BLOCKS)}, got {depth}")
        factory = dict(device=device, dtype=dtype)
        self.stem = ConvBN3d(3, width, 7, (1, 2, 2), **factory)
        self.pool = nn.MaxPool3d(3, 2, 1)
        cin = _add_resnet_stages(self, depth, width, deformable_groups, impl,
                                 3, factory)
        self.fc = nn.Linear(cin, num_classes, **factory)

    def forward(self, x):
        with profiling.span("mdc.model.stem", x):
            y = self.pool(self.stem(x))
        for name in ("c2", "c3", "c4", "c5"):
            with profiling.span(f"mdc.model.{name}", x):
                y = getattr(self, name)(y)
        return self.fc(y.mean((2, 3, 4)))
