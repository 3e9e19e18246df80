"""A plain 3D ResNet with DCNv2 in c3-c5, in float32: the reference the
video cells are held against.

`dcn_resnet3d` is the 3D ResNet of Hara, Kataoka and Satoh, "Can
Spatiotemporal 3D CNNs Retrace the History of 2D CNNs and ImageNet?"
(CVPR 2018, arXiv:1711.09577; the ResNet-50 of its architecture table and
its Kinetics-400 input of 16 frames of 112x112), NCTHW:

* stem: conv 7x7x7, 3 -> 64, stride (1, 2, 2), pad 3; then max pool
  3x3x3, stride 2, pad 1;
* c2-c5: (3, 4, 6, 3) bottlenecks (depth 50), 1x1x1 -> 3x3x3 -> 1x1x1,
  64/128/256/512 channels inside and four times that out; the first
  block of c3-c5 at stride 2 in T, H and W on its 3x3x3 conv; shortcut
  type B (a strided 1x1x1 projection where the shape changes);
* head: the mean over (T, H, W), a linear layer, softmax cross-entropy.

Departures from the paper:

* every 3x3x3 conv of c3-c5 is a modulated deformable conv with its
  offset (3 a tap) and sigmoid-mask predictors, 3x3x3 convs on the output
  grid: DCNv2's placement (Zhu et al. 2019, arXiv:1811.11168 §4), 13
  layers at depth 50; the paper's network has no DCN;
* GroupNorm(min(32, C)), eps 1e-6, in place of BatchNorm3d (Wu & He 2018,
  arXiv:1803.08494), as the 2D backbone (`backbone.py`);
* the weights are the benchmark's draw from the seed (the configuration's
  `init` rules; predictors U(+-2/sqrt(fan_in))), not trained ones.

Built from `backbone.py`'s conv, norm, deformable layer and bottleneck,
which take 3D inputs as they take 2D; `precision` and `flops` as there.
Imports torch, the standard library and its sibling modules only.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .backbone import (RESNET_BLOCKS, _bottleneck_shapes, _conv_norm_shapes,
                       bottleneck, conv_norm, linear)

STEM_STRIDE = (1, 2, 2)   # Hara et al.: no temporal stride in the stem


def dcn_resnet3d(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 depth: int = 50, precision: str = "float32",
                 flops: Optional[List[int]] = None, **_) -> torch.Tensor:
    """Logits of clips x (B, 3, T, H, W)."""
    y = conv_norm(p, "stem", x, 7, STEM_STRIDE, precision=precision,
                  flops=flops)
    y = F.max_pool3d(y, 3, 2, 1)
    for i, n in enumerate(RESNET_BLOCKS[depth]):
        for j in range(n):
            y = bottleneck(p, f"c{i + 2}.block{j}", y,
                           2 if i > 0 and j == 0 else 1, i > 0, precision,
                           flops)
    return linear(y.mean((2, 3, 4)), p["fc.weight"], p["fc.bias"], precision,
                  flops)


def dcn_resnet3d_shapes(depth: int = 50, width: int = 64,
                        num_classes: int = 400, deformable_groups: int = 1,
                        **_):
    """(name, shape) of every parameter of `dcn_resnet3d`."""
    out = _conv_norm_shapes("stem", width, 3, 7, 3)
    cin = width
    for i, n in enumerate(RESNET_BLOCKS[depth]):
        mid, cout = width * 2 ** i, width * 4 * 2 ** i
        for j in range(n):
            out += _bottleneck_shapes(f"c{i + 2}.block{j}", cin, mid, cout,
                                      2 if i > 0 and j == 0 else 1, i > 0,
                                      deformable_groups, 3)
            cin = cout
    return out + [("fc.weight", (num_classes, cin)),
                  ("fc.bias", (num_classes,))]


# forward, parameter shapes
MODELS = {"dcn_resnet3d": (dcn_resnet3d, dcn_resnet3d_shapes)}
