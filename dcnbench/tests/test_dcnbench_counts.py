"""The yardstick's counts against hand counts: a deformable layer's
op-level bytes and operations, and the model operations the reference
counts, for one layer of each rank."""
import math

import pytest
import torch

from dcnbench.reference import backbone
from dcnbench.work import HBM_BYTES_PER_S, PEAK_OPS, bound_s, dcn_work


def test_dcn_work_2d_by_hand():
    # x (2, 8, 10, 12), 3x3 stride 1 pad 1: out (2, 6, 10, 12); dg 1.
    w = dcn_work((2, 8, 10, 12), (2, 18, 10, 12), (2, 9, 10, 12),
                 (6, 8, 3, 3), None, 2 * 6 * 10 * 12, 1)
    x, off, mask, wt = 2 * 8 * 120, 2 * 18 * 120, 2 * 9 * 120, 6 * 8 * 9
    out = 2 * 6 * 120
    ops = 2 * out * 8 * 9
    assert w["fwd"] == (4 * (x + off + mask + wt + out), ops)
    assert w["bwd"] == (4 * (2 * (x + off + mask + wt) + out), 2 * ops)


def test_dcn_work_3d_by_hand_with_groups_and_bias():
    # x (1, 8, 4, 6, 6), 3x3x3, groups 2, bias; out (1, 4, 4, 6, 6).
    w = dcn_work((1, 8, 4, 6, 6), (1, 81, 4, 6, 6), None, (4, 4, 3, 3, 3),
                 (4,), 4 * 144, 2)
    x, off, wt, out = 8 * 144, 81 * 144, 4 * 4 * 27, 4 * 144
    ops = 2 * out * 4 * 27
    assert w["fwd"] == (4 * (x + off + wt + out + 4), ops)
    assert w["bwd"] == (4 * (2 * (x + off + wt) + out), 2 * ops)


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert bound_s(1.0, 495e12) == pytest.approx(1.0)
    assert PEAK_OPS["tensorfloat32"] == 495e12 and HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("nd", [2, 3])
def test_reference_counts_one_dcn_layer_by_hand(nd):
    """A Pack layer's forward: the offset predictor (nd*K outputs), the mask
    predictor (K outputs) and the deformable conv, 2 operations a
    multiply-add each."""
    C, O, S = 8, 8, (4,) * nd
    K = 3 ** nd
    p = {"l.weight": torch.empty((O, C) + (3,) * nd, device="meta"),
         "l.conv_offset.weight": torch.empty((nd * K, C) + (3,) * nd,
                                             device="meta"),
         "l.conv_offset.bias": torch.empty(nd * K, device="meta"),
         "l.conv_mask.weight": torch.empty((K, C) + (3,) * nd, device="meta"),
         "l.conv_mask.bias": torch.empty(K, device="meta")}
    flops = []
    with torch.no_grad():
        backbone.dcn_pack(p, "l", torch.empty((2, C) + S, device="meta"), 1,
                          flops=flops)
    P = 2 * math.prod(S)   # two samples, stride 1
    assert flops == [2 * P * nd * K * C * K, 2 * P * K * C * K,
                     2 * P * O * C * K]


def test_resnet50_forward_count_at_224():
    """DCNResNet-50's forward at 224x224, counted on meta tensors: ResNet-50's
    published 4.1 GMAC (He et al. 2016, Table 1: 3.8e9 FLOPs counted as
    multiply-adds) plus the 13 layers' predictors, 2 operations each."""
    fwd, shapes = backbone.MODELS["dcn_resnet"]
    args = {"depth": 50, "width": 64, "num_classes": 1000,
            "deformable_groups": 1}
    p = {n: torch.empty(s, device="meta") for n, s in shapes(**args)}
    flops = []
    with torch.no_grad():
        fwd(p, torch.empty((1, 3, 224, 224), device="meta"), flops=flops,
            **args)
    dense_and_dcn = sum(flops) / 2
    assert 4.0e9 < dense_and_dcn < 4.6e9
