"""DCNResNet3d's deformable layers and its captured training step on the
card, at the benchmark cell's size (32 clips of 16 x 112 x 112, width 64).

Marked `cuda`: each test skips without an NVIDIA GPU.  Imports no JAX:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_resnet3d_cuda.py -q

* each of the 13 DCN layers' shapes at B=32 (c3_1 from 8 x 28 x 28 to
  4 x 14 x 14 at stride 2, through c5's 1 x 4 x 4; six distinct shapes)
  under "auto", which takes the 3D columns path: the output and the
  gradients of x, offset, mask and weight against the port's plain op,
  under the column tests' limits (max|kernel - plain| / max|plain|:
  float32 1e-5, tensorfloat32 5e-3);
* `train_step` of DCNResNet3d captured (`graphs.capture`): 13 launches of
  each 3D column kernel, one AdamW launch and 40 of each GroupNorm kernel
  a step, over the column values, parameters and normalised values the
  shapes give (`CapturedStep.kernels`, `.values`), no fused 3D kernel,
  and replays whose loss is finite and falls.
"""
import math

import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer, train_step)
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda

LIMITS = {"float32": 1e-5, "tensorfloat32": 5e-3}
B = 32
# (C, input T x H x W, stride, layers of this shape): c3_1, c3_2-4, c4_1,
# c4_2-6, c5_1, c5_2-3 at 16 x 112 x 112 clips.
LAYERS = [
    (128, (8, 28, 28), 2, 1), (128, (4, 14, 14), 1, 3),
    (256, (4, 14, 14), 2, 1), (256, (2, 7, 7), 1, 5),
    (512, (2, 7, 7), 2, 1), (512, (1, 4, 4), 1, 2),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _out_sizes(S, stride):
    return tuple((s - 1) // stride + 1 for s in S)


def test_layers_are_the_models():
    """LAYERS lists the 13 layers of DCNResNet3d at the cell's clips (on
    meta tensors, so on any machine)."""
    net = mdt.DCNResNet3d(device="meta")
    seen = []
    for name, m in net.named_modules():
        if name.endswith(".dcn"):
            m.register_forward_hook(lambda m, i, o: seen.append(
                (i[0].shape[1], tuple(i[0].shape[2:]), m.stride[0])))
    with torch.no_grad():
        net(torch.empty((B, 3, 16, 112, 112), device="meta"))
    assert seen == [(C, S, s) for C, S, s, n in LAYERS for _ in range(n)]


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("layer", LAYERS,
                         ids=[f"{c}ch-{'x'.join(map(str, S))}-s{s}"
                              for c, S, s, _ in LAYERS])
def test_dcn_layer_matches_plain(dev, layer, precision):
    C, S, stride, _ = layer
    rng = np.random.default_rng(7)
    OS = _out_sizes(S, stride)

    def t(shape, lo=None, hi=None):
        a = (rng.uniform(lo, hi, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.tensor(a, dtype=torch.float32, device=dev)
    ins = [t((B, C) + S), t((B, 81) + OS, -2.0, 2.0),
           t((B, 27) + OS, 0.0, 1.0),
           t((C, C, 3, 3, 3)) / math.sqrt(27 * C)]
    gout = t((B, C) + OS)
    runs = {}
    for impl in ("auto", "torch"):
        leaves = [a.clone().requires_grad_(True) for a in ins]
        before = lib.counts().launches
        out = mdt.modulated_deform_conv3d(*leaves, None, stride, 1,
                                          impl=impl, precision=precision)
        out.backward(gout)
        launched = lib.counts().launches - before
        launches = (launched["gathermm3d_cols_fwd"],
                    launched["gathermm3d_cols_bwd"])
        assert launches == ((1, 1) if impl == "auto" else (0, 0))
        runs[impl] = [out.detach()] + [a.grad for a in leaves]
        del out, leaves
    for name, got, want in zip(("out", "x", "offset", "mask", "weight"),
                               runs["auto"], runs["torch"]):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _rel(got, want) <= LIMITS[precision], (name, _rel(got, want))


def test_captured_train_step_runs_the_3d_columns(dev):
    torch.manual_seed(0)
    net = mdt.DCNResNet3d(device=dev)
    opt = make_optimizer(net)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((B, 3, 16, 112, 112), generator=g, device=dev)
    y = torch.randint(0, 400, (B,), generator=g, device=dev)
    step = graphs.capture(lambda a, b: train_step(net, opt, a, b), x, y)
    assert step.kernels == {"gathermm3d_cols_fwd": 13,
                            "gathermm3d_cols_bwd": 13, "adamw": 1,
                            "groupnorm_fwd": 40, "groupnorm_bwd": 40}
    cols = sum(n * C * 27 * B * math.prod(_out_sizes(S, s))
               for C, S, s, n in LAYERS)
    assert cols == 498_106_368
    assert step.values == {"gathermm3d_cols_fwd": cols,
                           "adamw": 57_463_756,
                           "groupnorm_fwd": 524_140_544}
    # The capture's warm-up trained on this batch already; each replay
    # trains on it again.
    losses = [step.read(step(x, y)) for _ in range(2)]
    assert all(map(math.isfinite, losses)) and losses[1] < losses[0]
