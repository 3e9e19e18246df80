"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Forward and backward kernels, 2D and 3D.  Marked `cuda`: each test skips
without an NVIDIA GPU.  This file imports no JAX, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(`--noconftest` because tests/conftest.py configures JAX.)  Limits per
precision mode, as max|kernel - plain| / max|plain|: float32 1e-5,
tensorfloat32 5e-3, bfloat16 2e-2.
"""
import hashlib

import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.ops import api
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

pytestmark = pytest.mark.cuda

LIMITS = {"float32": 1e-5, "tensorfloat32": 5e-3, "bfloat16": 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias,
          offscale, seed=0):
    rng = np.random.default_rng(seed)
    nd = len(S)
    spec = DeformConvSpec.make(nd, k, stride, pad, dil, g, dg,
                               modulated=modulated)
    OS = spec.out_sizes(S)
    K = spec.tap_count
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-offscale, offscale, (B, dg * nd * K) + OS),
            rng.uniform(0, 1, (B, dg * K) + OS) if modulated else None,
            rng.standard_normal((O, C // g) + spec.kernel) * 0.1,
            rng.standard_normal((O,)) if bias else None]
    return spec, [None if a is None else
                  torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in arrs]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# (B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias, offscale)
GENERAL = [
    (2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 2, True, True, 3.0),
    (1, 12, 70, (11, 13), 3, 2, 1, 1, 1, 3, False, True, 8.0),
    (2, 8, 8, (10, 10), (3, 1), 1, (2, 0), (2, 1), 2, 4, True, False, 1.0),
    (1, 256, 64, (9, 9), 5, 1, 2, 1, 4, 4, True, True, 2.0),
    # 5x5 taps at stride 2 and dilation 2, 24 channels over 3 deformable
    # groups, 70 output channels: no tile of the backward's products is full.
    (2, 24, 70, (17, 19), 5, 2, 4, 2, 1, 3, True, False, 3.0),
]
BOUNDED = [
    (2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 2, True, True, 3.0, 1.0),
    (1, 32, 70, (12, 17), 3, 1, 2, 2, 1, 2, False, True, 4.0, 1.5),
    (2, 256, 64, (9, 9), 5, 1, 2, 1, 4, 4, True, True, 2.0, 2.0),
    # no mask; 24 channels a conv group over deformable groups of 8.
    (1, 48, 24, (13, 11), 3, 1, 1, 1, 2, 6, False, False, 2.0, 1.5),
]


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", GENERAL)
def test_gathermm_kernel_matches_plain(dev, case, precision):
    spec, args = _case(dev, *case)
    before = lib.counts().launches
    got = gm.fused_fwd(*args, spec, precision)
    assert lib.counts().launches - before == {"gathermm_fwd": 1}
    want = gm.gathermm_fwd_reference(*args, spec, precision)
    assert _rel(got, want) <= LIMITS[precision]


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", BOUNDED)
def test_shiftblend_kernel_matches_plain(dev, case, precision):
    spec, args = _case(dev, *case[:-1])
    before = lib.counts().launches
    got = sb.fwd(*args, spec, precision, case[-1])
    assert lib.counts().launches - before == {"shiftblend_fwd": 1}
    want = sb.shiftblend_fwd_reference(*args, spec, precision, case[-1])
    assert _rel(got, want) <= LIMITS[precision]


# The 2D forwards' tiles (csrc/deform_fwd.cuh) left ragged: output
# channels a group that fill no 64-wide tile, or more than 256 of them (two
# blocks a position tile); channels a deformable group that are no multiple
# of 4 (the gather's 4-byte corner reads) or of 16 (the halo's 8-channel
# chunks); 169 taps (the corner table rebuilt across a chunk); halos whose
# two 8-channel buffers do not fit (corners from x in device memory).
# (..., bound) where the last entry is not None runs shiftblend_fwd.
FWD_RAGGED = [
    (2, 18, 70, (9, 11), 3, 1, 1, 1, 1, 3, True, True, 2.0, None),
    (1, 24, 300, (7, 6), 3, 1, 1, 1, 1, 1, True, True, 2.0, None),
    (1, 8, 8, (16, 15), 13, 1, 6, 1, 1, 1, True, True, 2.0, None),
    (1, 48, 100, (10, 9), 3, 1, 1, 1, 2, 2, True, True, 2.5, 2.0),
    (1, 16, 16, (10, 10), 3, 1, 18, 18, 1, 2, True, True, 1.2, 1.0),
    (1, 16, 16, (6, 7), 3, 1, 100, 100, 1, 1, True, True, 1.2, 1.0),
]


def _fwd_pair(bound):
    if bound is None:
        return gm.fused_fwd, gm.gathermm_fwd_reference, (), "gathermm_fwd"
    return sb.fwd, sb.shiftblend_fwd_reference, (bound,), "shiftblend_fwd"


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", FWD_RAGGED)
def test_fwd_ragged_tiles_match_plain(dev, case, precision):
    fwd, ref, extra, entry = _fwd_pair(case[-1])
    spec, args = _case(dev, *case[:-1])
    before = lib.counts().launches
    got = fwd(*args, spec, precision, *extra)
    assert lib.counts().launches - before == {entry: 1}
    assert _rel(got, ref(*args, spec, precision, *extra)) <= LIMITS[precision]


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("hw", [(16, 16), (14, 14), (10, 9)])
def test_shiftblend_fwd_both_routes_match_plain(dev, hw, precision):
    """Both routes of the 2D shift-blend forward, the halo tile and the
    corners from channels-last x, whichever halo_route would pick, on
    planes the 8 x 8 tiles fit and on ragged ones."""
    spec, args = _case(dev, 2, 64, 48, hw, 3, 1, 1, 1, 2, 2, True, True,
                       2.5)
    want = sb.shiftblend_fwd_reference(*args, spec, precision, 2.0)
    for halo in (True, False):
        got = sb.fwd(*args, spec, precision, 2.0, halo=halo)
        assert _rel(got, want) <= LIMITS[precision], halo


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("bound", [None, 2.0])
def test_fwd_config2_full_size(dev, bound, precision):
    """The bench's config 2: B=8, 256 -> 256, 56x56, 3x3, g = dg = 4."""
    fwd, ref, extra, _ = _fwd_pair(bound)
    spec, args = _case(dev, 8, 256, 256, (56, 56), 3, 1, 1, 1, 4, 4, True,
                       True, 2.0)
    got = fwd(*args, spec, precision, *extra)
    assert _rel(got, ref(*args, spec, precision, *extra)) <= LIMITS[precision]


# DCNResNet-50's DCN layers at B=8 (g = dg = 1, mask, no bias): c3's first,
# stride 2 from 56x56 to 28x28 over 128 channels, and a c5 layer, 512
# channels at 7x7: 392 positions, the contraction split over 19 parts.
RESNET_LAYERS = [
    (8, 128, 128, (56, 56), 3, 2, 1, 1, 1, 1, True, False, 2.0),
    (8, 512, 512, (7, 7), 3, 1, 1, 1, 1, 1, True, False, 2.0),
]


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", RESNET_LAYERS)
def test_fwd_resnet_layers_match_plain(dev, case, precision):
    spec, args = _case(dev, *case)
    got = gm.fused_fwd(*args, spec, precision)
    want = gm.gathermm_fwd_reference(*args, spec, precision)
    assert _rel(got, want) <= LIMITS[precision]


@pytest.mark.parametrize("precision", list(LIMITS))
def test_forward_bitwise_deterministic(dev, precision):
    """Two forward runs of each kernel give the same bits, the contraction
    split into parts (no atomics)."""
    spec, args = _case(dev, *RESNET_LAYERS[1])
    runs = [gm.fused_fwd(*args, spec, precision) for _ in range(2)]
    assert torch.equal(*runs)
    spec, args = _case(dev, *GENERAL[3])
    runs = [sb.fwd(*args, spec, precision, 2.0) for _ in range(2)]
    assert torch.equal(*runs)


def _grad_out(spec, x, w, seed=1):
    B = x.shape[0]
    OS = spec.out_sizes(x.shape[2:])
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((B, w.shape[0]) + OS),
                        dtype=torch.float32, device=x.device)


def _check_grads(got, want, limit):
    for name, g, r in zip(("x", "offset", "mask", "weight"), got, want):
        if r is None:
            assert g is None, name
            continue
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        assert _rel(g, r) <= limit, (name, _rel(g, r))


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", GENERAL)
def test_gathermm_bwd_kernel_matches_plain(dev, case, precision):
    spec, (x, off, mask, w, _) = _case(dev, *case)
    gout = _grad_out(spec, x, w)
    before = lib.counts().launches
    got = gm.fused_bwd(x, off, mask, w, gout, spec, precision)
    assert lib.counts().launches - before == {"gathermm_bwd": 1}
    want = gm.gathermm_bwd_reference(x, off, mask, w, gout, spec, precision)
    _check_grads(got, want, LIMITS[precision])


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", BOUNDED)
def test_shiftblend_bwd_kernel_matches_plain(dev, case, precision):
    spec, (x, off, mask, w, _) = _case(dev, *case[:-1])
    gout = _grad_out(spec, x, w)
    before = lib.counts().launches
    got = sb.bwd(x, off, mask, w, gout, spec, precision, case[-1])
    assert lib.counts().launches - before == {"shiftblend_bwd": 1}
    want = sb.shiftblend_bwd_reference(x, off, mask, w, gout, spec,
                                       precision, case[-1])
    _check_grads(got, want, LIMITS[precision])


@pytest.mark.parametrize("precision", ["tensorfloat32", "bfloat16"])
def test_backward_bitwise_deterministic(dev, precision):
    """Two backward runs of each kernel give the same bits (no atomics)."""
    spec, (x, off, mask, w, _) = _case(dev, *GENERAL[3])
    gout = _grad_out(spec, x, w)
    runs = [gm.fused_bwd(x, off, mask, w, gout, spec, precision)
            for _ in range(2)]
    runs += [sb.bwd(x, off, mask, w, gout, spec, precision, 2.0)
             for _ in range(2)]
    for a, b in ((runs[0], runs[1]), (runs[2], runs[3])):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def _bwd_pair(family):
    if family == "gathermm":
        return gm.fused_bwd, gm.gathermm_bwd_reference, GENERAL[0], ()
    return sb.bwd, sb.shiftblend_bwd_reference, BOUNDED[0][:-1], (
        BOUNDED[0][-1],)


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("needs", [(True, False, False, False),
                                   (False, False, False, True),
                                   (False, True, True, False)])
@pytest.mark.parametrize("family", ["gathermm", "shiftblend"])
def test_bwd_needs_subsets(dev, family, needs, precision):
    """Only the wanted gradients come back, each as the plain version's."""
    bwd, ref, case, extra = _bwd_pair(family)
    spec, (x, off, mask, w, _) = _case(dev, *case)
    gout = _grad_out(spec, x, w)
    got = bwd(x, off, mask, w, gout, spec, precision, *extra, needs=needs)
    want = ref(x, off, mask, w, gout, spec, precision, *extra)
    _check_grads(got, [r if n else None for r, n in zip(want, needs)],
                 LIMITS[precision])


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("family", ["gathermm", "shiftblend"])
def test_bwd_config2_full_size(dev, family, precision):
    """The bench's config 2: B=8, 256 -> 256, 56x56, 3x3, g = dg = 4."""
    bwd, ref, _, extra = _bwd_pair(family)
    spec, (x, off, mask, w, _) = _case(dev, 8, 256, 256, (56, 56), 3, 1, 1,
                                       1, 4, 4, True, False, 2.0)
    gout = _grad_out(spec, x, w)
    extra = (2.0,) if extra else ()
    _check_grads(bwd(x, off, mask, w, gout, spec, precision, *extra),
                 ref(x, off, mask, w, gout, spec, precision, *extra),
                 LIMITS[precision])


def test_auto_dispatch_and_raises(dev):
    spec, (x, off, mask, w, b) = _case(dev, *GENERAL[0])
    before = lib.counts().launches
    with torch.no_grad():
        out = mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, 2, 2,
                                          offset_bound=3.0)
        mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, 2, 2)
    launched = lib.counts().launches - before
    assert (launched["shiftblend_fwd"], launched["gathermm_fwd"]) == (1, 1)
    ref = mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, 2, 2,
                                      impl="torch")
    assert _rel(out, ref) <= LIMITS["tensorfloat32"]
    # The backward runs through the kernels and matches autograd of the
    # plain path, for all five inputs.
    for bound, kernel in ((3.0, "shiftblend_bwd"), (None, "gathermm_bwd")):
        grads = []
        for impl in ("auto", "torch"):
            ins = [t.clone().requires_grad_(True) for t in (x, off, mask, w,
                                                            b)]
            before = lib.counts().launches
            y = mdt.modulated_deform_conv2d(*ins, 1, 1, 1, 2, 2, impl=impl,
                                            offset_bound=bound)
            (y * y).sum().backward()
            assert ((lib.counts().launches - before)[kernel]
                    == (impl == "auto"))
            grads.append([t.grad for t in ins])
        for g, r in zip(*grads):
            assert _rel(g, r) <= LIMITS["tensorfloat32"]
    # gate_bounds take the gather kernel; shift-blend refuses them.
    gates = ((1.0, 15.0), (-1.0, 7.5))
    before = lib.counts().launches
    with torch.no_grad():
        out = api._dispatch(x, off, mask, w, b, spec, "auto",
                            gate_bounds=gates)
        ref = api._dispatch(x, off, mask, w, b, spec, "torch",
                            gate_bounds=gates)
    assert (lib.counts().launches - before)["gathermm_fwd"] == 1
    assert _rel(out, ref) <= LIMITS["tensorfloat32"]
    with pytest.raises(NotImplementedError, match="gate_bounds"):
        api._dispatch(x, off, mask, w, b, spec, "shiftblend",
                      offset_bound=3.0, gate_bounds=gates)
    with pytest.raises(ValueError, match="cpu"):
        gm.fused_fwd(x.detach(), off.cpu(), mask, w, b, spec)
    # A 3D call launches the 3D kernel.
    x3 = torch.ones((1, 8, 4, 4, 4), device=dev)
    before = lib.counts().launches
    with torch.no_grad():
        mdt.deform_conv3d(x3, torch.zeros((1, 81, 4, 4, 4), device=dev),
                          torch.ones((8, 8, 3, 3, 3), device=dev), None, 1, 1)
    assert (lib.counts().launches - before)["gathermm3d_fwd"] == 1


# 3D: (B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias, offscale),
# ragged 4 x 4 x 4 bricks, offsets far outside the volume, stride 2, no
# mask / bias, and deformable groups straddling conv groups; an unbounded
# 5 x 5 x 5 kernel, 10 channels a deformable group (no multiple of 4: the
# forward's and grad_W's 4-byte column builds) over 2 conv groups, stride 2
# with dilation 2, and a ragged 7 x 9 x 11 volume.
GENERAL3D = [
    (2, 16, 24, (5, 7, 6), 3, 1, 1, 1, 2, 2, True, True, 3.0),
    (1, 12, 8, (7, 9, 8), 3, 2, 1, 1, 1, 3, False, False, 2.0),
    (2, 16, 16, (5, 6, 7), 3, 1, 1, 1, 1, 2, True, True, 40.0),
    (1, 12, 10, (4, 5, 6), (3, 1, 3), 1, (1, 0, 1), 1, 2, 3, True, False,
     2.5),
    (1, 16, 24, (6, 9, 10), 5, 1, 2, 1, 1, 1, True, True, 2.0),
    (2, 40, 24, (5, 7, 6), 3, 1, 1, 1, 2, 4, True, True, 2.5),
    (1, 16, 16, (9, 10, 11), 3, 2, 2, 2, 1, 1, True, True, 2.0),
    (2, 8, 12, (7, 9, 11), 3, 1, 1, 1, 1, 1, True, False, 1.5),
]
# ... plus the bound: beyond it, the loop path's 128-aligned planes, 2 x 2 x
# 2 taps at 0.5 (at most 640 pairs), and dg > 1 with groups > 1; a 5 x 5 x 5
# kernel (125 taps: the corner table spans a few of them), bound 3 (a
# window of 7, each tap's pull reach 10 positions an axis), 256 channels a
# deformable group, 8 channels a deformable group over 4 of them and 2
# conv groups, a ragged 7 x 9 x 11 volume (at most 640 pairs: bound 0 on
# one axis), a per-axis bound, and no mask.
BOUNDED3D = [
    (2, 16, 24, (5, 64, 6), 3, 1, 1, 1, 2, 2, True, True, 2.5, 2.0),
    (1, 16, 16, (6, 8, 16), 3, 1, 2, 2, 1, 2, False, False, 3.0, 1.0),
    (2, 32, 32, (4, 9, 7), 2, 1, 1, 2, 1, 1, True, True, 0.45, 0.5),
    (1, 32, 48, (5, 16, 8), 3, 1, 1, 1, 2, 4, True, True, 1.5, 1.5),
    (1, 16, 24, (5, 8, 16), 5, 1, 2, 1, 1, 1, True, True, 1.3, 1.0),
    (1, 16, 16, (6, 8, 16), 3, 1, 1, 1, 1, 1, True, True, 3.5, 3.0),
    (1, 256, 64, (4, 8, 16), 3, 1, 1, 1, 1, 1, True, False, 2.5, 2.0),
    (2, 32, 24, (4, 8, 16), 3, 1, 1, 1, 2, 4, True, True, 2.5, 2.0),
    (1, 16, 24, (7, 9, 11), 3, 1, 1, 1, 1, 1, True, True, 0.6,
     (0.5, 0.0, 0.5)),
    (1, 16, 16, (4, 8, 16), 3, 1, 1, 1, 1, 1, True, True, 2.2,
     (2.0, 1.0, 1.5)),
    (1, 16, 16, (4, 8, 16), 3, 1, 1, 1, 1, 2, False, True, 2.5, 2.0),
]


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", GENERAL3D)
def test_gathermm3d_kernels_match_plain(dev, case, precision):
    spec, (x, off, mask, w, b) = _case(dev, *case)
    gout = _grad_out(spec, x, w)
    before = lib.counts().launches
    got = gm.fused_fwd(x, off, mask, w, b, spec, precision)
    grads = gm.fused_bwd(x, off, mask, w, gout, spec, precision)
    assert lib.counts().launches - before == {"gathermm3d_fwd": 1,
                                              "gathermm3d_bwd": 1}
    want = gm.gathermm_fwd_reference(x, off, mask, w, b, spec, precision)
    assert _rel(got, want) <= LIMITS[precision]
    _check_grads(grads, gm.gathermm_bwd_reference(
        x, off, mask, w, gout, spec, precision), LIMITS[precision])


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", BOUNDED3D)
def test_shiftblend3d_kernels_match_plain(dev, case, precision):
    spec, (x, off, mask, w, b) = _case(dev, *case[:-1])
    bound = case[-1]
    gout = _grad_out(spec, x, w)
    before = lib.counts().launches
    got = sb.fwd(x, off, mask, w, b, spec, precision, bound)
    grads = sb.bwd(x, off, mask, w, gout, spec, precision, bound)
    assert lib.counts().launches - before == {"shiftblend3d_fwd": 1,
                                              "shiftblend3d_bwd": 1}
    want = sb.shiftblend_fwd_reference(x, off, mask, w, b, spec, precision,
                                       bound)
    assert _rel(got, want) <= LIMITS[precision]
    _check_grads(grads, sb.shiftblend_bwd_reference(
        x, off, mask, w, gout, spec, precision, bound), LIMITS[precision])


@pytest.mark.parametrize("precision", list(LIMITS))
def test_shiftblend3d_config4_full_size(dev, precision):
    """BASELINE config 4 at B=1 (its plain versions hold a sample's columns
    at once): 128 -> 128, 32 x 64 x 64, 3 x 3 x 3, bound 2, in_step 2."""
    spec, (x, off, mask, w, _) = _case(dev, 1, 128, 128, (32, 64, 64), 3, 1,
                                       1, 1, 1, 1, True, False, 2.0)
    spec = DeformConvSpec.make(3, 3, 1, 1, 1, 1, 1, 2, True)
    gout = _grad_out(spec, x, w)
    got = sb.fwd(x, off, mask, w, None, spec, precision, 2.0)
    want = sb.shiftblend_fwd_reference(x, off, mask, w, None, spec,
                                       precision, 2.0)
    assert _rel(got, want) <= LIMITS[precision]
    del got, want
    _check_grads(sb.bwd(x, off, mask, w, gout, spec, precision, 2.0),
                 sb.shiftblend_bwd_reference(x, off, mask, w, gout, spec,
                                             precision, 2.0),
                 LIMITS[precision])


@pytest.mark.parametrize("precision", list(LIMITS))
def test_gathermm3d_config3_full_size(dev, precision):
    """BASELINE config 3: B=2, 64 -> 64, 16 x 32 x 32, 3 x 3 x 3, no mask,
    offsets U[-2, 2], through the gather pair."""
    spec, (x, off, _, w, _) = _case(dev, 2, 64, 64, (16, 32, 32), 3, 1, 1, 1,
                                    1, 1, False, False, 2.0)
    gout = _grad_out(spec, x, w)
    got = gm.fused_fwd(x, off, None, w, None, spec, precision)
    want = gm.gathermm_fwd_reference(x, off, None, w, None, spec, precision)
    assert _rel(got, want) <= LIMITS[precision]
    _check_grads(gm.fused_bwd(x, off, None, w, gout, spec, precision),
                 gm.gathermm_bwd_reference(x, off, None, w, gout, spec,
                                           precision), LIMITS[precision])


# DCNVideoNet's DCN layers at B=8 (width 32, 16 x 112 x 112 clips): s1b0, 64
# channels at 16 x 56 x 56, and s2b0, 128 channels at 16 x 28 x 28; 3 x 3 x
# 3, g = dg = 1, mask, no bias.
VIDEO_LAYERS = [
    (8, 64, 64, (16, 56, 56), 3, 1, 1, 1, 1, 1, True, False, 1.0),
    (8, 128, 128, (16, 28, 28), 3, 1, 1, 1, 1, 1, True, False, 1.0),
]


@pytest.mark.parametrize("case", VIDEO_LAYERS)
def test_gathermm3d_videonet_layers_match_plain(dev, case):
    spec, (x, off, mask, w, _) = _case(dev, *case)
    gout = _grad_out(spec, x, w)
    with torch.no_grad():
        got = gm.fused_fwd(x, off, mask, w, None, spec)
        assert _rel(got, gm.gathermm_fwd_reference(
            x, off, mask, w, None, spec)) <= LIMITS["tensorfloat32"]
        del got
        _check_grads(gm.fused_bwd(x, off, mask, w, gout, spec),
                     gm.gathermm_bwd_reference(x, off, mask, w, gout, spec),
                     LIMITS["tensorfloat32"])


def shiftblend3d_bwd_digest(dev, precision):
    """SHA-256 of the four gradients of `sb.bwd` (3D) on two BOUNDED3D
    cases (dg > 1 over 2 conv groups, and a 5 x 5 x 5 kernel) with in_step
    1, so that the pull runs once per sample."""
    h = hashlib.sha256()
    for case in (BOUNDED3D[7], BOUNDED3D[4]):
        spec, (x, off, mask, w, _) = _case(dev, *case[:-1])
        spec = DeformConvSpec.make(3, spec.kernel, 1, spec.padding,
                                   spec.dilation, spec.groups,
                                   spec.deformable_groups, 1, True)
        for g in sb.bwd(x, off, mask, w, _grad_out(spec, x, w), spec,
                        precision, case[-1]):
            h.update(g.cpu().numpy().tobytes())
    return h.hexdigest()


# shiftblend3d_bwd_digest of the kernels before their pull became a callable
# of run_bwd3d, built by nvcc for sm_90a and run on an NVIDIA H100 80GB HBM3
# (nvcc 12.9): the same bits in every mode.
SHIFTBLEND3D_BWD_DIGESTS = {
    "float32":
        "eb2bf11b3223ff2b5d0723952e9f579b2367b915555f087a21123e91b66fb9e6",
    "tensorfloat32":
        "96c214427f8319544b12c380b59a34456507d036df4afe878328af621e3edcd6",
    "bfloat16":
        "2bb1e3c5974aafa1c41811f98aeaebd308305d7366e698d8cca2dd47bec43840",
}


@pytest.mark.parametrize("precision", list(LIMITS))
def test_shiftblend3d_bwd_bits_unchanged(dev, precision):
    """The bounded 3D backward gives the same bits as before its pull
    became a callable shared with the gather's backward."""
    assert shiftblend3d_bwd_digest(dev, precision) == \
        SHIFTBLEND3D_BWD_DIGESTS[precision]


def test_backward3d_bitwise_deterministic_and_batch_chunked(dev):
    """Two 3D backward runs give the same bits, and in_step (the batch
    chunk of gcols) does not change them."""
    case = (4, 32, 32, (6, 8, 16), 3, 1, 1, 1, 1, 1, True, True, 1.8)
    runs = {}
    for in_step in (64, 2, 1):
        spec, (x, off, mask, w, _) = _case(dev, *case)
        spec = DeformConvSpec.make(3, 3, 1, 1, 1, 1, 1, in_step, True)
        gout = _grad_out(spec, x, w)
        runs[in_step] = [gm.fused_bwd(x, off, mask, w, gout, spec),
                         sb.bwd(x, off, mask, w, gout, spec,
                                "tensorfloat32", 2.0)]
    again = [gm.fused_bwd(x, off, mask, w, gout, spec),
             sb.bwd(x, off, mask, w, gout, spec, "tensorfloat32", 2.0)]
    for got in [again] + [runs[s] for s in (64, 2)]:
        for a, b in zip(got, runs[1]):
            assert all(torch.equal(u, v) for u, v in zip(a, b))


# The column kernels (the unfused path): (B, C, O, S, k, stride, pad, dil,
# g, dg, modulated, bias, offscale).  Conv groups straddling the
# deformable slab (g > dg), unmasked, stride 2 with offsets far outside the
# input, and a 3D pair; O and bias matter only to the op.
COLUMNS = [
    (2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 1, True, True, 3.0),
    (1, 12, 8, (11, 13), 3, 2, 1, 1, 1, 3, False, False, 8.0),
    (2, 32, 32, (7, 7), 3, 1, 1, 1, 1, 1, True, True, 40.0),
    (2, 16, 24, (5, 7, 6), 3, 1, 1, 1, 2, 1, True, True, 3.0),
    (1, 12, 8, (7, 9, 8), 3, 2, 1, 1, 1, 3, False, False, 2.0),
    # Planes of several input tiles (cols_bwd_plan: 8 x 16 pixels, 4 x 4 x 8
    # voxels), channels a deformable group not a multiple of the 32 a pull
    # block takes (12, 20), several correlation chunks (1024 channels), an
    # unbounded 5x5x5 kernel and stride 2 with dilation 2 in 3D.
    (1, 12, 8, (40, 36), 3, 1, 1, 1, 2, 1, True, True, 3.0),
    (2, 40, 16, (23, 19), 5, 2, 2, 2, 1, 2, True, False, 2.5),
    (1, 1024, 64, (5, 6), 3, 1, 1, 1, 1, 1, True, True, 2.0),
    (1, 8, 8, (6, 7, 9), 5, 1, 2, 1, 1, 1, True, True, 3.0),
    (2, 12, 8, (9, 10, 11), 3, 2, 2, 2, 1, 2, True, True, 2.0),
]


def _cols_entries(spec):
    """The C entries of the column pair at the spec's rank."""
    d = "" if spec.ndim == 2 else "3d"
    return f"gathermm{d}_cols_fwd", f"gathermm{d}_cols_bwd"


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", COLUMNS)
def test_column_kernels_match_plain(dev, case, precision):
    spec, (x, off, mask, _, _) = _case(dev, *case)
    before = lib.counts().launches
    got = gm.cols_fwd(x, off, mask, spec, precision)
    want = gm.gathermm_cols_reference(x, off, mask, spec, precision)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got.float(), want.float()) <= LIMITS[precision]
    rng = np.random.default_rng(3)
    gcols = torch.tensor(rng.standard_normal(tuple(got.shape)),
                         dtype=got.dtype, device=dev)
    grads = gm.cols_bwd(x, off, mask, gcols, spec, precision)
    assert lib.counts().launches - before == dict.fromkeys(
        _cols_entries(spec), 1)
    _check_grads(grads, gm.gathermm_cols_bwd_reference(
        x, off, mask, gcols, spec, precision), LIMITS[precision])


def _op(spec, ins, **kw):
    x, off, mask, w, b = ins
    fn = {2: mdt.modulated_deform_conv2d, 3: mdt.modulated_deform_conv3d}
    return fn[spec.ndim](x, off, mask, w, b, spec.stride, spec.padding,
                         spec.dilation, spec.groups, spec.deformable_groups,
                         **kw)


@pytest.mark.parametrize("case", [COLUMNS[0], COLUMNS[3]])
def test_columns_path_against_fused_pair_and_repeatable(dev, case):
    """Under "auto" a grouped config (g > dg) takes the column kernels and
    the grouped product; its output and five gradients agree with the fused
    pair's on the same inputs, in "float32" even with the global TF32 flag
    on, and two backward runs give the same bits."""
    spec, ins = _case(dev, *case)
    fwd, bwd = _cols_entries(spec)
    fused_bwd = "gathermm_bwd" if spec.ndim == 2 else "gathermm3d_bwd"
    gout = _grad_out(spec, ins[0], ins[3])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            before = lib.counts().launches
            out = _op(spec, leaves, precision="float32")
            out.backward(gout)
            launched = lib.counts().launches - before
            assert (launched[fwd], launched[bwd], launched[fused_bwd]) == (
                1, 1, 0)
            runs.append([out.detach()] + [t.grad for t in leaves])
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    x, off, mask, w, b = leaves
    out = gm._GathermmFwd.apply(x, off, mask, w, b, spec, "float32")
    out.backward(gout)
    for got, want in zip(runs[0], [out.detach()] + [t.grad for t in leaves]):
        assert _rel(got, want) <= LIMITS["float32"]


@pytest.mark.parametrize("case", [COLUMNS[5], COLUMNS[8], COLUMNS[9]])
def test_column_backward_bitwise_deterministic_and_in_step_free(dev, case):
    """Two runs of the column backward give the same bits, in every mode,
    and the spec's in_step (which batch-chunks the fused 3D backward) does
    not change them: the column kernels take the whole batch at once."""
    spec, (x, off, mask, _, _) = _case(dev, *case)
    bwd = gm.cols_bwd
    for precision in LIMITS:
        cols = gm.gathermm_cols_reference(x, off, mask, spec, precision)
        rng = np.random.default_rng(4)
        gcols = torch.tensor(rng.standard_normal(tuple(cols.shape)),
                             dtype=cols.dtype, device=dev)
        first = bwd(x, off, mask, gcols, spec, precision)
        stepped = DeformConvSpec.make(
            spec.ndim, spec.kernel, spec.stride, spec.padding, spec.dilation,
            spec.groups, spec.deformable_groups, 1, spec.modulated)
        for got in (bwd(x, off, mask, gcols, spec, precision),
                    bwd(x, off, mask, gcols, stepped, precision)):
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(first, got))


# The column forward's two routes (gathermm.cols_fwd_plan): the plane route
# stages each block's corner box of x in shared memory, the gather route
# reads the corners from x.  (B, C, O, S, k, stride, pad, dil, g, dg,
# modulated, bias, offscale), as COLUMNS.
COLS_FWD_EXTRA = [
    # B * P odd (3 x 63), 18 channels: ragged ends of the vector stores.
    (3, 18, 8, (7, 9), 3, 1, 1, 1, 1, 1, True, False, 2.0),
    # 6 channels a deformable group: C / dg not a multiple of 4.
    (2, 30, 10, (9, 11), 3, 1, 1, 1, 1, 5, True, True, 3.0),
    # The largest plane the plane route takes (51,200 pixels), one past it.
    (1, 3, 3, (200, 256), 3, 1, 1, 1, 1, 1, True, False, 2.0),
    (1, 3, 3, (200, 257), 3, 1, 1, 1, 1, 1, True, False, 2.0),
]
# A 3D case whose offsets at eight positions of one output row reach 7,
# 14 and 10 voxels (z, y, x) inside the volume: the corner box of the block
# holding them passes its slot of shared memory, and that block reads its
# corners from x.
FAR_BOX_3D = (1, 4, 4, (16, 32, 32), 3, 1, 1, 1, 1, 1, True, True, 1.5)
FAR_OFFSET = (-7.0, 14.0, 10.0)


def _far_box_case(dev):
    spec, ins = _case(dev, *FAR_BOX_3D)
    off = ins[1].view(1, spec.tap_count, 3, 16, 32, 32)
    off[:, :, :, 9, 4, 8:16] = torch.tensor(FAR_OFFSET, device=dev).view(
        1, 1, 3, 1)
    return spec, ins


def _cols_fwd_cases(dev):
    """(spec, x, offset, mask) of every column-forward case the card tests
    hold to recorded bits: COLUMNS, COLS_FWD_EXTRA, FAR_BOX_3D."""
    cases = [_case(dev, *c) for c in COLUMNS + COLS_FWD_EXTRA]
    cases.append(_far_box_case(dev))
    return [(spec, *ins[:3]) for spec, ins in cases]


def cols_fwd_digest(dev, precision):
    """SHA-256 of the columns `gm.cols_fwd` gives on every case of
    _cols_fwd_cases."""
    h = hashlib.sha256()
    for spec, x, off, mask in _cols_fwd_cases(dev):
        cols = gm.cols_fwd(x, off, mask, spec, precision)
        h.update(cols.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


# cols_fwd_digest of the column forward kernels before their two routes
# (one thread per (sample, group, tap, position), 32 channels a block),
# built by nvcc 12.9 for sm_90a and run on an NVIDIA H100 80GB HBM3: fp32
# columns in "float32" and "tensorfloat32", bf16 in "bfloat16".
COLS_FWD_DIGESTS = {
    "float32":
        "889c278bb8ee608132066f27438f1fc0b1b4c171c81ffcef851cb6b5af0e3e1b",
    "tensorfloat32":
        "889c278bb8ee608132066f27438f1fc0b1b4c171c81ffcef851cb6b5af0e3e1b",
    "bfloat16":
        "22553eb4b68dcb5409435705098c7084d998bdc8bd072f7873665fd26234019c",
}


@pytest.mark.parametrize("precision", list(LIMITS))
def test_column_fwd_bits_unchanged(dev, precision):
    """The column forward, on the routes cols_fwd_plan picks, gives the
    bits the kernels gave before the routes, on every case."""
    assert cols_fwd_digest(dev, precision) == COLS_FWD_DIGESTS[precision]


def _cols_fwd_routes(spec, x):
    """The routes the column forward's shapes admit."""
    routes = ["gather"]
    try:
        gm.cols_fwd_plan(spec, x.shape[2:], spec.out_sizes(x.shape[2:]),
                         x.shape[0], x.shape[1], "plane")
        routes.append("plane")
    except ValueError:
        pass
    return routes


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", COLUMNS + COLS_FWD_EXTRA + ["far box"])
def test_column_fwd_routes_same_bits(dev, case, precision):
    """Every route a case's shapes admit gives the same bits, within the
    mode's limit of the plain version; the plane route takes each case but
    the plane one past its largest."""
    spec, (x, off, mask, _, _) = (_far_box_case(dev) if case == "far box"
                                  else _case(dev, *case))
    routes = _cols_fwd_routes(spec, x)
    assert ("plane" in routes) == (x[0, 0].numel() <= 51200)
    want = gm.gathermm_cols_reference(x, off, mask, spec, precision)
    got = {r: gm.cols_fwd(x, off, mask, spec, precision, route=r)
           for r in routes}
    for r, cols in got.items():
        assert cols.dtype == want.dtype and cols.shape == want.shape, r
        assert _rel(cols.float(), want.float()) <= LIMITS[precision], r
    assert torch.equal(got["gather"], got.get("plane", got["gather"]))


@pytest.mark.parametrize("route", ["plane", "gather"])
def test_column_fwd_repeatable(dev, route):
    """Two launches of either route give the same bits, 2D and 3D, fp32 and
    bf16 columns."""
    for case in (COLUMNS[2], COLS_FWD_EXTRA[0], COLUMNS[8]):
        spec, (x, off, mask, _, _) = _case(dev, *case)
        for precision in ("float32", "bfloat16"):
            runs = [gm.cols_fwd(x, off, mask, spec, precision, route=route)
                    for _ in range(2)]
            assert torch.equal(*runs)
