"""GroupNorm with its epilogue (csrc/groupnorm.cu, ops/cuda/groupnorm.py) on
the card.

Marked `cuda`: each test skips without an NVIDIA GPU.  Imports no JAX:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_groupnorm_cuda.py -q

* the kernels against the plain version in float64 at every GroupNorm
  layer shape of the benchmark's three cells (DCNResNet-50 at B=8 and B=1,
  DCNResNet3d-50 at B=32: the 3D stem's 100,352-value groups, serving's
  c5 groups), with each layer's ReLU and residual add, on the plan's route
  (one pass) and on a forced re-reading route, in float32 and bfloat16,
  forward (y, mean, rstd) and backward (dx, dgamma, dbeta, d_identity);
* two calls, and two replays of a captured call, give the same bits;
* captured training steps of DCNResNet-50 (B=8) and DCNResNet3d-50 (B=32)
  hold 40 launches of each kernel over the values their shapes give and
  no torch GroupNorm kernel (torch.profiler on a replay); a captured
  serving forward (B=1) holds 40 forward launches;
* what the kernels do not take raises on CUDA tensors, from the wrappers
  and from `group_norm_act`, the op the backbone calls; in float64 the op
  is torch's.
"""
import math

import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer, train_step)
from modulated_deform_conv_tpu_torch.ops.cuda import groupnorm as gn
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda

EPS = 1e-6
# Kernel against the plain version in float64 on the same inputs, as
# max|difference| over the output's largest magnitude: float32's rounding
# in sums of up to 100,352 values; bfloat16's rounding of each output
# (2**-8 of it).  dx is held against the scale of its largest term,
# rstd * |gamma| * |dz|, since its terms cancel in small groups.
LIMITS = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# dgamma and dbeta are summed in float32 from the inputs as they are.
PARAM_LIMIT = 2e-5
CELLS = {"r50-imagenet-train": (lambda d: mdt.DCNResNet(device=d),
                                (8, 3, 224, 224)),
         "r50-imagenet-infer-b1": (lambda d: mdt.DCNResNet(device=d),
                                   (1, 3, 224, 224)),
         "r3d50-k400-train": (lambda d: mdt.DCNResNet3d(device=d),
                              (32, 3, 16, 112, 112))}
# torch's GroupNorm kernels, forward and backward.
TORCH_NORM = ("RowwiseMoments", "ComputeFusedParams", "GroupNorm",
              "ComputeInternalGradients", "GammaBeta", "group_norm")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    yield torch.device("cuda", torch.cuda.current_device())


def _layers(cell):
    """The distinct (x's shape, groups, identity, relu) of a cell's norms,
    from its network on meta tensors."""
    make, shape = CELLS[cell]
    return sorted(set(gn.norm_calls(make("meta"), shape)))


LAYERS = [(cell,) + layer for cell in sorted(CELLS) for layer in _layers(cell)]


def _inputs(shape, G, identity, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = (t(*shape) * 1.5 + 0.3).to(dtype)
    w, b = t(shape[1]), t(shape[1])
    idt = t(*shape).to(dtype) if identity else None
    dy = t(*shape).to(dtype)
    return x, w, b, idt, dy


def _rel(got, want, scale=None):
    got, want = got.double(), want.double()
    den = want.abs().max() if scale is None else scale
    return float((got - want).abs().max() / max(float(den), 1e-30))


def _forced_route(shape, G, itemsize, arrays):
    """The plan's cluster with passes of a quarter of its slice: the
    re-reading route."""
    N, C = shape[:2]
    L = C // G * math.prod(shape[2:])
    k, sl, _ = gn.plan(N, G, L, itemsize, arrays,
                       gn.card_of(torch.device("cuda")))
    return k, sl, max(gn.VEC, sl // 4 // gn.VEC * gn.VEC)


def _check_against_plain(x, w, b, idt, dy, G, relu, route_fwd, route_bwd):
    y, mean, rstd = gn.groupnorm_fwd(x, G, w, b, EPS, idt, relu,
                                     route=route_fwd)
    y64, m64, r64 = gn.group_norm_reference(
        x.double(), G, w.double(), b.double(), EPS,
        None if idt is None else idt.double(), relu)
    lim = LIMITS[x.dtype]
    assert _rel(y, y64) <= lim, ("y", _rel(y, y64))
    assert _rel(mean, m64) <= PARAM_LIMIT and _rel(rstd, r64) <= PARAM_LIMIT
    dx, dgamma, dbeta, did = gn.groupnorm_bwd(dy, x, y, mean, rstd, w, G,
                                              relu, idt is not None,
                                              route=route_bwd)
    # The plain backward with the ReLU's mask of the kernel's own y, the
    # y its backward reads.
    dx64, dg64, db64, did64 = gn.group_norm_backward_reference(
        dy.double(), x.double(), y, w.double(), G, EPS, relu,
        idt is not None)
    scale = float(rstd.max()) * float(w.abs().max()) * float(dy.abs().max())
    assert _rel(dx, dx64, scale) <= lim, ("dx", _rel(dx, dx64, scale))
    assert _rel(dgamma, dg64) <= PARAM_LIMIT, ("dgamma", _rel(dgamma, dg64))
    assert _rel(dbeta, db64) <= PARAM_LIMIT, ("dbeta", _rel(dbeta, db64))
    if idt is not None:
        assert torch.equal(did, did64.to(did.dtype)), "d_identity"
    return y, dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("cell,shape,G,identity,relu", LAYERS)
def test_kernels_match_plain_at_the_cells_layers(dev, cell, shape, G,
                                                 identity, relu, dtype):
    ins = _inputs(shape, G, identity, dtype, dev, seed=len(shape) + G)
    before = lib.counts().launches
    _check_against_plain(*ins, G, relu, None, None)
    launched = lib.counts().launches - before
    assert (launched["groupnorm_fwd"], launched["groupnorm_bwd"]) == (1, 1)
    # The re-reading route, every pass a quarter of the slice.
    item = ins[0].element_size()
    _check_against_plain(*ins, G, relu, _forced_route(shape, G, item, 1),
                         _forced_route(shape, G, item, 2))


# Shapes with clusters of 1, 2, 4 and 8 blocks, and a plane of 7 x 7 that
# no vector divides (the one-value path).
BITS_CASES = [((8, 256, 56, 56), 32), ((32, 64, 16, 56, 56), 32),
              ((1, 2048, 7, 7), 32), ((2, 6, 7, 7), 3)]


@pytest.mark.parametrize("shape,G", BITS_CASES)
def test_two_calls_and_two_replays_give_the_same_bits(dev, shape, G):
    x, w, b, idt, dy = _inputs(shape, G, True, torch.float32, dev, seed=5)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b, idt)]

    def step(x, w, b, idt):
        y = gn.group_norm_act(x, G, w, b, EPS, idt, relu=True)
        return (y.detach(),) + torch.autograd.grad(y, (x, w, b, idt), dy)

    first, second = step(*ins), step(*ins)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    captured = graphs.capture(step, *ins)
    assert captured.kernels == {"groupnorm_fwd": 1, "groupnorm_bwd": 1}
    one = [t.clone() for t in captured(*ins)]
    two = captured(*ins)
    assert all(torch.equal(a, c) for a, c in zip(one, two))
    assert all(torch.equal(a, c) for a, c in zip(one, first))


def _torch_norm_kernels(fn):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("gn_fwd_kernel" in n for n in names), names
    return [n for n in names if any(t in n for t in TORCH_NORM)]


@pytest.mark.parametrize("cell,values", [("r50-imagenet-train", 82_690_048),
                                         ("r3d50-k400-train", 524_140_544)])
def test_captured_training_step_runs_every_norm_on_the_kernels(dev, cell,
                                                               values):
    make, shape = CELLS[cell]
    torch.manual_seed(0)
    net = make(dev)
    opt = make_optimizer(net)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev)
    y = torch.randint(0, net.fc.out_features, (shape[0],), generator=g,
                      device=dev)
    step = graphs.capture(lambda a, b: train_step(net, opt, a, b), x, y)
    assert step.kernels["groupnorm_fwd"] == 40
    assert step.kernels["groupnorm_bwd"] == 40
    assert step.values["groupnorm_fwd"] == values
    assert not _torch_norm_kernels(lambda: step(x, y))
    losses = [step.read(step(x, y)) for _ in range(2)]
    assert all(map(math.isfinite, losses))


def test_captured_serving_forward_runs_every_norm_on_the_kernel(dev):
    make, shape = CELLS["r50-imagenet-infer-b1"]
    net = make(dev)
    x = torch.randn(shape, device=dev)

    def forward(a):
        with torch.no_grad():
            return net(a)

    step = graphs.capture(forward, x)
    assert step.kernels["groupnorm_fwd"] == 40
    assert "groupnorm_bwd" not in step.kernels
    assert step.values["groupnorm_fwd"] == 10_336_256
    assert not _torch_norm_kernels(lambda: step(x))
    assert torch.equal(step(x), forward(x))


@pytest.mark.parametrize("case", ["float16", "strided", "identity_type",
                                  "weight_type", "groups"])
def test_refuses_what_the_kernels_do_not_take(dev, case):
    x = torch.randn(2, 8, 6, 6, device=dev)
    w, b, idt = torch.ones(8, device=dev), torch.zeros(8, device=dev), None
    G, error = 4, ValueError
    if case == "float16":
        x, error = x.half(), TypeError
    elif case == "strided":
        x = x.transpose(2, 3)
    elif case == "identity_type":
        idt = torch.zeros_like(x, dtype=torch.bfloat16)
    elif case == "weight_type":
        w = w.double()
    else:
        G = 3
    before = lib.counts()
    with pytest.raises(error, match="groupnorm_fwd"):
        gn.groupnorm_fwd(x, G, w, b, EPS, idt)
    assert lib.counts() == before


@pytest.mark.parametrize("case", ["float16", "identity_type",
                                  "identity_shape", "groups"])
def test_op_raises_where_the_kernels_do_not_take(dev, case):
    """`group_norm_act` on CUDA tensors runs the kernels or raises: it
    never falls back to torch's ops."""
    x = torch.randn(2, 8, 6, 6, device=dev)
    w, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    idt, G, error = torch.zeros_like(x), 4, ValueError
    if case == "float16":
        x, idt, error = x.half(), idt.half(), TypeError
    elif case == "identity_type":
        idt = idt.to(torch.bfloat16)
    elif case == "identity_shape":
        idt = idt[:1]
    else:
        G = 3
    before = lib.counts()
    with pytest.raises(error, match="groupnorm_fwd"):
        gn.group_norm_act(x, G, w, b, EPS, idt, relu=True)
    assert lib.counts() == before


def test_op_in_float64_is_torchs(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x, idt = (torch.randn(2, 8, 6, 6, generator=g, device=dev,
                          dtype=torch.float64) for _ in range(2))
    w, b = (torch.randn(8, generator=g, device=dev, dtype=torch.float64)
            for _ in range(2))
    before = lib.counts()
    got = gn.group_norm_act(x, 4, w, b, EPS, idt, relu=True)
    want = torch.relu(torch.nn.functional.group_norm(x, 4, w, b, EPS) + idt)
    assert torch.equal(got, want)
    assert lib.counts() == before
