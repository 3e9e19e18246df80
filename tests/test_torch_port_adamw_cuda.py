"""The one-pass AdamW kernel (csrc/adamw.cu, ops/cuda/adamw.py) on the card.

Marked `cuda`: each test skips without an NVIDIA GPU.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_adamw_cuda.py -q

* the kernel on DCNResNet-50's 187 leaves (26.4 M values), three eager
  steps in float32 and bfloat16, against its plain version on CPU copies
  and against torch.optim.AdamW(capturable=True); the same leaves as
  misaligned views (the kernel's one-value path);
* `opt.step()` captured and replayed three times, bit-equal to three eager
  kernel steps, the graph holding one launch over every value;
* the launches a step: one for the 187 leaves, one a type, and more only
  past the kernel's table of leaves;
* a captured training step runs the kernel and no foreach or fused
  library optimizer kernel (torch.profiler on a replay);
* the types and layouts the kernel does not take raise on CUDA tensors.
"""
import math

import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import train
from modulated_deform_conv_tpu_torch.ops.cuda import adamw
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda

STEPS, LR, WD = 3, 1e-3, 1e-4
# The most an update moves a value in the first steps: lr |m^| / sqrt(v^)
# stays below 2 lr there.
UPDATE = 2 * LR
# The kernel against its plain version: the same arithmetic, rounded at
# other places (the card contracts multiply-adds): a few units in the last
# place of the value and of the update a step.  torch's bfloat16 path
# rounds every op; torch's capturable float32 path takes 1 - beta^t from a
# float32 beta, off by up to 1.3e-5 of 1 - 0.999: up to 2e-5 of the update
# a step.
TOL = {torch.float32: 2.0 ** -21, torch.bfloat16: 2.0 ** -7}
TORCH_F32_UPDATE = 2.0 ** -15 * UPDATE


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    yield torch.device("cuda", torch.cuda.current_device())


def _shapes():
    net = mdt.DCNResNet(num_classes=1000, width=64, device="meta")
    return [tuple(p.shape) for p in net.parameters()]


def _values(shapes, dtype, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=gen) * scale).to(dtype)
            for s in shapes]


def _close(got, want, rel, absolute=0.0):
    got, want = got.double().cpu(), want.double().cpu()
    worst = float(((got - want).abs() - rel * want.abs() - absolute).max())
    assert worst <= 0, f"off by {worst:.3e} past the bound"


def _as_views(ts):
    """Each tensor as a view one value into a larger buffer: not 16-byte
    aligned."""
    out = []
    for t in ts:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


def _leaf(t):
    return t.detach().clone().requires_grad_()


@pytest.mark.parametrize("layout", ["leaves", "views"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_and_torch(dev, dtype, layout):
    shapes = _shapes()
    start = [t.to(dev) for t in _values(shapes, dtype, 0, 0.05)]
    if layout == "views":
        start = _as_views(start)
    kern = [t.requires_grad_() for t in start] if layout == "views" else \
        [_leaf(t) for t in start]
    plain = [_leaf(t.cpu()) for t in start]
    lib_ = [_leaf(t) for t in start]
    opts = (adamw.AdamW(kern, lr=LR, weight_decay=WD, capturable=True),
            adamw.AdamW(plain, lr=LR, weight_decay=WD),
            torch.optim.AdamW(lib_, lr=LR, weight_decay=WD, capturable=True))
    before = lib.counts()
    for k in range(STEPS):
        grads = _values(shapes, dtype, 100 + k)
        for leaves in (kern, plain, lib_):
            for p, g in zip(leaves, grads):
                p.grad = g.to(p.device)
        if layout == "views":
            for p in kern:
                p.grad = _as_views([p.grad])[0]
        for opt in opts:
            opt.step()
    torch.cuda.synchronize(dev)
    total = sum(math.prod(s) for s in shapes)
    after = lib.counts()
    assert ((after.launches - before.launches)["adamw"],
            (after.values - before.values)["adamw"]) == (STEPS, STEPS * total)
    tol = STEPS * TOL[dtype]
    f32_torch = STEPS * TORCH_F32_UPDATE if dtype == torch.float32 else 0.0
    for a, b, c in zip(kern, plain, lib_):
        _close(a.detach(), b.detach(), tol, tol * UPDATE)
        _close(a.detach(), c.detach(), tol, tol * UPDATE + f32_torch)
        for key in ("exp_avg", "exp_avg_sq"):
            ka = opts[0].state[a][key]
            scale = float(ka.abs().max())
            _close(ka, opts[1].state[b][key], tol, tol * scale)
            _close(ka, opts[2].state[c][key], tol, tol * scale)
        for opt, p in zip(opts, (a, b, c)):
            assert float(opt.state[p]["step"]) == STEPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_replays_bit_equal_eager(dev, dtype):
    shapes = _shapes()
    start = [t.to(dev) for t in _values(shapes, dtype, 1, 0.05)]
    grads = [[t.to(dev) for t in _values(shapes, dtype, 200 + k)]
             for k in range(STEPS)]
    eager = [_leaf(t) for t in start]
    opt_e = adamw.AdamW(eager, lr=LR, weight_decay=WD, capturable=True)
    for k in range(STEPS):
        for p, g in zip(eager, grads[k]):
            p.grad = g
        opt_e.step()

    cap = [_leaf(t) for t in start]
    for p, g in zip(cap, grads[0]):
        p.grad = g.clone()
    opt_c = adamw.AdamW(cap, lr=LR, weight_decay=WD, capturable=True)
    step = graphs.capture(lambda: (opt_c.step(),)[1:])
    assert step.kernels == {"adamw": 1}
    assert step.values == {"adamw": sum(math.prod(s) for s in shapes)}
    # Undo the warm-up's steps, in place, as the trainer does.
    with torch.no_grad():
        for p, t in zip(cap, start):
            p.copy_(t)
        for state in opt_c.state.values():
            for v in state.values():
                v.zero_()
    for k in range(STEPS):
        with torch.no_grad():
            for p, g in zip(cap, grads[k]):
                p.grad.copy_(g)
        step()
    torch.cuda.synchronize(dev)
    for a, b in zip(cap, eager):
        assert torch.equal(a, b)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt_c.state[a][key], opt_e.state[b][key])


@pytest.mark.parametrize("case", ["resnet50", "two_types", "many_leaves"])
def test_launches_a_step(dev, case):
    most = lib.kernel("adamw", "adamw_max_leaves")()
    shapes = _shapes() if case != "many_leaves" else \
        [(3 + i % 5,) for i in range(most + 16)]
    dtypes = [torch.bfloat16 if case == "two_types" and i % 2 else
              torch.float32 for i in range(len(shapes))]
    leaves = [_leaf((torch.randn(s) * 0.1).to(dev, d))
              for s, d in zip(shapes, dtypes)]
    plain = [_leaf(p.cpu()) for p in leaves]
    for p, q in zip(leaves, plain):
        q.grad = torch.randn(q.shape).to(q.dtype)
        p.grad = q.grad.to(dev)
    opt = adamw.AdamW(leaves, lr=LR, weight_decay=WD, capturable=True)
    before = lib.counts().launches
    opt.step()
    adamw.AdamW(plain, lr=LR, weight_decay=WD).step()
    torch.cuda.synchronize(dev)
    want = {"resnet50": 1, "two_types": 2, "many_leaves": 2}[case]
    assert lib.counts().launches - before == {"adamw": want}
    for p, q in zip(leaves, plain):
        _close(p.detach(), q.detach(), TOL[p.dtype], TOL[p.dtype] * UPDATE)
        assert float(opt.state[p]["step"]) == 1


def test_captured_train_step_runs_the_kernel_alone(dev):
    res = train(steps=2, batch=2, width=8, classes=10, size=32,
                device="cuda", log=lambda s: None)
    step = res["step"]
    total = sum(p.numel() for p in res["model"].parameters())
    assert res["kernels"]["adamw"] == 1
    # The GroupNorm forward counts its values too: the 40 norms' at batch
    # 2, width 8, 32 x 32 (groupnorm.norm_calls).
    assert step.values == {"adamw": total, "groupnorm_fwd": 52_736}
    x, y = res["batch"]
    step(x, y)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize(dev)
    names = [e.key for e in prof.key_averages()]
    assert any("adamw_kernel" in n for n in names), names
    library = [n for n in names if "multi_tensor_apply" in n
               or "fused_adam" in n.lower() or "FusedAdam" in n]
    assert not library, library


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("float64", TypeError),
    ("step_on_host", ValueError), ("strided", ValueError),
    ("not_capturable", ValueError)])
def test_refuses_what_the_kernel_does_not_take(dev, case, error):
    dtype = {"float16": torch.float16, "float64": torch.float64}.get(
        case, torch.float32)
    p = torch.zeros(40, dtype=dtype, device=dev)
    g = torch.ones(40, dtype=dtype, device=dev)
    if case == "strided":
        p = torch.zeros(80, device=dev)[::2]
    if case == "not_capturable":
        with pytest.raises(error, match="capturable"):
            adamw.AdamW([p.requires_grad_()], capturable=False)
        return
    step = torch.zeros((), device="cpu" if case == "step_on_host" else dev)
    before = lib.counts()
    with pytest.raises(error, match="adamw"):
        adamw.adamw([p], [g], [torch.zeros_like(g)], [torch.zeros_like(g)],
                     [step], lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=WD,
                     done=torch.zeros((), dtype=torch.int32, device=dev))
    assert lib.counts() == before
