"""bf16 on the card: each of the twelve kernels' entry points, in the three
precision modes, takes bf16 activations as they are and gives the bits of
the upcast route, the same wrapper on the float32 copies of its inputs with
its results cast to the inputs' types.  The kernels convert every load to
fp32 (exact), keep every sum in fp32 and round once at the final store, so
the two agree bit for bit.

Cases at small shapes: channels a conv group or a deformable group that are
no multiple of 4 (the 4-byte corner reads), plane widths and planes that
are no multiple of 8 (the column forward's 2-byte staging in bf16; a
multiple of 8 takes its 16-byte copies of 8 values), both 2D shift-blend
routes, both column-forward routes, far offsets (the column forward's
corners from x), the gather kernels' block mode and shift-blend's lead
mode on a shard's block; the four autograd entries (out, and the gradients
of x, offset, mask and weight bit-equal, the bias's within one bf16 ulp);
mixed activation types take the upcast route (io 0 at every launch); a
wrapper refuses activation types it does not take.

Marked `cuda`: each test skips without an NVIDIA GPU.  This file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_bf16_cuda.py -q
"""
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

pytestmark = pytest.mark.cuda

MODES = ("float32", "tensorfloat32", "bfloat16")
bf16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, C, O, S, k, stride, pad, dil, g, dg, offscale,
          wtype=torch.float32, seed=0):
    """bf16 x, offset and mask, weight and bias of `wtype`, and a bf16
    cotangent."""
    rng = np.random.default_rng(seed)
    nd = len(S)
    spec = DeformConvSpec.make(nd, k, stride, pad, dil, g, dg, modulated=True)
    OS, K = spec.out_sizes(S), spec.tap_count
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-offscale, offscale, (B, dg * nd * K) + OS),
            rng.uniform(0, 1, (B, dg * K) + OS),
            rng.standard_normal((O, C // g) + spec.kernel) * 0.1,
            rng.standard_normal((O,)),
            rng.standard_normal((B, O) + OS)]
    types = (bf16,) * 3 + (wtype,) * 2 + (bf16,)
    return spec, [torch.tensor(a, dtype=torch.float32, device=dev).to(t)
                  for a, t in zip(arrs, types)]


def _same(native, upcast, inputs):
    """Each native result has its input's type and the bits of the upcast
    route's result cast to that type."""
    for i, (n, u, t) in enumerate(zip(native, upcast, inputs)):
        if t is None:
            assert n is None and u is None, i
            continue
        assert n.dtype == t.dtype, (i, n.dtype, t.dtype)
        assert torch.equal(n, u.to(t.dtype)), (
            i, int((n != u.to(t.dtype)).sum()))


def _fused(bounded):
    return (sb.fwd, sb.bwd) if bounded else (gm.fused_fwd, gm.fused_bwd)


# (B, C, O, S, k, stride, pad, dil, g, dg, offscale, bound): the gather
# pairs (bound None) with 6 channels a conv group over deformable groups of
# 4 (scalar corner reads), 12 channels over 3 groups of 4, 13- and 9-wide
# planes; the shift-blend pairs with 8 channels a deformable group, a
# 9-wide plane, offsets past the bound, and in 3D the loop rule's 8 x 16
# plane and 2 x 2 x 2 taps of dilation 2 on a 9 x 7 one.
FUSED = [
    (2, 12, 10, (9, 13), 3, 1, 1, 1, 2, 3, 3.0, None),
    (1, 16, 70, (11, 9), 3, 2, 1, 1, 1, 2, 8.0, None),
    (2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 2, 1.3, 1.0),
    (2, 12, 10, (5, 7, 6), 3, 1, 1, 1, 2, 3, 3.0, None),
    (1, 16, 16, (6, 8, 16), 3, 1, 1, 1, 1, 2, 1.3, 1.0),
    (2, 32, 32, (4, 9, 7), 2, 1, 1, 2, 1, 1, 0.45, 0.5),
]


@pytest.mark.parametrize("wtype", [torch.float32, bf16])
@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("case", FUSED)
def test_fused_kernels_bf16_bits(dev, case, precision, wtype):
    spec, (x, off, mask, w, b, cot) = _case(dev, *case[:-1], wtype=wtype)
    bound = case[-1]
    fwd, bwd = _fused(bound is not None)
    extra = () if bound is None else (bound,)
    family = (("gathermm" if bound is None else "shiftblend")
              + ("" if spec.ndim == 2 else "3d"))
    before = lib.counts().launches
    out = fwd(x, off, mask, w, b, spec, precision, *extra)
    up = fwd(x.float(), off.float(), mask.float(), w.float(), b.float(),
             spec, precision, *extra)
    _same([out], [up], [x])
    grads = bwd(x, off, mask, w, cot, spec, precision, *extra)
    ups = bwd(x.float(), off.float(), mask.float(), w.float(), cot.float(),
              spec, precision, *extra)
    _same(grads, ups, (x, off, mask, w))
    assert lib.counts().launches - before == {f"{family}_fwd": 2,
                                              f"{family}_bwd": 2}


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("hw", [(16, 16), (10, 9)])
def test_shiftblend_fwd_both_routes_bf16_bits(dev, hw, precision):
    """The 2D shift-blend forward's halo route (staged from fp32 xt) and
    its xt route, each against its own upcast launch."""
    spec, (x, off, mask, w, b, _) = _case(dev, 2, 24, 16, hw, 3, 1, 1, 1, 1,
                                          3, 1.3)
    for halo in (True, False):
        got = sb.fwd(x, off, mask, w, b, spec, precision, 1.0, halo=halo)
        up = sb.fwd(x.float(), off.float(), mask.float(), w, b, spec,
                    precision, 1.0, halo=halo)
        _same([got], [up], [x])


# (B, C, O, S, k, stride, pad, dil, g, dg, offscale): planes of 135, 128
# and 196 values (the plane route's staging copies in bf16: 2-byte, 16-byte
# and 8-byte), 12 channels over 3 deformable groups, far offsets (corners
# from x), stride 2, 3D volumes of 210 (4-byte copies in bf16, 8-byte in
# fp32) and 512 values.
COLUMNS = [
    (2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 1, 3.0),
    (2, 16, 24, (8, 16), 3, 1, 1, 1, 2, 1, 2.0),
    (2, 16, 24, (14, 14), 3, 1, 1, 1, 2, 1, 2.0),
    (1, 12, 8, (11, 13), 3, 2, 1, 1, 1, 3, 8.0),
    (2, 32, 32, (7, 7), 3, 1, 1, 1, 1, 1, 40.0),
    (2, 16, 24, (5, 7, 6), 3, 1, 1, 1, 2, 1, 3.0),
    (1, 8, 8, (4, 8, 16), 3, 1, 1, 1, 1, 1, 2.0),
]


@pytest.mark.parametrize("route", ["plane", "gather"])
@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("case", COLUMNS)
def test_column_kernels_bf16_bits(dev, case, precision, route):
    spec, (x, off, mask, _, _, _) = _case(dev, *case)
    bwd = gm.cols_bwd
    cols = gm.cols_fwd(x, off, mask, spec, precision, route=route)
    up = gm.cols_fwd(x.float(), off.float(), mask.float(), spec, precision,
                     route=route)
    assert cols.dtype == gm._cols_dtype(precision)
    assert torch.equal(cols, up)
    g = torch.Generator(device=dev).manual_seed(3)
    gcols = torch.randn(tuple(cols.shape), generator=g, device=dev).to(
        cols.dtype)
    grads = bwd(x, off, mask, gcols, spec, precision)
    ups = bwd(x.float(), off.float(), mask.float(), gcols, spec, precision)
    _same(grads, ups, (x, off, mask))


# The four autograd entries: (label, spec args, entry).
ENTRIES = {
    "fused_pair": ((2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 2, 3.0),
                   lambda ins, s, p: gm.deform_conv_fused_pair(*ins, s, p)),
    "fused_pair_3d": ((2, 12, 10, (5, 7, 6), 3, 1, 1, 1, 2, 3, 3.0),
                      lambda ins, s, p: gm.deform_conv_fused_pair(*ins, s,
                                                                  p)),
    "cols": ((2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 1, 3.0),
             lambda ins, s, p: gm.deform_conv_cols(*ins, s, p)),
    "cols_3d": ((2, 16, 24, (5, 7, 6), 3, 1, 1, 1, 2, 1, 3.0),
                lambda ins, s, p: gm.deform_conv_cols(*ins, s, p)),
    "shift": ((2, 16, 24, (15, 9), 3, 1, 1, 1, 2, 2, 1.0),
              lambda ins, s, p: sb.deform_conv_shift(*ins, s, p, 1.0)),
    "shift_3d": ((1, 16, 16, (6, 8, 16), 3, 1, 1, 1, 1, 2, 1.0),
                 lambda ins, s, p: sb.deform_conv_shift(*ins, s, p, 1.0)),
}


def _bias_within_ulp(got, want):
    """Bit-equal, or within one bf16 ulp (2^-7 of the value at most):
    torch's fp32-accumulated sum of a bf16 tensor may run in another order
    than the sum of its fp32 copy."""
    if torch.equal(got, want):
        return
    scale = torch.maximum(got.float().abs(), want.float().abs())
    assert bool(((got.float() - want.float()).abs()
                 <= 2.0 ** -7 * scale.clamp_min(1e-30)).all())


@pytest.mark.parametrize("wtype", [torch.float32, bf16])
@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entries_bf16_bits(dev, entry, precision, wtype):
    args, fn = ENTRIES[entry]
    spec, ts = _case(dev, *args, wtype=wtype)
    cot = ts[5]
    res = {}
    for route in ("native", "upcast"):
        ins = [t.clone().requires_grad_(True) for t in ts[:5]]
        call = ins if route == "native" else [lib.as_f32(t) for t in ins]
        out = fn(call, spec, precision)
        if route == "upcast":
            out = out.to(bf16)
        out.backward(cot)
        res[route] = [out.detach()] + [t.grad for t in ins]
    n, u = res["native"], res["upcast"]
    assert [t.dtype for t in n] == [bf16] * 4 + [wtype] * 2
    for i in range(5):
        assert torch.equal(n[i], u[i]), (entry, i)
    _bias_within_ulp(n[5], u[5])


def test_mixed_types_take_upcast_route(dev, monkeypatch):
    """bf16 x with an fp32 offset, and fp16 activations: every launch gets
    fp32 tensors (io 0) and the results the caller's types."""
    ios = []
    launch = lib.launch
    monkeypatch.setattr(lib, "launch", lambda name, x, t, ints, floats=(): (
        ios.append((name, ints[-1], x.dtype)),
        launch(name, x, t, ints, floats))[1])
    spec, (x, off, mask, w, b, cot) = _case(dev, 2, 16, 24, (15, 9), 3, 1,
                                            1, 1, 2, 2, 3.0)
    for ins in ([x, off.float(), mask, w, b],
                [x.half(), off.half(), mask.half(), w, b]):
        ins = [t.clone().requires_grad_(True) for t in ins]
        out = gm.deform_conv_fused_pair(*ins, spec, "tensorfloat32")
        out.backward(cot.to(out.dtype))
        assert out.dtype == ins[0].dtype
        assert [t.grad.dtype for t in ins] == [t.dtype for t in ins]
    assert ios and all(io == 0 and dt == torch.float32
                       for _, io, dt in ios), ios


def test_wrappers_refuse_other_types(dev):
    """A kernel takes fp32 or bf16 activations of one type, and raises
    otherwise: no launch falls back to another route."""
    spec, (x, off, mask, w, b, _) = _case(dev, 1, 16, 8, (8, 8), 3, 1, 1, 1,
                                          1, 1, 1.0)
    with pytest.raises(TypeError):
        gm.fused_fwd(x, off.float(), mask, w, b, spec, "float32")
    with pytest.raises(TypeError):
        gm.fused_fwd(x.half(), off.half(), mask.half(), w, b, spec,
                     "float32")
    with pytest.raises(TypeError):
        sb.fwd(x, off, mask, w.half(), b, spec, "float32", 1.0)
    with pytest.raises(ValueError):
        gm.fused_bwd(x, off, mask, w, torch.zeros(
            (1, 8, 8, 8), device=dev), spec, "float32")


def _blocks(dev, nd, S, dg, n, scale):
    rng = np.random.default_rng(5)
    C, O = 16, 24
    spec = DeformConvSpec.make(nd, 3, 1, 1, 1, 1, dg, modulated=True)
    K = spec.tap_count
    ts = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.standard_normal((1, C) + S),
        rng.uniform(-scale, scale, (1, dg * nd * K) + S),
        rng.uniform(0, 1, (1, dg * K) + S),
        rng.standard_normal((O, C) + spec.kernel) * 0.1,
        rng.standard_normal((O,)))]
    names = ["space"] + [None] * (nd - 1)
    plan = sh.shard_plan(ts[0].shape, ts[1].shape, ts[3].shape, ts[2].shape,
                         ts[4].shape, spec, {"space": n}, None, names, scale)
    out = []
    for i in range(n):
        x_ext = sh.cut_block(ts[0], plan.shards, [i])
        sl = sh.shard_slices(ts[1].shape, {2: "space"}, {"space": i},
                             {"space": n})
        off_l, mask_l = (t[sl].contiguous() for t in ts[1:3])
        local, placement, gates = sh.block_args(spec, plan.shards, [i],
                                                tuple(x_ext.shape[2:]))
        out.append((x_ext, off_l, mask_l, local, tuple(off_l.shape[2:]),
                    gates, placement))
    return ts[3], ts[4], out


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("nd", [2, 3])
def test_sharded_blocks_bf16_bits(dev, nd, precision):
    """Every shard's block through the gather kernels' block mode (the
    fused pair and the column pair) and shift-blend's lead mode: bf16
    against the upcast route, bit for bit."""
    S = (16, 9) if nd == 2 else (8, 8, 16)
    w, b, blocks = _blocks(dev, nd, S, 2, 2, 1.0)
    fwd, bwd = _fused(False)
    sfwd, sbwd = _fused(True)
    cfwd, cbwd = gm.cols_fwd, gm.cols_bwd
    for x_ext, off, mask, local, OS, gates, placement in blocks:
        mode = (OS, gates, placement)
        xb, ob, mb = (t.to(bf16) for t in (x_ext, off, mask))
        xu, ou, mu = (t.float() for t in (xb, ob, mb))
        g = torch.Generator(device=dev).manual_seed(1)
        cot = torch.randn((1, w.shape[0]) + OS, generator=g,
                          device=dev).to(bf16)
        for f, bw, extra in ((fwd, bwd, ()), (sfwd, sbwd, (1.0,))):
            _same([f(xb, ob, mb, w, b, local, precision, *extra, *mode)],
                  [f(xu, ou, mu, w, b, local, precision, *extra, *mode)],
                  [xb])
            _same(bw(xb, ob, mb, w, cot, local, precision, *extra,
                     (True,) * 4, *mode),
                  bw(xu, ou, mu, w, cot.float(), local, precision, *extra,
                     (True,) * 4, *mode), (xb, ob, mb, w))
        cols = cfwd(xb, ob, mb, local, precision, *mode)
        assert torch.equal(cols, cfwd(xu, ou, mu, local, precision, *mode))
        gcols = torch.randn(tuple(cols.shape), generator=g,
                            device=dev).to(cols.dtype)
        _same(cbwd(xb, ob, mb, gcols, local, precision, (True,) * 3, *mode),
              cbwd(xu, ou, mu, gcols, local, precision, (True,) * 3, *mode),
              (xb, ob, mb))
