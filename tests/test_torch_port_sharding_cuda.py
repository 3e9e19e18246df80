"""The sharded-block modes on the card: the gather kernels' (a given output
grid `out_sizes`, a per-dim tap gate `gate_bounds` and the block's
placement in the whole input `block_origin`) and shift-blend's lead mode
(the same arguments on a halo-extended leading-dim block).

Every gated kernel (2D and 3D, the fused pair and the column pair) against
its plain PyTorch version on the blocks the sharding layer builds (the
image-border shards, whose gates cut inside the block) and on gates set by
hand, one of them closing exactly at integer sample points; gates equal
to (-1, S) and a zero placement must give the bits of the launch without
them; and the per-shard
function `sharding.block_conv` through the dispatch, forward and backward,
against its "torch" self and, stitched, against the unsharded op.  The
lead mode's four kernels against their plain versions on every shard
(offsets past the bound included, the 2D forward on both routes), the
per-shard function `sharding.shard_conv` stitched against the unsharded
shift-blend op, and its backward run twice for the same bits.  Marked
`cuda`: each test skips without an NVIDIA GPU.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_sharding_cuda.py -q

Limits per precision mode, as max|kernel - plain| / max|plain|: float32
1e-5, tensorfloat32 5e-3, bfloat16 2e-2 (tests/test_torch_port_cuda.py).
"""
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu_torch.ops import api
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
from modulated_deform_conv_tpu_torch.utils.device import current_profile

pytestmark = pytest.mark.cuda

LIMITS = {"float32": 1e-5, "tensorfloat32": 5e-3, "bfloat16": 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# (nd, B, C, O, S, k, g, dg, split dim, shards, offscale)
CASES = {
    "2d": (2, 2, 16, 24, (16, 9), 3, 2, 2, 0, 4, 2.0),
    "2d_w": (2, 1, 32, 16, (6, 16), 3, 1, 2, 1, 2, 1.5),
    "3d": (3, 1, 8, 8, (8, 6, 6), 3, 1, 2, 0, 2, 1.0),
}


def _global(dev, nd, B, C, O, S, k, g, dg, offscale, seed=0):
    rng = np.random.default_rng(seed)
    spec = DeformConvSpec.make(nd, k, 1, 1, 1, g, dg, modulated=True)
    K = spec.tap_count
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-offscale, offscale, (B, dg * nd * K) + S),
            rng.uniform(0, 1, (B, dg * K) + S),
            rng.standard_normal((O, C // g) + spec.kernel) * 0.1,
            rng.standard_normal((O,))]
    return spec, [torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in arrs]


def _plan(spec, ts, dim, n, max_offset):
    names = [None] * spec.ndim
    names[dim] = "space"
    x, off, mask, w, b = ts
    return sh.shard_plan(x.shape, off.shape, w.shape, mask.shape, b.shape,
                         spec, {"space": n}, None, names, max_offset)


def _block(spec, ts, plan, i):
    """The block-mode arguments of shard i: x_ext, the shard's offset and
    mask, the local spec, out_sizes, gate_bounds and block_origin."""
    x, off, mask = ts[:3]
    (shd,) = plan.shards
    x_ext = sh.cut_block(x, plan.shards, [i])
    lay = {2 + shd.dim: "space"}
    sizes = {"space": shd.n_shards}
    off_l, mask_l = (t[sh.shard_slices(t.shape, lay, {"space": i}, sizes)]
                     .contiguous() for t in (off, mask))
    local, placement, gates = sh.block_args(spec, plan.shards, [i],
                                            tuple(x_ext.shape[2:]))
    return (x_ext, off_l, mask_l, local, tuple(off_l.shape[2:]), gates,
            placement)


# The four gather kernels' wrappers, each taking the kernel of its
# spec's rank.
KERNELS = (gm.fused_fwd, gm.fused_bwd, gm.cols_fwd, gm.cols_bwd)


def _run_all(block, w, b, precision, gates, placement=None):
    """Outputs of the four gather kernels of the block's rank with these
    gates and this placement, and of their plain versions: lists of
    (kernel, plain)."""
    x_ext, off, mask, spec, OS = block[:5]
    mode = (OS, gates, placement)
    fwd, bwd, cfwd, cbwd = KERNELS
    g = torch.Generator(device=x_ext.device).manual_seed(1)
    gout = torch.randn((x_ext.shape[0], w.shape[0]) + OS, generator=g,
                       device=x_ext.device)
    cols_shape = (x_ext.shape[1] * spec.tap_count,
                  x_ext.shape[0] * int(np.prod(OS)))
    gcols = torch.randn(cols_shape, generator=g, device=x_ext.device).to(
        gm._cols_dtype(precision))
    pairs = []
    pairs.append((fwd(x_ext, off, mask, w, b, spec, precision, *mode),
                  gm.gathermm_fwd_reference(x_ext, off, mask, w, b, spec,
                                            precision, *mode)))
    got = bwd(x_ext, off, mask, w, gout, spec, precision, (True,) * 4, *mode)
    want = gm.gathermm_bwd_reference(x_ext, off, mask, w, gout, spec,
                                     precision, *mode)
    pairs += list(zip(got, want))
    pairs.append((cfwd(x_ext, off, mask, spec, precision, *mode).float(),
                  gm.gathermm_cols_reference(x_ext, off, mask, spec,
                                             precision, *mode).float()))
    got = cbwd(x_ext, off, mask, gcols, spec, precision, (True,) * 3, *mode)
    want = gm.gathermm_cols_bwd_reference(x_ext, off, mask, gcols, spec,
                                          precision, *mode)
    pairs += list(zip(got, want))
    return pairs


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("edge", ["first", "last"])
@pytest.mark.parametrize("case", list(CASES))
def test_gated_kernels_match_plain_on_border_shards(dev, case, edge,
                                                    precision):
    nd, B, C, O, S, k, g, dg, dim, n, scale = CASES[case]
    spec, ts = _global(dev, nd, B, C, O, S, k, g, dg, scale)
    plan = _plan(spec, ts, dim, n, scale)
    block = _block(spec, ts, plan, 0 if edge == "first" else n - 1)
    lo, hi = block[5][dim]
    assert lo > -1.0 or hi < block[0].shape[2 + dim]    # the gate cuts
    for i, (got, want) in enumerate(_run_all(block, ts[3], ts[4], precision,
                                             block[5], block[6])):
        assert got.shape == want.shape
        assert _rel(got, want) <= LIMITS[precision], i


@pytest.mark.parametrize("case", list(CASES))
def test_hand_gates_and_integer_gate_match_plain(dev, case):
    """Gates set by hand inside the block: fractional ones, and ones that
    close exactly at integer sample points (zero offsets put every tap on
    the integer grid; pos == lo and pos == hi are closed, value and
    gradient, as the open interval of the reference gate)."""
    nd, B, C, O, S, k, g, dg, dim, n, scale = CASES[case]
    spec, ts = _global(dev, nd, B, C, O, S, k, g, dg, scale)
    block = list(_block(spec, ts, _plan(spec, ts, dim, n, scale), 1))
    ext = block[0].shape[2:]
    frac = tuple((0.5 if d == dim else -1.0, s - 1.25)
                 for d, s in enumerate(ext))
    whole = tuple((1.0, s - 2.0) for s in ext)
    for gates, zero in ((frac, False), (whole, True)):
        if zero:
            block[1] = torch.zeros_like(block[1])
        for got, want in _run_all(tuple(block), ts[3], ts[4], "float32",
                                  gates, block[6]):
            assert _rel(got, want) <= LIMITS["float32"]


@pytest.mark.parametrize("case", list(CASES))
def test_open_gate_gives_ungated_bits(dev, case):
    """Gates equal to (-1, S) and a zero placement, read from the geometry,
    change no result: the bits of the launch without them, every kernel,
    every mode."""
    nd, B, C, O, S, k, g, dg, dim, n, scale = CASES[case]
    spec, ts = _global(dev, nd, B, C, O, S, k, g, dg, scale)
    x, off, mask, w, b = ts
    OS = spec.out_sizes(x.shape[2:])
    block = (x, off, mask, spec, OS)
    open_gates = tuple((-1.0, float(s)) for s in x.shape[2:])
    for precision in LIMITS:
        a = _run_all(block, w, b, precision, None)
        c = _run_all(block, w, b, precision, open_gates,
                     ((0.0, 0.0),) * nd)
        for (ga, _), (gc, _) in zip(a, c):
            assert torch.equal(ga, gc)


def test_gate_invariant_raises_on_the_card(dev):
    nd, B, C, O, S, k, g, dg, dim, n, scale = CASES["2d"]
    spec, (x, off, mask, w, b) = _global(dev, nd, B, C, O, S, k, g, dg, scale)
    for bad in (((-1.5, 16.0), (-1.0, 9.0)), ((-1.0, 16.5), (-1.0, 9.0)),
                ((3.0, 3.0), (-1.0, 9.0))):
        with pytest.raises(ValueError, match="gate_bounds"):
            gm.fused_fwd(x, off, mask, w, b, spec, "float32", None, bad)


@pytest.mark.parametrize("case", list(CASES))
def test_block_positions_round_as_unsharded(dev, case):
    """Offsets a hair off the integer grid, where the JAX package's fold
    (offset + shift in fp32) can move a sample across a grid line: the
    block mode's positions are the unsharded op's, so every shard's
    float32 forward and backward equal the unsharded kernels' rows
    (float32 limit), offset gradients included."""
    nd, B, C, O, S, k, g, dg, dim, n, scale = CASES[case]
    spec, ts = _global(dev, nd, B, C, O, S, k, g, dg, scale)
    x, off, mask, w, b = ts
    rng = np.random.default_rng(3)
    near = torch.tensor(rng.integers(-1, 2, off.shape) + rng.choice(
        [-1, 1], off.shape) * 1e-7, dtype=torch.float32, device=dev)
    ts[1] = near
    # |offset| <= 1 + 1e-7: a contract of scale + 1 keeps every corner in
    # the halo.
    plan = _plan(spec, ts, dim, n, scale + 1.0)
    lay, sizes = {2 + dim: "space"}, {"space": n}
    fwd, bwd = KERNELS[:2]
    OS = tuple(near.shape[2:])
    gout = torch.randn((B, O) + OS, device=dev)
    y0 = fwd(x, near, mask, w, b, spec, "float32")
    g0 = bwd(x, near, mask, w, gout, spec, "float32")
    for i in range(n):
        x_ext, off_l, mask_l, local, OSl, gates, placement = _block(
            spec, ts, plan, i)
        sl = sh.shard_slices(near.shape, lay, {"space": i}, sizes)
        y = fwd(x_ext, off_l, mask_l, w, b, local, "float32", OSl, gates,
                placement)
        assert _rel(y, y0[sl]) <= LIMITS["float32"]
        go = bwd(x_ext, off_l, mask_l, w, gout[sl].contiguous(), local,
                 "float32", (True,) * 4, OSl, gates, placement)
        assert _rel(go[1], g0[1][sl]) <= LIMITS["float32"]
        assert _rel(go[2], g0[2][sl]) <= LIMITS["float32"]


@pytest.mark.parametrize("case", list(CASES))
def test_block_conv_on_the_card_matches_torch_and_stitches(dev, case):
    """sharding.block_conv on CUDA tensors ("auto": the gather kernels'
    block mode) against itself at impl="torch", every shard, forward and
    the five gradients of sum(out^2); the stitched outputs and the summed
    block gradients against the unsharded kernel op."""
    nd, B, C, O, S, k, g, dg, dim, n, scale = CASES[case]
    spec, ts = _global(dev, nd, B, C, O, S, k, g, dg, scale)
    plan = _plan(spec, ts, dim, n, scale)
    (shd,) = plan.shards
    lay, sizes = {2 + dim: "space"}, {"space": n}
    x, off, mask, w, b = ts
    outs, gx = [], torch.zeros_like(x)
    goff, gmask = torch.zeros_like(off), torch.zeros_like(mask)
    gw, gb = torch.zeros_like(w), torch.zeros_like(b)
    for i in range(n):
        sl = sh.shard_slices(off.shape, lay, {"space": i}, sizes)
        res = {}
        for impl in ("auto", "torch"):
            xb = sh.cut_block(x, plan.shards, [i]).requires_grad_(True)
            ins = [xb] + [t.clone().requires_grad_(True)
                          for t in (off[sl].contiguous(),
                                    mask[sl].contiguous(), w, b)]
            y = sh.block_conv(*ins, spec, plan.shards, [i], impl, "float32")
            (y * y).sum().backward()
            res[impl] = [y.detach()] + [t.grad for t in ins]
        for got, want in zip(res["auto"], res["torch"]):
            assert _rel(got, want) <= LIMITS["float32"]
        y, gxb, go, gm_, gw_, gb_ = res["auto"]
        outs.append(y)
        goff[sl], gmask[sl] = go, gm_
        gw += gw_
        gb += gb_
        # The exchange's backward: each block row's gradient onto its row.
        lo = i * shd.in_local - shd.halo
        rows = range(max(lo, 0), min(lo + gxb.shape[2 + dim],
                                     x.shape[2 + dim]))
        gx.narrow(2 + dim, rows.start, len(rows)).add_(
            gxb.narrow(2 + dim, rows.start - lo, len(rows)))
    ins = [t.clone().requires_grad_(True) for t in ts]
    op = api.modulated_deform_conv2d if nd == 2 else \
        api.modulated_deform_conv3d
    y = op(*ins, 1, 1, 1, g, dg, impl="cuda", precision="float32")
    (y * y).sum().backward()
    assert _rel(torch.cat(outs, 2 + dim), y.detach()) <= LIMITS["float32"]
    for got, t in zip((gx, goff, gmask, gw, gb), ins):
        assert _rel(got, t.grad) <= LIMITS["float32"]


# ---- shift-blend's lead mode ------------------------------------------------

# (nd, B, C, O, S, k, g, dg, shards, bound): config 2's widths at B=2, and a
# small 3D block on the loop rule's 128-lane plane.
LEAD_CASES = {
    "cfg2": (2, 2, 256, 256, (56, 56), 3, 4, 4, 4, 2.0),
    "2d_small": (2, 2, 16, 24, (16, 9), 3, 2, 2, 4, 1.5),
    "3d": (3, 1, 16, 16, (8, 8, 16), 3, 1, 2, 2, 2.0),
}


def _lead_blocks(dev, case, offscale):
    """The spec, global inputs, plan and every shard's block arguments of a
    lead case, offsets from U[-offscale, offscale]."""
    nd, B, C, O, S, k, g, dg, n, bound = LEAD_CASES[case]
    spec, ts = _global(dev, nd, B, C, O, S, k, g, dg, offscale)
    plan = _plan(spec, ts, 0, n, bound)
    return spec, ts, plan, [_block(spec, ts, plan, i) for i in range(n)]


# The lead mode's wrappers, each taking the kernel of its spec's rank,
# and their plain versions.
LEAD_WRAPPERS = (sb.fwd, sb.bwd, sb.shiftblend_fwd_reference,
                 sb.shiftblend_bwd_reference)


@pytest.mark.parametrize("precision", list(LIMITS))
@pytest.mark.parametrize("case", list(LEAD_CASES))
def test_lead_kernels_match_plain_on_every_shard(dev, case, precision):
    """The lead mode's forward (in 2D on both routes) and backward on every
    shard's block against their plain versions, offsets up to 1.3 times
    the bound (corners past the window dropped around the tap's anchor in
    the whole input)."""
    bound = LEAD_CASES[case][-1]
    spec, ts, plan, blocks = _lead_blocks(dev, case, 1.3 * bound)
    w, b = ts[3], ts[4]
    fwd, bwd, fwd_ref, bwd_ref = LEAD_WRAPPERS
    for i, (x_ext, off_l, mask_l, local, OS, gates, placement) in enumerate(
            blocks):
        mode = (OS, gates, placement)
        args = (x_ext, off_l, mask_l, w, b, local, precision, bound)
        want = fwd_ref(*args, *mode)
        outs = [fwd(*args, *mode)]
        if spec.ndim == 2:
            outs += [sb.fwd(*args, *mode, halo=r) for r in (True, False)]
        for got in outs:
            assert got.shape == want.shape
            assert _rel(got, want) <= LIMITS[precision], i
        gout = torch.randn(want.shape, device=dev)
        bargs = (x_ext, off_l, mask_l, w, gout, local, precision, bound)
        for got, ref in zip(bwd(*bargs, (True,) * 4, *mode),
                            bwd_ref(*bargs, *mode)):
            assert _rel(got, ref) <= LIMITS[precision], i


@pytest.mark.parametrize("case", list(LEAD_CASES))
def test_lead_mode_stitches_to_the_unsharded_op(dev, case):
    """`sharding.shard_conv` takes the lead mode (one forward and one
    backward launch a shard) under "auto" on CUDA tensors where the card's
    profile takes it (C/dg <= its `sb_lead_crossover_cg`; a case past it
    is forced with impl="shiftblend"),
    and the stitched outputs and summed block gradients of sum(out^2)
    equal the unsharded shift-blend op's (float32 limit)."""
    nd, B, C, O, S, k, g, dg, n, bound = LEAD_CASES[case]
    spec, ts, plan, _ = _lead_blocks(dev, case, bound)
    (shd,) = plan.shards
    x, off, mask, w, b = ts
    prefers = sh.lead_prefers(x.narrow(2, 0, shd.in_local), spec,
                              plan.shards, bound)
    assert prefers == (C // dg <= current_profile(x).sb_lead_crossover_cg)
    impl = "auto" if prefers else "shiftblend"
    family = "shiftblend" if nd == 2 else "shiftblend3d"
    lay, sizes = {2: "space"}, {"space": n}
    outs, gx = [], torch.zeros_like(x)
    goff, gmask = torch.zeros_like(off), torch.zeros_like(mask)
    gw, gb = torch.zeros_like(w), torch.zeros_like(b)
    for i in range(n):
        sl = sh.shard_slices(off.shape, lay, {"space": i}, sizes)
        ins = [sh.cut_block(x, plan.shards, [i]).requires_grad_(True)] + [
            t.clone().requires_grad_(True)
            for t in (off[sl].contiguous(), mask[sl].contiguous(), w, b)]
        before = lib.counts().launches
        y = sh.shard_conv(*ins, spec, plan.shards, [i], bound, impl,
                          "float32")
        (y * y).sum().backward()
        launched = lib.counts().launches - before
        assert (launched[f"{family}_fwd"], launched[f"{family}_bwd"]) == (
            1, 1)
        outs.append(y.detach())
        goff[sl], gmask[sl] = ins[1].grad, ins[2].grad
        gw += ins[3].grad
        gb += ins[4].grad
        lo = i * shd.in_local - shd.halo
        rows = range(max(lo, 0), min(lo + ins[0].shape[2], x.shape[2]))
        gx.narrow(2, rows.start, len(rows)).add_(
            ins[0].grad.narrow(2, rows.start - lo, len(rows)))
    ins = [t.clone().requires_grad_(True) for t in ts]
    op = api.modulated_deform_conv2d if nd == 2 else \
        api.modulated_deform_conv3d
    y = op(*ins, 1, 1, 1, g, dg, impl="shiftblend", precision="float32",
           offset_bound=bound)
    (y * y).sum().backward()
    assert _rel(torch.cat(outs, 2), y.detach()) <= LIMITS["float32"]
    for got, t in zip((gx, goff, gmask, gw, gb), ins):
        assert _rel(got, t.grad) <= LIMITS["float32"]


@pytest.mark.parametrize("case", list(LEAD_CASES))
def test_lead_backward_is_bitwise_repeatable(dev, case):
    """Two runs of the lead-mode backward on an interior shard give the
    same bits: the pulls are fixed-order, with no float atomics."""
    bound = LEAD_CASES[case][-1]
    spec, ts, plan, blocks = _lead_blocks(dev, case, bound)
    x_ext, off_l, mask_l, local, OS, gates, placement = blocks[1]
    bwd = LEAD_WRAPPERS[1]
    gout = torch.randn((x_ext.shape[0], ts[3].shape[0]) + OS, device=dev)
    runs = [bwd(x_ext, off_l, mask_l, ts[3], gout, local, "tensorfloat32",
                bound, (True,) * 4, OS, gates, placement) for _ in range(2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)
