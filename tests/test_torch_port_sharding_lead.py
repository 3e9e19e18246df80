"""Shift-blend's lead mode against the JAX package's, on the CPU, with no
process group.

A shard's halo-extended leading-dim block is cut from the global tensors
(`sharding.cut_block`) and its arguments built (`block_args`: padding 0 on
the split dim, the shard's output grid, the gate at the global border and
the block's placement); the block goes through the port's
`shiftblend.deform_conv_shift_sharded` (on CPU tensors the kernels' plain
versions) and through the JAX package's
`shiftblend.deform_conv_shift_sharded(..., halo, S0_global, origin)`, its
Pallas kernels in interpret mode.  Cases: the first, an interior and the
last shard of a 2D split; a 2D shard whose edge rows carry offsets past
the bound, whose corners are dropped by the window around the tap's anchor
in the whole input; and a 3D block at the unrolled geometry of
tests/test_torch_port_3d_lead.py (2 x 2 x 2 taps, dilation 2, pad 1, bound
0.5, halo 2).  Float32; the output within rtol = atol = 2e-5, and each
gradient (x, offset, mask, weight, bias) within 1e-5 of max|JAX gradient|.
One jitted JAX step per geometry serves every shard of it.

Beside them: `sharded_lead_reason` against the JAX package's over a sweep
of shapes; the plain windowed op on a placed block against the unsharded
windowed op's rows (pure torch); and the sharding layer's choice of the
lead mode.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu.ops.pallas import shiftblend as jsb
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

from modulated_deform_conv_tpu_torch.ops import core
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

NAMES = ("x", "offset", "mask", "weight", "bias")

# geometry: (B, C, O, global S, kernel, pad, dilation, shards, max_offset)
GEOMETRIES = {
    "2d": (1, 8, 8, (32, 8), 3, 1, 1, 4, 2.0),
    "3d": (1, 8, 8, (8, 4, 8), 2, 1, 2, 2, 0.5),
}
# name: (geometry, shard, past-bound offsets at the shard's edge rows)
CASES = {
    "2d_first": ("2d", 0, False),
    "2d_interior": ("2d", 1, False),
    "2d_last": ("2d", 3, False),
    "2d_past_bound_edge": ("2d", 2, True),
    "3d_last": ("3d", 1, False),
}


def _spec(geo, cls=DeformConvSpec):
    B, C, O, S, k, p, dl, n, mo = GEOMETRIES[geo]
    return cls.make(len(S), k, 1, p, dl, 1, 1, modulated=True)


def _globals(geo, past_bound):
    """The global inputs (float32 numpy), offsets within max_offset, or
    with past_bound the leading-dim offsets of the edge rows of shard
    n // 2 (rows 16 and 23 in 2D) set past it: 2.6 and -2.7, alternating
    by tap."""
    B, C, O, S, k, p, dl, n, mo = GEOMETRIES[geo]
    nd, K = len(S), k ** len(S)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, C) + S)
    off = rng.uniform(-mo * 0.9, mo * 0.9, (B, nd * K) + S)
    if past_bound:
        rows = S[0] // n
        for row in (n // 2 * rows, (n // 2 + 1) * rows - 1):
            off[:, 0:nd * K:2 * nd, row] = 2.6
            off[:, nd:nd * K:2 * nd, row] = -2.7
    mask = rng.uniform(0, 1, (B, K) + S)
    w = rng.standard_normal((O, C) + (k,) * nd) * 0.2
    b = rng.standard_normal((O,))
    return [a.astype(np.float32) for a in (x, off, mask, w, b)]


def _plan(geo, x, off, mask, w):
    B, C, O, S, k, p, dl, n, mo = GEOMETRIES[geo]
    names = ["space"] + [None] * (len(S) - 1)
    return sh.shard_plan(x.shape, off.shape, w.shape, mask.shape, None,
                         _spec(geo), {"space": n}, None, names, mo)


@functools.lru_cache(maxsize=None)
def _jax_step(geo):
    """The JAX package's lead mode, forward and VJP, jitted once per
    geometry: (block, offset, mask, weight, bias, origin, cot) -> (out,
    grads)."""
    B, C, O, S, k, p, dl, n, mo = GEOMETRIES[geo]
    js = _spec(geo, JSpec)
    halo = sh.required_halo(_spec(geo), mo)

    @jax.jit
    def step(xe, off, mask, w, b, origin, cot):
        def f(*a):
            return jsb.deform_conv_shift_sharded(*a, js, "float32", mo, halo,
                                                 S[0], origin)
        out, vjp = jax.vjp(f, xe, off, mask, w, b)
        return out, vjp(cot)
    return step


@functools.lru_cache(maxsize=None)
def _results(name):
    """(port out, port grads, JAX out, JAX grads, block args) of a case."""
    geo, i, past = CASES[name]
    spec = _spec(geo)
    g = [torch.tensor(a) for a in _globals(geo, past)]
    plan = _plan(geo, *g[:4])
    (shd,) = plan.shards
    xe = sh.cut_block(g[0], plan.shards, [i])
    local, placement, gates = sh.block_args(spec, plan.shards, [i],
                                            tuple(xe.shape[2:]))
    sl = slice(i * shd.out_local, (i + 1) * shd.out_local)
    ins = [xe, g[1][:, :, sl], g[2][:, :, sl], g[3], g[4]]
    OS = tuple(ins[1].shape[2:])
    cot = np.random.default_rng(100 + i).standard_normal(
        (xe.shape[0], g[3].shape[0]) + OS).astype(np.float32)

    ts = [t.contiguous().clone().requires_grad_(True) for t in ins]
    out = sb.deform_conv_shift_sharded(*ts, local, "float32",
                                       GEOMETRIES[geo][-1], OS, gates,
                                       placement)
    out.backward(torch.from_numpy(cot))
    want, want_grads = _jax_step(geo)(
        *[jnp.asarray(t.contiguous().numpy()) for t in ins],
        jnp.float32(i * shd.out_local), jnp.asarray(cot))
    return (out.detach().numpy(), [t.grad.numpy() for t in ts],
            np.asarray(want), [np.asarray(a) for a in want_grads],
            (local, OS, gates, placement, ins))


@pytest.mark.parametrize("name", list(CASES))
def test_lead_block_matches_jax(name):
    out, grads, want, want_grads, _ = _results(name)
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    for n, got, w in zip(NAMES, grads, want_grads):
        scale = float(np.abs(w).max())
        assert scale > 0, n
        np.testing.assert_allclose(got / scale, w / scale, rtol=0, atol=1e-5,
                                   err_msg=n)


def test_past_bound_corners_are_dropped():
    """At the edge rows of the past-bound case the window drops corners:
    the lead mode differs there from the gather kernels' block mode on the
    same block (no window), and agrees with it on the rows whose offsets
    keep within the bound."""
    out, _, _, _, (local, OS, gates, placement, ins) = _results(
        "2d_past_bound_edge")
    plain = core._deform_conv_nd(*ins, local, out_sizes=OS,
                                 precision="float32", gate_bounds=gates,
                                 block_origin=placement).numpy()
    d = np.abs(out - plain).max(axis=(0, 1, 3))
    assert d[0] > 1e-2 and d[-1] > 1e-2, d
    np.testing.assert_allclose(out[:, :, 1:-1], plain[:, :, 1:-1],
                               rtol=2e-5, atol=2e-5)


def _sweep():
    """(x_ext_shape, dtype, spec args, bound, halo, S0_global) cases: 2D
    and 3D, every inner dim size-preserving (the sharding layer's blocks),
    across the rules: bound, stride, C/dg, dg % groups, the 640-pair /
    128-lane loop rule."""
    out = []
    for C, dg, g, s, bound in itertools.product(
            (8, 12, 64, 264), (1, 2), (1, 2), (1, 2), (0.0, 1.0, 2.0)):
        out.append(((2, C, 8 + 2 * 3, 8), torch.float32,
                    (2, 3, s, 1, 1, g, dg), bound, 3, 32))
    for k, plane, bound in itertools.product((3, 5), ((4, 8), (8, 16)),
                                             (0.5, 2.0)):
        p = (k - 1) // 2
        out.append(((1, 16, 4 + 2 * 4) + plane, torch.float32,
                    (3, k, 1, p, 1, 1, 1), bound, 4, 16))
    return out


def test_sharded_lead_reason_matches_jax():
    """The port's rule against the JAX package's on every case where the
    JAX reason is not a TPU budget (VMEM residency, saved columns), which
    has no counterpart on the card."""
    compared = 0
    for shape, dtype, sargs, bound, halo, S0 in _sweep():
        spec = DeformConvSpec.make(*sargs, modulated=True)
        js = JSpec.make(*sargs, modulated=True)
        want = jsb.sharded_lead_reason(shape, jnp.float32, js, bound, halo,
                                       S0)
        got = sb.sharded_lead_reason(shape, dtype, spec, bound, halo, S0)
        if want is not None and ("residency" in want or "residual" in want):
            continue
        assert got == want, (shape, sargs, bound)
        compared += 1
    assert compared >= 80


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_placed_window_matches_unsharded_rows(geo):
    """The plain windowed op on every shard's placed block gives the rows
    of the unsharded windowed op, offsets past the bound included: the
    window sits around the tap's anchor in the whole input."""
    B, C, O, S, k, p, dl, n, mo = GEOMETRIES[geo]
    spec = _spec(geo)
    x, off, mask, w, b = (torch.tensor(a) for a in _globals(geo, True))
    win = sb.corner_windows(spec, mo)
    want = core._deform_conv_nd(x, off, mask, w, b, spec,
                                precision="float32", corner_window=win)
    plan = _plan(geo, x, off, mask, w)
    (shd,) = plan.shards
    for i in range(n):
        xe = sh.cut_block(x, plan.shards, [i])
        local, placement, gates = sh.block_args(spec, plan.shards, [i],
                                                tuple(xe.shape[2:]))
        sl = slice(i * shd.out_local, (i + 1) * shd.out_local)
        got = core._deform_conv_nd(
            xe, off[:, :, sl], mask[:, :, sl], w, b, local,
            out_sizes=tuple(off[:, :, sl].shape[2:]), precision="float32",
            gate_bounds=gates, corner_window=win, block_origin=placement)
        np.testing.assert_allclose(got.numpy(), want[:, :, sl].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=str(i))


def test_lead_mode_choice():
    """The sharding layer's rule (the JAX package's): one leading-dim split
    with max_offset > 0, a narrow slab, CUDA tensors under "auto" (so not
    these CPU tensors), or forced; forced where the lead mode does not
    take the block raises with its reason."""
    lead = sh._SpatialShard(0, "space", 4, 3, 8, 8)
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    x = torch.zeros((1, 16, 8, 8))
    assert sh._lead_mode(x, spec, (lead,), 2.0, "shiftblend")
    assert not sh._lead_mode(x, spec, (lead,), 2.0, "auto")
    assert not sh._lead_mode(x, spec, (lead,), 2.0, "cuda")
    wide = torch.zeros((1, 264, 8, 8), device="meta")
    with pytest.raises(NotImplementedError, match="lead mode.*256"):
        sh._lead_mode(wide, spec, (lead,), 2.0, "shiftblend")
    assert not sh._lead_mode(x, spec, (lead,), 0.0, "auto")
    with pytest.raises(NotImplementedError, match="lead mode"):
        sh._lead_mode(x, spec, (lead,), 0.0, "shiftblend")
