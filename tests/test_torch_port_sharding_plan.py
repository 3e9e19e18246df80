"""The port's shard plan against the JAX package's sharding layer, with no
process group.

`required_halo` for every dim (stride-2 edges included); the per-shard block
arguments (`cut_block`: the exchanged block; `block_args`: the local
padding, the gate and the block's placement, whose shift less origin is
the offset shift the JAX package folds in) against what the JAX package's
`_local_conv` (sharding.py:156-264) hands its dispatch, run inside the JAX
package's `shard_map` on its 8 CPU devices;
the ValueErrors of the JAX package's sharding layer (sharding.py:317-367)
against the port's `shard_plan` on the same global shapes; `maybe_cuda`'s
routing of the block mode; and the host check of the gate invariant.
Exact: the block and the gates are equal bit for bit, and the placement
gives JAX's shift.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu.parallel import sharding as jsh
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

from modulated_deform_conv_tpu_torch.ops import api
from modulated_deform_conv_tpu_torch.ops import cuda as pcuda
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as psb
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec


def _jspec(spec):
    return JSpec.make(spec.ndim, spec.kernel, spec.stride, spec.padding,
                      spec.dilation, spec.groups, spec.deformable_groups,
                      spec.in_step, spec.modulated)


# (ndim, kernel, stride, padding, dilation)
HALO_SPECS = [
    (2, 3, 1, 1, 1), (2, 3, 1, 0, 1), (2, 3, 2, 1, 1), (2, 2, 2, 0, 1),
    (2, (5, 3), (2, 1), (2, 0), (1, 2)), (2, 7, 2, 3, 1), (2, 1, 1, 0, 1),
    (3, 3, 1, 1, 1), (3, (3, 5, 1), (1, 2, 1), (1, 2, 0), (2, 1, 1)),
]


@pytest.mark.parametrize("case", HALO_SPECS)
def test_required_halo_matches_jax(case):
    spec = DeformConvSpec.make(*case)
    for dim, max_off in itertools.product(range(spec.ndim),
                                          (0.0, 0.5, 1.5, 2.3, 10.0)):
        assert sh.required_halo(spec, max_off, dim) == jsh.required_halo(
            _jspec(spec), max_off, dim), (dim, max_off)


# name: (B, C, S, kernel, stride, padding, dg, max_offset, {dim: n}, halo)
BLOCKS = {
    "h4": (2, 4, (16, 8), 3, 1, 1, 2, 1.5, {0: 4}, None),
    "w4": (1, 4, (8, 16), 3, 1, 1, 2, 1.5, {1: 4}, None),
    "hw2x2": (1, 4, (16, 8), 3, 1, 1, 1, 1.5, {0: 2, 1: 2}, None),
    "h8_multihop": (1, 2, (16, 8), 3, 1, 1, 1, 3.0, {0: 8}, None),
    "h2_stride2": (1, 4, (16, 8), 3, 2, 1, 1, 1.0, {0: 2}, None),
    "h4_k2s2_halo2": (1, 2, (16, 8), 2, 2, 0, 1, 0.5, {0: 4}, 2),
    "3d_d4": (1, 2, (8, 6, 6), 3, 1, 1, 1, 1.0, {0: 4}, None),
    "3d_l2": (1, 2, (6, 6, 8), 3, 1, 1, 1, 1.0, {2: 2}, None),
}


def _jax_blocks(spec, x, off, shards):
    """What the JAX package's `_local_conv` hands its dispatch, for every
    shard: (x_ext, shifted offset, gates, local padding, out_sizes), keyed
    by shard coordinates."""
    seen = {}

    def fake_dispatch(x_ext, off_s, mask, w, b, lspec, impl, precision,
                      out_sizes=None, gate_bounds=None, **_):
        seen["pad"], seen["os"] = lspec.padding, out_sizes
        gates = jnp.stack([jnp.stack([jnp.asarray(lo, jnp.float32),
                                      jnp.asarray(hi, jnp.float32)])
                           for lo, hi in gate_bounds])
        return x_ext, off_s, gates

    names = [s.axis_name for s in shards]
    lead = (1,) * len(shards)

    def body(xl, ol):
        out = jsh._local_conv(xl, ol, None, None, None, _jspec(spec), shards,
                              max_offset=0.0, impl="auto", on_tpu=False)
        # One leading dim per mesh axis: the blocks come out stacked.
        return tuple(a.reshape(lead + a.shape) for a in out)

    from jax.sharding import PartitionSpec as P
    dims = [None] * spec.ndim
    for s in shards:
        dims[s.dim] = s.axis_name
    mesh = jsh.make_mesh([s.n_shards for s in shards], names)
    fn = jsh.shard_map(body, mesh, in_specs=(P(None, None, *dims),) * 2,
                       out_specs=(P(*names),) * 3)
    orig = jsh.ops_api._dispatch
    jsh.ops_api._dispatch = fake_dispatch
    try:
        x_ext, off_s, gates = fn(jnp.asarray(x), jnp.asarray(off))
    finally:
        jsh.ops_api._dispatch = orig
    return {c: (np.asarray(x_ext[c]), np.asarray(off_s[c]),
                np.asarray(gates[c]), seen["pad"], tuple(seen["os"]))
            for c in itertools.product(*[range(s.n_shards) for s in shards])}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_args_match_jax_local_conv(name):
    B, C, S, k, stride, pad, dg, max_off, split, halo = BLOCKS[name]
    nd = len(S)
    spec = DeformConvSpec.make(nd, k, stride, pad, 1, 1, dg)
    OS = spec.out_sizes(S)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, C) + S).astype(np.float32)
    off = rng.uniform(-max_off, max_off, (B, dg * nd * spec.tap_count) + OS
                      ).astype(np.float32)
    names = [None] * nd
    sizes = {}
    for d, n in split.items():
        names[d] = f"ax{d}"
        sizes[f"ax{d}"] = n
    w_shape = (C, C) + spec.kernel
    plan = sh.shard_plan(x.shape, off.shape, w_shape, None, None, spec,
                         sizes, None, names, max_off, halo)
    # The JAX package's own halo and shard sizes for the same call.
    for shd in plan.shards:
        want = (jsh.required_halo(_jspec(spec), max_off, shd.dim)
                if halo is None else halo)
        assert shd.halo == want
        assert shd.in_local == S[shd.dim] // split[shd.dim]
        assert shd.out_local == OS[shd.dim] // split[shd.dim]
    jshards = [jsh._SpatialShard(*s) for s in plan.shards]
    want = _jax_blocks(spec, x, off, jshards)
    lay = {2 + s.dim: s.axis_name for s in plan.shards}
    for coords, (x_ext, off_s, gates, pad_l, os_l) in want.items():
        block = sh.cut_block(torch.from_numpy(x), plan.shards, coords)
        np.testing.assert_array_equal(block.numpy(), x_ext)
        local, placement, got_gates = sh.block_args(
            spec, plan.shards, coords, tuple(block.shape[2:]))
        assert local.padding == tuple(pad_l)
        np.testing.assert_array_equal(np.asarray(got_gates, np.float32),
                                      gates)
        sl = sh.shard_slices(off.shape, lay, dict(zip(
            [s.axis_name for s in plan.shards], coords)), sizes)
        off_l = off[sl]
        # JAX's folded shift per offset channel (layout nd*f + d), against
        # the placement's shift less origin.
        shift = np.rint(off_s - off_l).reshape(
            off_l.shape[0], -1, nd, *off_l.shape[2:])
        for d, (sh_d, origin) in enumerate(placement):
            assert np.all(shift[:, :, d] == sh_d - origin), d
        for s in plan.shards:
            assert placement[s.dim][1] == coords[plan.shards.index(s)] * \
                s.in_local - s.halo
        assert tuple(off_l.shape[2:]) == os_l


# name: (x shape, kernel, stride, padding, groups, dg, O, mesh sizes,
#        batch_axis, spatial_axis, group_axis, halo)
ERRORS = {
    "misaligned_h": ((4, 4, 12, 8), 3, 1, 1, 2, 2, 4, (1, 8),
                     "data", "space", None, None),
    "stride_alignment": ((1, 4, 16, 8), 3, 1, 2, 1, 1, 4, (1, 2),
                         "data", "space", None, None),
    "indivisible_batch": ((3, 4, 16, 8), 3, 1, 1, 1, 1, 4, (2, 4),
                          "data", "space", None, None),
    "bad_group_axis": ((4, 4, 16, 8), 3, 1, 1, 2, 2, 4, (1, 8),
                       "data", None, "space", None),
    "too_many_spatial_names": ((4, 4, 16, 8), 3, 1, 1, 2, 2, 4, (1, 8),
                               "data", (None, None, "space"), None, None),
    "halo_sequence": ((4, 4, 16, 8), 3, 1, 1, 2, 2, 4, (1, 8),
                      "data", "space", None, (1, 1)),
}


def _jax_error(xs, k, stride, pad, g, dg, O, mesh_shape, batch_axis,
               spatial_axis, group_axis, halo):
    spec = JSpec.make(2, k, stride, pad, 1, g, dg, 64, True)
    OS = spec.out_sizes(xs[2:])
    x = jnp.zeros(xs, jnp.float32)
    off = jnp.zeros((xs[0], dg * 2 * spec.tap_count) + OS, jnp.float32)
    mask = jnp.zeros((xs[0], dg * spec.tap_count) + OS, jnp.float32)
    w = jnp.zeros((O, xs[1] // g) + spec.kernel, jnp.float32)
    mesh = jsh.make_mesh(mesh_shape, ("data", "space"))
    with pytest.raises(ValueError) as err:
        jsh.sharded_deform_conv(x, off, mask, w, None, spec, mesh,
                                batch_axis, spatial_axis, 0.0, halo,
                                group_axis)
    return str(err.value)


@pytest.mark.parametrize("name", list(ERRORS))
def test_value_errors_match_jax(name):
    xs, k, stride, pad, g, dg, O, mesh_shape, ba, sa, ga, halo = ERRORS[name]
    want = _jax_error(*ERRORS[name])
    spec = DeformConvSpec.make(2, k, stride, pad, 1, g, dg, modulated=True)
    OS = spec.out_sizes(xs[2:])
    K = spec.tap_count
    with pytest.raises(ValueError) as err:
        sh.shard_plan(xs, (xs[0], dg * 2 * K) + OS, (O, xs[1] // g, k, k),
                      (xs[0], dg * K) + OS, None, spec,
                      dict(zip(("data", "space"), mesh_shape)), ba, sa, 0.0,
                      halo, ga)
    assert str(err.value) == want


def _small(seed=0, C=16, S=(6, 6), dg=2, bound=1.0):
    rng = np.random.default_rng(seed)
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, dg, modulated=True)
    K = spec.tap_count
    ts = [torch.tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((1, C) + S),
        rng.uniform(-bound, bound, (1, dg * 2 * K) + S),
        rng.uniform(0, 1, (1, dg * K) + S),
        rng.standard_normal((8, C, 3, 3)) * 0.1, rng.standard_normal(8))]
    return spec, ts


def test_maybe_cuda_routes_block_mode_to_gathermm(monkeypatch):
    """With gate_bounds (or a given out_sizes) the kernel path is the
    gather kernels', even where shift-blend takes the config without them
    (C/dg = 8 with an offset bound); impl="shiftblend" raises."""
    spec, (x, off, mask, w, b) = _small()
    assert pcuda.select_kernel(x, spec, 1.0)[0] == "shiftblend"
    calls = []
    orig = gm.deform_conv_fused
    monkeypatch.setattr(gm, "deform_conv_fused", lambda *a, **k: (
        calls.append(a[6:]), orig(*a, **k))[1])
    monkeypatch.setattr(psb, "deform_conv_shift", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("shift-blend taken")))
    gates = ((0.0, 6.0), (-1.0, 5.5))
    got = pcuda.maybe_cuda(x, off, mask, w, b, spec, require=True,
                           offset_bound=1.0, impl="cuda", gate_bounds=gates)
    want = api._dispatch(x, off, mask, w, b, spec, "torch",
                         gate_bounds=gates)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert calls == [("tensorfloat32", None, gates, None)]
    # A given grid alone (3 rows where x gives 4) is the gather kernels'.
    local = DeformConvSpec.make(2, 3, 1, (0, 1), 1, 1, 2, modulated=True)
    pcuda.maybe_cuda(x, off[:, :, :3], mask[:, :, :3], w, b, local,
                     require=True, offset_bound=1.0, impl="cuda",
                     out_sizes=(3, 6))
    assert calls[-1] == ("tensorfloat32", (3, 6), None, None)
    # CPU tensors under "auto" take the plain path.
    assert pcuda.maybe_cuda(x, off, mask, w, b, spec, gate_bounds=gates) \
        is None
    for kw in ({"gate_bounds": gates}, {"out_sizes": (3, 6)}):
        with pytest.raises(NotImplementedError, match="shiftblend"):
            pcuda.maybe_cuda(x, off, mask, w, b, spec, require=True,
                             offset_bound=1.0, impl="shiftblend", **kw)


@pytest.mark.parametrize("gates", [
    ((-1.5, 6.0), (-1.0, 6.0)), ((-1.0, 6.5), (-1.0, 6.0)),
    ((2.0, 2.0), (-1.0, 6.0)), ((3.0, 1.0), (-1.0, 6.0)),
    ((-1.0, 6.0),)])
def test_gate_invariant_raises(gates):
    """-1 <= lo < hi <= S per dim, one pair per dim, or the wrappers raise
    (on CPU tensors too, before the plain version runs)."""
    spec, (x, off, mask, w, b) = _small()
    with pytest.raises(ValueError, match="gate_bounds"):
        lib.block_floats(spec, x.shape[2:], gates)
    with pytest.raises(ValueError, match="gate_bounds"):
        gm.fused_fwd(x, off, mask, w, b, spec, "float32", None, gates)
    with pytest.raises(ValueError, match="gate_bounds"):
        gm.cols_fwd(x, off, mask, spec, "float32", None, gates)
    assert lib.block_floats(spec, x.shape[2:]) == (-1.0, 6.0, -1.0, 6.0,
                                                   0.0, 0.0, 0.0, 0.0)
    # With a placement the gate moves by the block's origin.
    assert lib.block_floats(spec, x.shape[2:], ((2.0, 6.0), (-1.0, 6.0)),
                            ((5.0, 4.0), (0.0, 0.0))) == (
        6.0, 10.0, -1.0, 6.0, 5.0, 4.0, 0.0, 0.0)


def test_shiftblend_shard_layouts_raise():
    """impl="shiftblend" with a spatial split the lead mode does not take
    (max_offset 0, a W split) raises NotImplementedError naming the lead
    mode, before any exchange, as the JAX package raises for the layouts
    its lead mode does not take."""
    shards = (sh._SpatialShard(0, "space", 4, 3, 4, 4),)
    spec, (x, off, mask, w, b) = _small(S=(4, 6))
    for shards_, max_off in ((shards, 0.0),
                             ((sh._SpatialShard(1, "space", 2, 3, 3, 3),),
                              2.0)):
        with pytest.raises(NotImplementedError, match="lead mode"):
            sh._local_conv(x, off, mask, w, b, spec, shards_, None,
                           max_offset=max_off, impl="shiftblend")
