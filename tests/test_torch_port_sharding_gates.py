"""The gather kernels' sharded-block mode against the JAX package's, on the
CPU, with no process group.

A shard's block arguments (the exchanged block cut from the global tensor,
the shard's offsets, its output grid, its gate at the global border and
its placement, `sharding.cut_block` / `block_args`) go through the port's
dispatch with
impl="cuda" (on CPU tensors: the gather kernels' plain versions, fused
pair or columns path as `jax_fuse_ok` decides on the local grid) and
through the JAX package's `_dispatch(impl="pallas", out_sizes=...,
gate_bounds=...)` on the offsets with the global-to-local shift folded
in (the JAX package's sharding layer's form), its Pallas kernels in
interpret mode.  2D and 3D, a
shape JAX's `_fuse_ok` sends to the fused pair and one it sends to the
columns path; the output and all five gradients for one cotangent.
Float32; forward rtol = atol = 2e-5; every gradient within 1e-5 of
max|JAX gradient|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu.ops import api as japi
from modulated_deform_conv_tpu.ops.pallas import gathermm as jgm
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

from modulated_deform_conv_tpu_torch.ops import api
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

NAMES = ("x", "offset", "mask", "weight", "bias")

# name: (B, C, O, S, g, dg, split dim, shards, shard, max_offset, fused)
CASES = {
    "2d_fused_first": (2, 8, 8, (16, 8), 1, 1, 0, 4, 0, 1.5, True),
    "2d_columns_last": (1, 16, 16, (12, 8), 2, 1, 0, 2, 1, 1.0, False),
    "2d_fused_w": (1, 8, 8, (6, 16), 1, 1, 1, 2, 1, 1.0, True),
    "3d_fused_first": (1, 8, 8, (8, 4, 4), 1, 1, 0, 2, 0, 1.0, True),
    "3d_columns_last": (1, 16, 8, (8, 4, 4), 2, 1, 0, 2, 1, 1.0, False),
}


@functools.lru_cache(maxsize=None)
def _block(name):
    B, C, O, S, g, dg, dim, n, i, max_off, _ = CASES[name]
    nd = len(S)
    spec = DeformConvSpec.make(nd, 3, 1, 1, 1, g, dg, modulated=True)
    K = spec.tap_count
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-max_off, max_off, (B, dg * nd * K) + S),
            rng.uniform(0, 1, (B, dg * K) + S),
            rng.standard_normal((O, C // g) + (3,) * nd) * 0.2,
            rng.standard_normal((O,))]
    x, off, mask, w, b = (torch.tensor(a, dtype=torch.float32) for a in arrs)
    names = [None] * nd
    names[dim] = "space"
    plan = sh.shard_plan(x.shape, off.shape, w.shape, mask.shape, b.shape,
                         spec, {"space": n}, None, names, max_off)
    x_ext = sh.cut_block(x, plan.shards, [i])
    local, placement, gates = sh.block_args(spec, plan.shards, [i],
                                            tuple(x_ext.shape[2:]))
    sl = sh.shard_slices(off.shape, {2 + dim: "space"}, {"space": i},
                         {"space": n})
    off_l, mask_l = off[sl], mask[sl]
    delta = torch.tensor([a - o for a, o in placement])
    off_s = off_l + delta.repeat(off_l.shape[1] // nd).reshape(
        (1, -1) + (1,) * nd)
    OS = tuple(off_l.shape[2:])
    cot = rng.standard_normal((B, O) + OS).astype(np.float32)
    ins = [t.contiguous().numpy() for t in (x_ext, off_l, mask_l, w, b)]
    return local, OS, gates, placement, ins, off_s.contiguous().numpy(), cot


def _jspec(spec):
    return JSpec.make(spec.ndim, spec.kernel, spec.stride, spec.padding,
                      spec.dilation, spec.groups, spec.deformable_groups,
                      spec.in_step, spec.modulated)


@pytest.mark.parametrize("name", list(CASES))
def test_block_mode_matches_jax_pallas(name, monkeypatch):
    spec, OS, gates, placement, ins, off_s, cot = _block(name)
    fused = CASES[name][-1]
    lo, hi = gates[CASES[name][6]]
    assert lo > -1.0 or hi < ins[0].shape[2 + CASES[name][6]]  # cuts inside
    # The JAX package's fused-or-columns choice on the local grid, and the
    # port's copy of it.
    js = _jspec(spec)
    B, C = ins[0].shape[:2]
    O = ins[3].shape[0]
    plan = jgm._Plan(js, B, C, ins[0].shape[2:], OS, jnp.float32)
    assert jgm._fuse_ok(plan, C, spec.groups, O) == fused
    assert gm.jax_fuse_ok(torch.empty(ins[0].shape, device="meta"), spec, O,
                          OS) == fused
    calls = []
    kinds = ("fused_fwd", "fused_bwd") if fused else ("cols_fwd", "cols_bwd")
    for fn in kinds:
        orig = getattr(gm, fn)
        monkeypatch.setattr(gm, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append((_n, a[0].ndim - 2)), _f(*a, **k))[1])

    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    out = api._dispatch(*ts, spec, "cuda", "float32", out_sizes=OS,
                        gate_bounds=gates, block_origin=placement)
    out.backward(torch.from_numpy(cot))
    assert calls == [(k, spec.ndim) for k in kinds]

    def jop(*a):
        return japi._dispatch(*a, js, "pallas", "float32", out_sizes=OS,
                              gate_bounds=gates)
    want, vjp = jax.vjp(jop, *[jnp.asarray(a) for a in
                               (ins[0], off_s) + tuple(ins[2:])])
    want_grads = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for n, t, g in zip(NAMES, ts, want_grads):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert scale > 0, n
        np.testing.assert_allclose(t.grad.numpy() / scale, g / scale,
                                   rtol=0, atol=1e-5, err_msg=n)
