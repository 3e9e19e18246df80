"""The port's unfused columns path against the JAX package's.

The JAX package runs a general-offset config through its columns kernels
(`gathermm.py::fused_columns`: `_fwd_kernel` / `_bwd_kernel`) and an XLA
einsum GEMM wherever `_fuse_ok` is false: a channel slab straddles conv
groups, or the fused backward's VMEM footprint would pass 80 MB.  The port
decides the same way (`ops/cuda/plan.py::jax_fuse_ok`) and runs its column
kernels and a cuBLAS product there.  On the CPU the column wrappers run
their plain versions; these tests hold them, and the whole op, against the
JAX package's Pallas kernels in interpret mode.  Float32; forward rtol =
atol = 2e-5; gradients within 1e-5 of max|JAX gradient|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu as jmdc
from modulated_deform_conv_tpu.models import modules as jmod
from modulated_deform_conv_tpu.ops.pallas import gathermm as jgm
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.models import load_flax_params
from modulated_deform_conv_tpu_torch.ops.cuda import _jax_fuse_ok
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

from test_torch_port_3d_kernels import DISPATCH3D
from test_torch_port_kernels import DISPATCH


def _jspec(spec):
    return JSpec.make(spec.ndim, spec.kernel, spec.stride, spec.padding,
                      spec.dilation, spec.groups, spec.deformable_groups,
                      spec.in_step, spec.modulated)


# (B, C, O, S, k, stride, g, dg): BASELINE config 5 at B=32
# (benchmarks/suite.py:64-70), config 2, DCNResNet-50's DCN layers at B=8,
# 224x224 (c3-c5, the first of each stage at stride 2), ResNeXt-style
# grouped layers (g=32, dg=1), BASELINE configs 3 and 4, and config 3's
# shape with conv groups.
FUSE_SWEEP = [
    (32, 512, 512, (28, 28), 3, 1, 1, 1),       # cfg5 c3: fused
    (32, 1024, 1024, (14, 14), 3, 1, 1, 1),     # cfg5 c4: columns
    (32, 2048, 2048, (7, 7), 3, 1, 1, 1),       # cfg5 c5: columns
    (8, 256, 256, (56, 56), 3, 1, 4, 4),        # cfg2
    (8, 128, 128, (56, 56), 3, 2, 1, 1),        # DCNResNet-50 c3, block 0
    (8, 128, 128, (28, 28), 3, 1, 1, 1),
    (8, 256, 256, (28, 28), 3, 2, 1, 1),        # c4, block 0
    (8, 256, 256, (14, 14), 3, 1, 1, 1),
    (8, 512, 512, (14, 14), 3, 2, 1, 1),        # c5, block 0
    (8, 512, 512, (7, 7), 3, 1, 1, 1),
    (8, 256, 256, (28, 28), 3, 1, 32, 1),       # ResNeXt c3
    (8, 512, 512, (14, 14), 3, 1, 32, 1),       # ResNeXt c4
    (8, 1024, 1024, (7, 7), 3, 1, 32, 1),       # ResNeXt c5
    (2, 64, 64, (16, 32, 32), 3, 1, 1, 1),      # cfg3
    (4, 128, 128, (32, 64, 64), 3, 1, 1, 1),    # cfg4: NCP = 2
    (2, 64, 64, (16, 32, 32), 3, 1, 2, 1),      # cfg3 shape, g=2
    (2, 64, 64, (16, 32, 32), 3, 1, 4, 1),      # cfg3 shape, g=4
    (2, 16, 16, (9, 8), 3, 1, 2, 1),            # test_pallas_kernel.py:90
    (1, 16, 16, (5, 16, 16), 3, 1, 2, 1),       # test_pallas_kernel.py:294
] + [(B, C, C, S, k, stride, g, dg)
     for B, C, S, k, stride, _, g, dg, _, _ in DISPATCH] + [
    (B, C, C, S, k, 1, 1, 1) for B, C, S, k, _, _, _, _ in DISPATCH3D]


@pytest.mark.parametrize("case", FUSE_SWEEP)
def test_fuse_ok_matches_jax(case):
    """The port takes the columns path exactly where the JAX package's
    `_fuse_ok` sends its gathermm to the columns kernels."""
    B, C, O, S, k, stride, g, dg = case
    spec = DeformConvSpec.make(len(S), k, stride, k // 2, 1, g, dg,
                               modulated=True)
    js = _jspec(spec)
    plan = jgm._Plan(js, B, C, S, js.out_sizes(S), jnp.float32)
    xt = torch.empty((B, C) + S, device="meta")
    assert _jax_fuse_ok(xt, spec, O) == jgm._fuse_ok(plan, C, g, O)


# (seed, B, C, O, S, g, dg): the 2D columns case of
# tests/test_pallas_kernel.py:90 (g=2, dg=1) and the 3D planar one of
# :294 (g=2, dg=1); 3x3(x3) taps, stride 1, pad 1, mask and bias.
CASES = {
    "2d": (0, 2, 16, 16, (9, 8), 2, 1),
    "3d_planar": (1, 1, 16, 16, (5, 16, 16), 2, 1),
}
NAMES = ("x", "offset", "mask", "weight", "bias")


@functools.lru_cache(maxsize=None)
def _case(name):
    seed, B, C, O, S, g, dg = CASES[name]
    nd = len(S)
    spec = DeformConvSpec.make(nd, 3, 1, 1, 1, g, dg, modulated=True)
    K = spec.tap_count
    rng = np.random.default_rng(seed)
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-2.5, 2.5, (B, dg * nd * K) + S),
            "mask": rng.uniform(0, 1, (B, dg * K) + S),
            "weight": rng.standard_normal((O, C // g) + (3,) * nd) * 0.2,
            "bias": rng.standard_normal((O,))}
    arrs["offset"][0, 0, 0] = 7.0     # taps far outside the input
    arrs["mask"][0, 1] = 0.0          # a whole tap's mask plane at 0
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    cot = rng.standard_normal((B, O) + S).astype(np.float32)
    cols_cot = rng.standard_normal((B, dg, K, int(np.prod(S)), C // dg))
    return spec, arrs, cot, cols_cot.astype(np.float32)


def _to_jax_layout(cols, spec, B, C):
    """The port's columns (C * K, B * P), row c * K + k, as the JAX
    package's (B, dg, K, P, Cg)."""
    dg, K = spec.deformable_groups, spec.tap_count
    return cols.reshape(dg, C // dg, K, B, -1).permute(3, 0, 2, 4, 1)


def _assert_grads_close(got, want):
    for n in want:
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(got[n] / scale, want[n] / scale, rtol=0,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("name", list(CASES))
def test_columns_match_jax_fused_columns(name):
    """The port's columns (the plain version the wrappers run on CPU
    tensors) against `fused_columns`, the JAX package's columns kernels in
    interpret mode, and their VJP for one cotangent."""
    spec, arrs, _, cols_cot = _case(name)
    js = _jspec(spec)
    B, C = arrs["x"].shape[:2]
    plan = jgm._Plan(js, B, C, arrs["x"].shape[2:],
                     js.out_sizes(arrs["x"].shape[2:]), jnp.float32)
    assert not jgm._fuse_ok(plan, C, spec.groups, arrs["weight"].shape[0])
    assert plan.planar == (name == "3d_planar")
    gates = jnp.zeros((0,), jnp.float32)

    def jcols(x, off, m):
        return jgm.fused_columns(x, off, m, gates, js, "float32", None)

    jins = [jnp.asarray(arrs[n]) for n in NAMES[:3]]
    want, vjp = jax.vjp(jcols, *jins)
    want_grads = jax.jit(vjp)(jnp.asarray(cols_cot))

    ts = [torch.tensor(arrs[n], requires_grad=True) for n in NAMES[:3]]
    cols = gm.cols_fwd(*[t.detach() for t in ts], spec, "float32")
    np.testing.assert_allclose(_to_jax_layout(cols, spec, B, C).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    gcols = torch.from_numpy(cols_cot).permute(1, 4, 2, 0, 3).reshape(
        cols.shape).contiguous()
    got = gm.cols_bwd(*[t.detach() for t in ts], gcols, spec, "float32")
    _assert_grads_close(
        {n: g.numpy() for n, g in zip(NAMES, got)},
        {n: np.asarray(g) for n, g in zip(NAMES, want_grads)})


@pytest.mark.parametrize("name", list(CASES))
def test_columns_path_op_matches_jax(name, monkeypatch):
    """The whole op through impl="cuda" on CPU tensors (the columns path:
    the column wrappers' plain versions inside `_GathermmCols`, then the
    grouped product and the bias) against the JAX package's
    impl="pallas" (its columns kernels and XLA GEMM): the output and all
    five gradients."""
    spec, arrs, cot, _ = _case(name)
    calls = []
    for fn in ("cols_fwd", "cols_bwd"):
        orig = getattr(gm, fn)
        monkeypatch.setattr(gm, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append((_n, a[0].ndim - 2)), _f(*a, **k))[1])
    nd = spec.ndim
    op = (mdt.modulated_deform_conv2d, mdt.modulated_deform_conv3d)[nd - 2]
    jop = (jmdc.modulated_deform_conv2d, jmdc.modulated_deform_conv3d)[nd - 2]
    kw = dict(padding=1, groups=spec.groups,
              deformable_groups=spec.deformable_groups)

    ts = [torch.tensor(arrs[n], requires_grad=True) for n in NAMES]
    out = op(*ts, **kw, impl="cuda", precision="float32")
    out.backward(torch.from_numpy(cot))
    assert calls == [("cols_fwd", nd), ("cols_bwd", nd)]

    want, vjp = jax.vjp(lambda *a: jop(*a, **kw, impl="pallas",
                                       precision="float32"),
                        *[jnp.asarray(arrs[n]) for n in NAMES])
    want_grads = jax.jit(vjp)(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    _assert_grads_close(
        {n: t.grad.numpy() for n, t in zip(NAMES, ts)},
        {n: np.asarray(g) for n, g in zip(NAMES, want_grads)})


def test_grouped_pack_matches_flax():
    """ModulatedDeformConv2dPack(groups=2) on the columns path (impl="cuda",
    CPU tensors) against the flax module with impl="pallas", weights
    carried over by `load_flax_params`."""
    cin, cout = 16, 12
    fm = jmod.ModulatedDeformConv2dPack(
        in_channels=cin, out_channels=cout, kernel_size=3, padding=1,
        groups=2, use_bias=True, impl="pallas")
    tm = mdt.ModulatedDeformConv2dPack(cin, cout, 3, padding=1, groups=2,
                                       bias=True, impl="cuda", device="cpu")
    x = np.random.default_rng(5).standard_normal((2, cin, 9, 8)).astype(
        np.float32)
    variables = fm.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["bias"] = np.linspace(-0.5, 0.5, cout, dtype=np.float32)
    variables = {"params": params}
    load_flax_params(tm, variables)
    want = fm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
