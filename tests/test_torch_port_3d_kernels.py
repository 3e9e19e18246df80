"""The port's 3D kernel modules and dispatch against the JAX package's.

The same inputs and cotangent, made from a numpy seed, go through the
port's 3D op on CPU tensors (impl="shiftblend" and impl="cuda": each
autograd Function runs its kernels' plain versions) and through `jax.vjp`
of the JAX op at precision "float32", its Pallas kernels in interpret mode:

* shift-blend on the loop path (`_fwd_kernel_loop` / `_bwd_kernel_loop`):
  1 x 8 x (4, 8, 16) at bound 0.5, 729 (tap, window) pairs and a plane of
  128, with offsets beyond the bound whose corners drop;
* gathermm in its 3D planar mode: 1 x 16 x (5, 16, 16), offsets U[-2, 2];
* a 5 x 5 x 5 kernel through the port's impl="shiftblend" against JAX's
  plain impl="xla", offsets inside the bound 0.5 and off +-0.5, so that the
  window drops nothing and both compute the same function;
* an unbounded 5 x 5 x 5 kernel through the port's impl="cuda" (the gather
  pair) against JAX's impl="xla", offsets U[-2, 2].

The plain versions (`shiftblend_bwd_reference`, `gathermm_bwd_reference`)
are also held against the same JAX gradients on their own.  Each JAX result
is computed once per file (the loop path takes ~45 s in interpret mode).
Tolerance: forward rtol = atol = 2e-5; each gradient (x, offset, mask,
weight, bias) divided by max|JAX gradient| within 1e-5.

The dispatch test holds the port's `select_kernel` against the JAX
package's choice on 3D shapes, built from its `ineligible_reason`s and
`_prefer_shiftblend` as `maybe_pallas` combines them on a TPU, and the
port's copy of the planar-mode decision against `gathermm._Plan`; a sweep
on meta tensors holds the port's 3D shift-blend rule at least as wide as
JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu as jmdc
from modulated_deform_conv_tpu.ops import pallas as jpl
from modulated_deform_conv_tpu.ops.pallas import gathermm as jgm
from modulated_deform_conv_tpu.ops.pallas import shiftblend as jsb
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.ops.cuda import _jax_planar
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import select_kernel
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

ATOL = 1e-5
NAMES = ("x", "offset", "mask", "weight", "bias")


def _beyond_bound(a):
    """At bound 0.5 the window keeps corner rows -1..1 of each axis: an
    offset of 1.3 keeps its low corner and drops its high one, -1.4 the
    reverse, and 5 or -40 (far outside the volume) drop the tap."""
    off = a["offset"]
    off[0, 3 * 13 + 0, 1, 2, 3] = 1.3      # centre tap, axis z
    off[0, 3 * 13 + 1, 2, 3, 4] = -1.4     # centre tap, axis y
    off[0, 3 * 4 + 2, 2, 5, 9] = 1.25      # tap 4, axis x
    off[0, 3 * 0 + 0, 3, 0, 0] = 5.0
    off[0, 3 * 26 + 2, 0, 7, 15] = -40.0


# name -> (seed, B, C, S, offscale, edit, impl, bound)
CASES = {
    "loop_path": (0, 1, 8, (4, 8, 16), 0.45, _beyond_bound, "shiftblend",
                  0.5),
    "planar": (1, 1, 16, (5, 16, 16), 2.0, None, "pallas", None),
}


def _case(seed, B, C, S, offscale, edit):
    rng = np.random.default_rng(seed)
    K = 27
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-offscale, offscale, (B, 3 * K) + S),
            "mask": rng.uniform(0, 1, (B, K) + S),
            "weight": rng.standard_normal((C, C, 3, 3, 3)) * 0.1,
            "bias": rng.standard_normal((C,))}
    if edit is not None:
        edit(arrs)
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    return arrs, rng.standard_normal((B, C) + S).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """Inputs, cotangent, and the JAX op's output and gradients."""
    seed, B, C, S, offscale, edit, impl, bound = CASES[name]
    arrs, cot = _case(seed, B, C, S, offscale, edit)

    def f(*a):
        return jmdc.modulated_deform_conv3d(*a, padding=1, impl=impl,
                                            precision="float32",
                                            offset_bound=bound)

    out, vjp = jax.vjp(f, *[jnp.asarray(arrs[n]) for n in NAMES])
    grads = jax.jit(vjp)(jnp.asarray(cot))
    return (arrs, cot, np.asarray(out),
            {n: np.asarray(g) for n, g in zip(NAMES, grads)})


def _port(arrs, cot, impl, bound, padding=1):
    ts = {n: torch.tensor(a, requires_grad=True) for n, a in arrs.items()}
    out = mdt.modulated_deform_conv3d(*[ts[n] for n in NAMES],
                                      padding=padding, impl=impl,
                                      offset_bound=bound)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), {n: t.grad.numpy() for n, t in ts.items()}


def _reference_grads(ref_fn, arrs, cot, *extra):
    spec = DeformConvSpec.make(3, 3, 1, 1, 1, 1, 1, modulated=True)
    t = {n: torch.from_numpy(a) for n, a in arrs.items()}
    gx, goff, gmask, gw = ref_fn(t["x"], t["offset"], t["mask"], t["weight"],
                                 torch.from_numpy(cot), spec, "float32",
                                 *extra)
    return {"x": gx.numpy(), "offset": goff.numpy(), "mask": gmask.numpy(),
            "weight": gw.numpy(), "bias": cot.sum((0, 2, 3, 4))}


def _assert_close(got, want):
    assert set(got) == set(want)
    for n in want:
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(got[n] / scale, want[n] / scale, rtol=0,
                                   atol=ATOL, err_msg=n)


def test_shiftblend3d_matches_jax_loop_path():
    seed, B, C, S, *_ = CASES["loop_path"]
    spec = JSpec.make(3, 3, 1, 1, 1, 1, 1, modulated=True)
    plan = jsb.SBPlan(spec, B, C, S, S, 0.5)
    assert not plan.unrolled and plan.n_pairs == 729   # rows 5-6
    arrs, cot, want_out, want = _jax("loop_path")
    out, grads = _port(arrs, cot, "shiftblend", 0.5)
    np.testing.assert_allclose(out, want_out, rtol=2e-5, atol=2e-5)
    _assert_close(grads, want)
    _assert_close(_reference_grads(sb.shiftblend_bwd_reference, arrs, cot,
                                   0.5), want)
    # The dropped corners matter: the unbounded op differs.
    full = _reference_grads(gm.gathermm_bwd_reference, arrs, cot)
    assert not np.allclose(full["offset"], want["offset"], atol=1e-3)


def test_gathermm3d_matches_jax_planar():
    seed, B, C, S, *_ = CASES["planar"]
    spec = JSpec.make(3, 3, 1, 1, 1, 1, 1, modulated=True)
    assert jgm._Plan(spec, B, C, S, S, jnp.float32).planar
    arrs, cot, want_out, want = _jax("planar")
    out, grads = _port(arrs, cot, "cuda", None)
    np.testing.assert_allclose(out, want_out, rtol=2e-5, atol=2e-5)
    _assert_close(grads, want)
    _assert_close(_reference_grads(gm.gathermm_bwd_reference, arrs, cot),
                  want)


def test_shiftblend3d_5x5x5_matches_jax():
    """125 taps at bound 0.5: 3,375 (tap, window) pairs, the loop path on a
    128-aligned plane.  The port's impl="shiftblend" (the kernel pair's
    plain versions on CPU tensors) against JAX's impl="xla"."""
    rng = np.random.default_rng(7)
    B, C, S, K = 1, 8, (3, 8, 16), 125
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-0.45, 0.45, (B, 3 * K) + S),
            "mask": rng.uniform(0, 1, (B, K) + S),
            "weight": rng.standard_normal((C, C, 5, 5, 5)) * 0.05,
            "bias": rng.standard_normal((C,))}
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    cot = rng.standard_normal((B, C) + S).astype(np.float32)
    spec = DeformConvSpec.make(3, 5, 1, 2, 1, 1, 1, modulated=True)
    xt = torch.empty((B, C) + S, device="meta")
    assert sb.ineligible_reason(xt, spec, 0.5) is None

    def f(*a):
        return jmdc.modulated_deform_conv3d(*a, padding=2, impl="xla",
                                            precision="float32")

    want_out, vjp = jax.vjp(f, *[jnp.asarray(arrs[n]) for n in NAMES])
    want = {n: np.asarray(g) for n, g in
            zip(NAMES, vjp(jnp.asarray(cot)))}
    out, grads = _port(arrs, cot, "shiftblend", 0.5, padding=2)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    _assert_close(grads, want)


def test_gathermm3d_5x5x5_matches_jax():
    """125 taps without a bound: the port's impl="cuda" takes the gather
    pair (on CPU tensors its autograd Function runs the kernels' plain
    versions), as JAX's maybe_pallas takes its gathermm kernel, and agrees
    with JAX's impl="xla"."""
    rng = np.random.default_rng(8)
    B, C, S, K = 1, 8, (4, 6, 8), 125
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-2.0, 2.0, (B, 3 * K) + S),
            "mask": rng.uniform(0, 1, (B, K) + S),
            "weight": rng.standard_normal((C, C, 5, 5, 5)) * 0.05,
            "bias": rng.standard_normal((C,))}
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    cot = rng.standard_normal((B, C) + S).astype(np.float32)
    spec = DeformConvSpec.make(3, 5, 1, 2, 1, 1, 1, modulated=True)
    js = JSpec.make(3, 5, 1, 2, 1, 1, 1, modulated=True)
    assert jgm.ineligible_reason(jax.ShapeDtypeStruct((B, C) + S,
                                                      jnp.float32), js) is None
    assert select_kernel(torch.empty((B, C) + S, device="meta"), spec,
                         None) == ("gathermm", None)

    def f(*a):
        return jmdc.modulated_deform_conv3d(*a, padding=2, impl="xla",
                                            precision="float32")

    want_out, vjp = jax.vjp(f, *[jnp.asarray(arrs[n]) for n in NAMES])
    want = {n: np.asarray(g) for n, g in
            zip(NAMES, vjp(jnp.asarray(cot)))}
    out, grads = _port(arrs, cot, "cuda", None, padding=2)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    _assert_close(grads, want)


# (B, C, S, k, pad, dil, bound, dtype)
DISPATCH3D = [
    (4, 128, (32, 64, 64), 3, 1, 1, 2.0, "float32"),   # cfg4: shift-blend
    (2, 64, (16, 32, 32), 3, 1, 1, 2.0, "float32"),    # cfg3: planar gathermm;
    # H100: shift-blend (H100_DIVERGES3D)
    (8, 64, (16, 56, 56), 3, 1, 1, None, "float32"),   # DCNVideoNet s1b0
    (8, 128, (16, 28, 28), 3, 1, 1, None, "float32"),  # DCNVideoNet s2b0
    (2, 64, (16, 32, 32), 3, 1, 1, 0.5, "float32"),    # narrow bound
    (2, 32, (6, 20, 20), 3, 1, 1, 2.0, "float32"),     # plane 400 at bound 2
    (2, 32, (6, 9, 7), 2, 1, 2, 0.5, "bfloat16"),      # 216 pairs, any plane
    (2, 256, (8, 16, 16), 3, 1, 1, 1.0, "float32"),    # C/dg above crossover;
    # H100: shift-blend
    (1, 16, (5, 16, 16), 3, 1, 1, 1.0, "float16"),     # planar, bound < 1.5
    (2, 16, (8, 16, 16), 3, 1, 1, 1.5, "float32"),     # planar at bound 1.5;
    # H100: shift-blend
    (1, 8, (128, 128, 128), 3, 1, 1, 2.0, "float32"),  # streamed: not planar
    (1, 16, (8, 6, 7), 3, 1, 1, 2.0, "float32"),       # plane 42: not planar
    (1, 32, (8, 16, 16), 5, 2, 1, 1.0, "float32"),     # 5x5x5: 3,375 pairs
    (1, 32, (8, 16, 16), 5, 2, 1, None, "float32"),    # 5x5x5 unbounded
    (2, 64, (16, 32, 32), 5, 2, 1, None, "float32"),   # 5x5x5 at cfg3's size
]
# The DISPATCH3D cases where the H100 profile takes another pair than the
# JAX package on purpose (utils/device.py, measured by calibrate.py on the
# card on captured chains), and the pair it takes: planar gathermm only
# from bound 2.5 (the 3D shift-blend pair is 12-13% ahead at bounds
# 0.5-2.0, the 3D gather pair 1.6-2.4% ahead at 2.5), and shift-blend up
# to C/dg 256.  Held by tests/test_torch_port_device.py.
H100_DIVERGES3D = {
    (2, 64, (16, 32, 32), 3, 1, 1, 2.0, "float32"): "shiftblend",
    (2, 256, (8, 16, 16), 3, 1, 1, 1.0, "float32"): "shiftblend",
    (2, 16, (8, 16, 16), 3, 1, 1, 1.5, "float32"): "shiftblend",
}


@pytest.mark.parametrize("case", DISPATCH3D)
def test_dispatch3d_matches_jax(case):
    """The kernel the port takes on a CUDA tensor is the one JAX's
    maybe_pallas takes on its TPU, and shift-blend eligibility agrees
    (with the same reason where the plane is not 128-aligned)."""
    B, C, S, k, pad, dil, bound, dtype = case
    spec = DeformConvSpec.make(3, k, 1, pad, dil, 1, 1, modulated=True)
    js = JSpec.make(3, k, 1, pad, dil, 1, 1, modulated=True)
    xj = jax.ShapeDtypeStruct((B, C) + S, jnp.dtype(dtype))
    sb_reason_j = jsb.ineligible_reason(xj, js, bound)
    reason_j = jgm.ineligible_reason(xj, js)
    want = None
    if sb_reason_j is None:
        plan = jsb.SBPlan(js, B, C, S, js.out_sizes(S), bound)
        if reason_j is not None or jpl._prefer_shiftblend(xj, js, plan):
            want = "shiftblend"
    if want is None and reason_j is None:
        want = "gathermm"
    xt = torch.empty((B, C) + S, dtype=getattr(torch, dtype), device="meta")
    assert select_kernel(xt, spec, bound)[0] == want
    assert _jax_planar(xt, spec) == jgm._Plan(js, B, C, S, js.out_sizes(S),
                                              jnp.float32).planar
    sb_reason = sb.ineligible_reason(xt, spec, bound)
    assert (sb_reason is None) == (sb_reason_j is None)
    if "128-aligned" in (sb_reason_j or ""):
        assert sb_reason == sb_reason_j


@pytest.mark.parametrize("S", [(4, 8, 16), (8, 16, 16), (32, 64, 64)])
@pytest.mark.parametrize("k,dilation", [(1, 1), (1, 2), (2, 2), (3, 1),
                                        (3, 2), (5, 1), (5, 2)])
def test_shiftblend_3d_rule_as_wide_as_jax(k, dilation, S):
    """Every size-preserving 3D config that JAX's shift-blend rule accepts,
    the port's accepts too, over bounds 0.5-3.5 and C/dg 8-256 at dg = 2: a
    narrower port rule would send bounded configs to the gather pair, whose
    results differ wherever offsets pass the bound.  Read from the port's
    side (where the port refuses, JAX must refuse), since JAX's rule builds
    its shift plan in Python, up to seconds a call on a 5x5x5 window, and
    the port's is cheap."""
    pad = dilation * (k - 1) // 2
    spec = DeformConvSpec.make(3, k, 1, pad, dilation, 1, 2, modulated=True)
    js = JSpec.make(3, k, 1, pad, dilation, 1, 2, modulated=True)
    for bound in (0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5):
        for cdg in (8, 32, 128, 256):
            shape = (2, 2 * cdg) + S
            xt = torch.empty(shape, dtype=torch.float32, device="meta")
            if sb.ineligible_reason(xt, spec, bound) is None:
                continue
            xj = jax.ShapeDtypeStruct(shape, jnp.float32)
            assert jsb.ineligible_reason(xj, js, bound) is not None, (bound,
                                                                      cdg)
    # The sweep is not empty on JAX's side: it takes the narrowest config.
    xj = jax.ShapeDtypeStruct((2, 16) + S, jnp.float32)
    assert jsb.ineligible_reason(xj, js, 0.5) is None
