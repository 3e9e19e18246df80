"""The port's kernel modules (ops/cuda/) against the JAX package's kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those plain versions against the JAX Pallas kernels in interpret mode
(at tests/test_smoke.py sizes), and the port's dispatch against JAX's.  The
CUDA kernels themselves are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_port_cuda.py.  Tolerance: 2e-5.
"""
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
from modulated_deform_conv_tpu_torch.ops import api, core
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import select_kernel
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec


def _inputs(seed, B, C, S, k, dg, modulated, offscale, g=1, O=None):
    rng = np.random.default_rng(seed)
    O = O or C
    spec = DeformConvSpec.make(2, k, 1, k // 2, 1, g, dg, modulated=modulated)
    OS = spec.out_sizes(S)
    K = spec.tap_count
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-offscale, offscale, (B, dg * 2 * K) + OS),
            rng.uniform(0, 1, (B, dg * K) + OS) if modulated else None,
            rng.standard_normal((O, C // g, k, k)) * 0.1,
            rng.standard_normal((O,))]
    return spec, [None if a is None else a.astype(np.float32) for a in arrs]


def _jspec(spec):
    return JSpec.make(spec.ndim, spec.kernel, spec.stride, spec.padding,
                      spec.dilation, spec.groups, spec.deformable_groups,
                      spec.in_step, spec.modulated)


def _t(arrs, dtype=torch.float32):
    return [None if a is None else torch.tensor(a, dtype=dtype) for a in arrs]


def _j(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("bound,modulated,drops", [
    (1.0, True, True),       # integer bound: W = 2b+1, corners beyond drop
    (0.6, False, False),     # fractional bound, all offsets inside it
])
def test_shiftblend_reference_matches_pallas(bound, modulated, drops):
    """shiftblend_fwd_reference against the interpret-mode Pallas kernel,
    including the bounded contract's per-axis corner drops: at off = b+0.5
    one corner of the axis survives with weight 0.5, at off = 5 none."""
    spec, arrs = _inputs(0, 1, 8, (6, 7), 3, 1, modulated, 0.9 * bound)
    x, off, mask, w, bias = arrs
    if drops:
        off[0, 8, 2, 3] = bound + 0.5      # tap 4, axis 0: high corner drops
        off[0, 9, 3, 3] = -(bound + 0.5)   # tap 4, axis 1: low corner drops
        off[0, 0, 1, 1] = 5.0              # tap 0, axis 0: both drop
        off[0, 3, 4, 5] = bound + 0.5      # tap 1, axis 1
        off[0, 16, 5, 6] = -5.0            # tap 8, axis 0
    got = sb.fwd(*_t([x, off, mask, w, bias]), spec, "float32", bound)
    jx, joff, jm, jw, jb = _j([x, off, mask, w, bias])
    want = jax.jit(lambda *a: jsb.shift_conv_fwd_only(
        *a, _jspec(spec), "float32", bound))(jx, joff, jm, jw, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if drops:
        # The dropped corners matter: the general op (no window) differs.
        full = core._deform_conv_nd(*_t([x, off, mask, w, bias]), spec)
        assert not torch.allclose(got, full, rtol=1e-3, atol=1e-3)


def test_gathermm_reference_matches_pallas():
    spec, arrs = _inputs(1, 1, 8, (6, 7), 3, 1, True, 2.5)
    x, off, mask, w, bias = arrs
    got = gm.fused_fwd(*_t(arrs), spec, "float32")
    want = jax.jit(lambda *a: jmdc.modulated_deform_conv2d(
        *a, stride=1, padding=1, impl="pallas", precision="float32"))(
        *_j(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_mode_rounds_operands():
    """precision="bfloat16": the plain versions round columns and weights to
    bf16 and accumulate in fp32, within bf16 error of the fp32 result."""
    spec, arrs = _inputs(2, 2, 16, (5, 6), 3, 2, True, 1.5)
    t = _t(arrs)
    ref = gm.fused_fwd(*t, spec, "float32")
    for out in (gm.fused_fwd(*t, spec, "bfloat16"),
                sb.fwd(*t, spec, "bfloat16", 2.0)):
        assert not torch.equal(out, ref)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


# (B, C, S, k, stride, pad, g, dg, bound, dtype)
DISPATCH = [
    (8, 256, (56, 56), 3, 1, 1, 4, 4, 2.0, "float32"),    # bench cfg2
    (8, 256, (56, 56), 3, 1, 1, 4, 4, None, "float32"),
    (2, 512, (14, 14), 3, 1, 1, 1, 1, 2.0, "float32"),    # C/dg > 256
    (2, 384, (14, 14), 3, 1, 1, 2, 2, 1.0, "bfloat16"),   # above crossover;
    # H100: shift-blend (H100_DIVERGES)
    (2, 64, (12, 12), 3, 2, 1, 1, 2, 2.0, "float32"),     # stride 2
    (2, 64, (12, 12), 3, 1, 0, 1, 2, 2.0, "float16"),     # OS != S
    (2, 24, (12, 12), 3, 1, 1, 1, 2, 2.0, "float32"),     # C/dg % 8 != 0
    (2, 32, (12, 12), 3, 1, 1, 4, 2, 2.0, "float32"),     # dg % g != 0
    (2, 32, (12, 12), 5, 1, 2, 2, 2, 0.5, "float16"),
    (1, 8, (3, 4, 5), 1, 1, 0, 1, 1, 1.0, "float32"),     # 3D, k=1
    (2, 64, (10, 19), 5, 1, 2, 2, 2, 2.5, "float32"),     # 1,225 pairs in 2D
    (2, 64, (10, 19), 5, 1, 2, 2, 2, 1.5, "float32"),     # 625 pairs
    (32, 1024, (14, 14), 3, 1, 1, 1, 1, None, "float32"),  # cfg5 c4: columns
    (2, 64, (9, 8), 3, 1, 1, 2, 1, 1.0, "float32"),       # g > dg: columns
]
# The DISPATCH cases where the H100 profile (utils/device.py, measured by
# calibrate.py on the card on captured chains) takes another pair than the
# JAX package on purpose, and the pair it takes: C/dg 192 is within the
# H100 crossover (256), where shift-blend's step is 4-9% ahead at every
# C/dg of 8-256.  Held by tests/test_torch_port_device.py.
H100_DIVERGES = {(2, 384, (14, 14), 3, 1, 1, 2, 2, 1.0, "bfloat16"):
                 "shiftblend"}


@pytest.mark.parametrize("case", DISPATCH)
def test_dispatch_matches_jax(case):
    """The kernel the port takes on a CUDA tensor is the one JAX's
    maybe_pallas takes on its TPU, and the shift-blend reasons agree.
    (Configs chosen away from JAX's TPU-only VMEM and unroll rules, and its
    MXU rule C/dg >= 8, which the CUDA kernel does not need.)"""
    B, C, S, k, stride, pad, g, dg, bound, dtype = case
    nd = len(S)
    spec = DeformConvSpec.make(nd, k, stride, pad, 1, g, dg, modulated=True)
    js = _jspec(spec)
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
    assert sb.ineligible_reason(xt, spec, bound) == sb_reason_j
    assert (gm.ineligible_reason(xt, spec) is None) == (reason_j is None)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("dilation", [1, 2])
def test_shiftblend_2d_rule_as_wide_as_jax(k, dilation):
    """Every 2D config that JAX's shift-blend rule accepts, the port's
    accepts too, over bounds 0.5-3.5 and C/dg 8-256 at dg = 2: a narrower
    port rule would send bounded configs to the gather pair, whose results
    differ wherever offsets pass the bound."""
    accepted = 0
    for bound in (0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5):
        for cdg in (8, 16, 32, 64, 128, 256):
            spec = DeformConvSpec.make(2, k, 1, dilation * (k - 1) // 2,
                                       dilation, 1, 2, modulated=True)
            shape = (2, 2 * cdg, 16, 16)
            xj = jax.ShapeDtypeStruct(shape, jnp.float32)
            if jsb.ineligible_reason(xj, _jspec(spec), bound) is not None:
                continue
            accepted += 1
            xt = torch.empty(shape, dtype=torch.float32, device="meta")
            assert sb.ineligible_reason(xt, spec, bound) is None, (
                k, dilation, bound, cdg)
    assert accepted > 0


@pytest.mark.parametrize("hw,halo", [((56, 56), True), ((48, 48), True),
                                     ((32, 64), True), ((32, 32), False),
                                     ((28, 28), False), ((14, 14), False)])
def test_shiftblend_halo_route(hw, halo):
    """The 2D shift-blend forward stages its halo only on planes of at
    least 2048 positions: config 2's 56 x 56, not DCNResNet-50's 28 x 28
    and 14 x 14."""
    assert sb.halo_route(hw) is halo


def test_offsets_within_bound_matches_jax():
    rng = np.random.default_rng(3)
    off = rng.uniform(-1.2, 1.2, (1, 36, 4, 4)).astype(np.float32)
    off[0, 1::2] *= 0.5                       # axis 1 stays within 0.6
    for bound in (1.3, 1.0, (1.3, 0.6), (1.0, 0.7), (1.3, 0.5)):
        got = bool(sb.offsets_within_bound(torch.from_numpy(off), bound))
        assert got == bool(jsb.offsets_within_bound(jnp.asarray(off), bound))


def test_fp16_upcast_and_fp64_policy():
    spec, arrs = _inputs(4, 1, 8, (5, 5), 3, 1, True, 0.8)
    x, off, mask, w, bias = _t(arrs)
    args = (1, 1, 1, 1, 1)
    ref = core.deform_conv_nd(x, off, mask, w, bias, spec)
    for impl, kw in (("cuda", {}), ("shiftblend", {"offset_bound": 1.0})):
        out = mdt.modulated_deform_conv2d(
            *_t(arrs, torch.float16), *args, impl=impl, **kw)
        assert out.dtype == torch.float16
        torch.testing.assert_close(out.float(), ref, rtol=5e-3, atol=5e-3)
    x64 = _t(arrs, torch.float64)
    for impl, kw in (("cuda", {}), ("shiftblend", {"offset_bound": 1.0})):
        with pytest.raises(NotImplementedError, match="dtype"):
            mdt.modulated_deform_conv2d(*x64, *args, impl=impl, **kw)
    out = mdt.modulated_deform_conv2d(*x64, *args, impl="auto",
                                      offset_bound=1.0)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out.float(), ref, rtol=2e-5, atol=2e-5)


def test_kernel_path_raises_where_not_ported():
    spec, arrs = _inputs(5, 1, 8, (5, 5), 3, 1, True, 0.8)
    x, off, mask, w, bias = _t(arrs)
    # The kernel path's backward is ported, in 2D and 3D: it runs and
    # matches autograd of the plain path.  gate_bounds take the gather
    # kernels (their plain versions here), shift-blend refuses them.
    grads = []
    for impl in ("cuda", "torch"):
        xg = x.clone().requires_grad_(True)
        out = mdt.modulated_deform_conv2d(xg, off, mask, w, bias, 1, 1,
                                          impl=impl)
        (out * out).sum().backward()
        grads.append(xg.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    gates = ((0.5, 5.0), (-1.0, 3.5))
    torch.testing.assert_close(
        api._dispatch(x, off, mask, w, bias, spec, "cuda",
                      gate_bounds=gates),
        api._dispatch(x, off, mask, w, bias, spec, "torch",
                      gate_bounds=gates), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="gate_bounds"):
        api._dispatch(x, off, mask, w, bias, spec, "shiftblend",
                      offset_bound=1.0, gate_bounds=gates)
    x3 = torch.ones((1, 8, 3, 3, 3))
    off3 = torch.zeros((1, 81, 3, 3, 3))
    w3 = torch.ones((8, 8, 3, 3, 3))
    grads3 = []
    for impl in ("cuda", "torch"):
        xg = x3.clone().requires_grad_(True)
        out = mdt.deform_conv3d(xg, off3, w3, None, 1, 1, impl=impl)
        (out * out).sum().backward()
        grads3.append((out.detach(), xg.grad))
    for got, want in zip(*grads3):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="shiftblend"):
        mdt.deform_conv2d(x.detach(), off, w, None, 1, 1, impl="shiftblend")
    # CPU tensors under "auto" take the plain path, 3D included.
    assert mdt.deform_conv3d(x3, off3, w3, None, 1, 1).shape == (1, 8, 3, 3,
                                                                  3)


def test_debug_check_bounds_warns():
    spec, arrs = _inputs(6, 1, 8, (5, 5), 3, 1, True, 0.8)
    x, off, mask, w, bias = _t(arrs)
    off[0, 0, 0, 0] = 3.0
    with pytest.warns(UserWarning, match="offset_bound"):
        mdt.modulated_deform_conv2d(x, off, mask, w, bias, 1, 1,
                                    offset_bound=1.0, debug_check_bounds=True)
