"""The backward of the port's kernel paths against the JAX package's Pallas
backward kernels.

The same inputs and the same cotangent, made from a numpy seed, go through
the port's impl="cuda" (general gather) and impl="shiftblend" ops on CPU
tensors, where each autograd Function runs its kernels' plain versions,
and through `jax.vjp` of the JAX op with impl="pallas" / "shiftblend",
precision="float32", in Pallas interpret mode.  The plain versions
(`gathermm_bwd_reference`, `shiftblend_bwd_reference`) are also held
against the same JAX gradients on their own.

Tolerance: every gradient (x, offset, mask, weight, bias), divided by
max|JAX gradient|, agrees within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu as jmdc

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

ATOL = 1e-5
NAMES = ("x", "offset", "mask", "weight", "bias")


def _case(seed, B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias,
          offscale, edit=None):
    rng = np.random.default_rng(seed)
    spec = DeformConvSpec.make(2, k, stride, pad, dil, g, dg,
                               modulated=modulated)
    OS = spec.out_sizes(S)
    K = spec.tap_count
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-offscale, offscale, (B, dg * 2 * K) + OS),
            "mask": (rng.uniform(0, 1, (B, dg * K) + OS) if modulated
                     else None),
            "weight": rng.standard_normal((O, C // g, k, k)) * 0.1,
            "bias": rng.standard_normal((O,)) if bias else None}
    if edit is not None:
        edit(arrs)
    arrs = {n: None if a is None else a.astype(np.float32)
            for n, a in arrs.items()}
    cot = rng.standard_normal((B, O) + OS).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dil, groups=g,
              deformable_groups=dg)
    return spec, arrs, cot, kw


def _jax_grads(arrs, cot, kw, impl, bound=None):
    names = [n for n in NAMES if arrs[n] is not None]
    modulated = arrs["mask"] is not None

    def f(*a):
        d = dict(zip(names, a))
        extra = dict(impl=impl, precision="float32", offset_bound=bound)
        if modulated:
            return jmdc.modulated_deform_conv2d(
                d["x"], d["offset"], d["mask"], d["weight"], d.get("bias"),
                **kw, **extra)
        return jmdc.deform_conv2d(d["x"], d["offset"], d["weight"],
                                  d.get("bias"), **kw, **extra)

    _, vjp = jax.vjp(f, *[jnp.asarray(arrs[n]) for n in names])
    grads = jax.jit(vjp)(jnp.asarray(cot))
    return {n: np.asarray(g) for n, g in zip(names, grads)}


def _port_grads(arrs, cot, kw, impl, bound=None):
    ts = {n: None if a is None else torch.tensor(a, requires_grad=True)
          for n, a in arrs.items()}
    extra = dict(impl=impl, offset_bound=bound)
    if ts["mask"] is not None:
        out = mdt.modulated_deform_conv2d(ts["x"], ts["offset"], ts["mask"],
                                          ts["weight"], ts["bias"], **kw,
                                          **extra)
    else:
        out = mdt.deform_conv2d(ts["x"], ts["offset"], ts["weight"],
                                ts["bias"], **kw, **extra)
    out.backward(torch.from_numpy(cot))
    return {n: t.grad.numpy() for n, t in ts.items() if t is not None}


def _reference_grads(ref_fn, arrs, cot, spec, *extra):
    t = {n: None if a is None else torch.from_numpy(a)
         for n, a in arrs.items()}
    gx, goff, gmask, gw = ref_fn(t["x"], t["offset"], t["mask"], t["weight"],
                                 torch.from_numpy(cot), spec, "float32",
                                 *extra)
    got = {"x": gx, "offset": goff, "mask": gmask, "weight": gw,
           "bias": torch.from_numpy(cot).sum((0, 2, 3))}
    return {n: g.numpy() for n, g in got.items() if arrs[n] is not None}


def _assert_close(got, want):
    assert set(got) == set(want)
    for n in want:
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(got[n] / scale, want[n] / scale, rtol=0,
                                   atol=ATOL, err_msg=n)


def _zero_offsets(a):
    a["offset"][:] = 0.0


def _zero_mask_plane(a):
    a["mask"][0, 2] = 0.0           # a whole tap's mask plane
    a["mask"][1, :, 3, 4] = 0.0     # one output position, every tap


def _far_offsets(a):
    a["offset"][0, 0, :3] = 5.0
    a["offset"][1, 3, 2:5] = -7.5
    a["offset"][0, 7, 4, :] = 40.0  # far outside the image


# (seed, B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias, offscale,
#  edit)
GATHERMM = {
    "general": (0, 2, 16, 12, (9, 10), 3, 1, 1, 1, 2, 2, True, True, 3.0,
                None),
    "stride2": (1, 2, 16, 16, (9, 10), 3, 2, 1, 1, 1, 2, True, True, 2.0,
                None),
    "dilation2": (2, 1, 16, 8, (9, 10), 3, 1, 2, 2, 1, 2, True, False, 2.5,
                  None),
    "dcnv1_no_bias": (3, 2, 8, 8, (9, 10), 3, 1, 1, 1, 1, 1, False, False,
                      2.0, None),
    "integer_grid": (4, 2, 16, 16, (9, 10), 3, 1, 1, 1, 1, 2, True, True,
                     1.0, _zero_offsets),
    "zero_mask": (5, 2, 8, 8, (9, 10), 3, 1, 1, 1, 1, 1, True, True, 1.5,
                  _zero_mask_plane),
    "far_offsets": (6, 2, 8, 8, (9, 10), 3, 1, 1, 1, 1, 1, True, True, 2.0,
                    _far_offsets),
}


def _beyond_bound(a, b=1.0):
    a["offset"][0, 8, 2, 3] = b + 0.5     # tap 4, axis 0: high corner drops
    a["offset"][0, 9, 3, 3] = -(b + 0.5)  # tap 4, axis 1: low corner drops
    a["offset"][1, 3, 4, 5] = b + 0.5
    a["offset"][0, 0, 1, 1] = 5.0         # tap 0, axis 0: both drop
    a["offset"][1, 16, 5, 6] = -5.0


def _zero_offsets_and_mask_plane(a):
    _zero_offsets(a)
    _zero_mask_plane(a)


# (case, bound).  Bounds stay at or under 1: the interpret-mode Pallas
# kernel unrolls every shift of the window, and a 5 x 5 window takes
# twice as long as a 3 x 3 one.
SHIFTBLEND = {
    "beyond_bound": ((10, 2, 16, 16, (9, 10), 3, 1, 1, 1, 2, 2, True, True,
                      0.9, _beyond_bound), 1.0),
    "fractional_bound": ((11, 1, 16, 8, (9, 10), 3, 1, 1, 1, 1, 2, True,
                          False, 0.55, None), 0.6),
    "integer_grid_zero_mask": ((12, 2, 8, 16, (9, 10), 3, 1, 1, 1, 1, 1,
                                True, True, 0.9,
                                _zero_offsets_and_mask_plane), 1.0),
    "dcnv1_dilation2": ((14, 1, 16, 8, (9, 10), 3, 1, 2, 2, 2, 2, False,
                         False, 0.9, None), 1.0),
}


@pytest.mark.parametrize("name", list(GATHERMM))
def test_gathermm_backward_matches_pallas(name):
    spec, arrs, cot, kw = _case(*GATHERMM[name])
    want = _jax_grads(arrs, cot, kw, "pallas")
    _assert_close(_port_grads(arrs, cot, kw, "cuda"), want)
    _assert_close(_reference_grads(gm.gathermm_bwd_reference, arrs, cot,
                                   spec), want)
    if name == "zero_mask":
        # grad_mask stays exact where the mask is 0.
        assert float(np.abs(want["mask"][0, 2]).max()) > 1e-3


@pytest.mark.parametrize("name", list(SHIFTBLEND))
def test_shiftblend_backward_matches_pallas(name):
    case, bound = SHIFTBLEND[name]
    spec, arrs, cot, kw = _case(*case)
    want = _jax_grads(arrs, cot, kw, "shiftblend", bound)
    _assert_close(_port_grads(arrs, cot, kw, "shiftblend", bound), want)
    _assert_close(_reference_grads(sb.shiftblend_bwd_reference, arrs, cot,
                                   spec, bound), want)
    if name == "beyond_bound":
        # The dropped corners matter: the unbounded gradient differs.
        full = _reference_grads(gm.gathermm_bwd_reference, arrs, cot, spec)
        assert not np.allclose(full["offset"], want["offset"], atol=1e-3)
    if name == "integer_grid_zero_mask":
        assert float(np.abs(want["mask"][0, 2]).max()) > 1e-3


def test_backward_needs_and_dtypes():
    """The Functions return only the gradients autograd asks for, and give
    bf16 / fp16 inputs their gradients back in the input's dtype."""
    spec, arrs, cot, kw = _case(*GATHERMM["general"])
    t = {n: torch.from_numpy(a) for n, a in arrs.items()}
    w = t["weight"].clone().requires_grad_(True)
    off = t["offset"].clone().requires_grad_(True)
    out = mdt.modulated_deform_conv2d(t["x"], off, t["mask"], w, None, **kw,
                                      impl="cuda")
    out.backward(torch.from_numpy(cot))
    want = _reference_grads(gm.gathermm_bwd_reference, arrs, cot, spec)
    for n, g in (("offset", off.grad), ("weight", w.grad)):
        np.testing.assert_allclose(g.numpy(), want[n], rtol=0, atol=1e-5)
    for dtype in (torch.float16, torch.bfloat16):
        x = t["x"].to(dtype).requires_grad_(True)
        out = mdt.modulated_deform_conv2d(x, t["offset"], t["mask"],
                                          t["weight"], t["bias"], **kw,
                                          impl="shiftblend", offset_bound=3.0)
        out.float().sum().backward()
        assert x.grad.dtype == dtype and out.dtype == dtype
