"""Shared cases of the bf16 parity tests (tests/test_torch_port_bf16*.py).

Inputs are made with numpy from a seed, rounded to bf16 once, and handed to
the JAX package's op (impl="pallas" or "shiftblend", Pallas interpret mode
on the CPU) and to the port's (impl="cuda" or "shiftblend" on CPU tensors,
where each autograd Function runs its kernels' plain versions), both with
precision="float32".  Two ways of each case: x, offset and mask in bf16
with weight and bias in fp32 (the Packs' case), and all five in bf16
(bench.py --dtype bfloat16).

Checks: out and the five gradients have the same dtypes in both, and out
and the gradients of x, offset, mask and weight agree within 8e-3 x
max|JAX| (two independently rounded bf16 results lie within an ulp of
each other, at most 2^-7 of their scale; the JAX op also adds the bias in
bf16).
The bias gradient is the cotangent's sum over every dim but the channels;
the JAX op sums the bf16 cotangent in bf16 (it differed from the exact sum
by up to 1.3% of its largest value in these cases), the port with fp32
accumulation, so the port's is held to the exact sum (numpy, float64)
instead: within 2^-8 of its largest value in bf16 (one rounding: half an
ulp at most), 1e-5 in fp32.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import modulated_deform_conv_tpu as jmdc

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

TOL = 8e-3
NAMES = ("x", "offset", "mask", "weight", "bias")
# The two ways of a case: the types of (x, offset, mask) and (weight, bias).
MODES = {"pack": (np.float32,), "all_bf16": (ml_dtypes.bfloat16,)}

# name -> (seed, B, C, O, S, groups, dg, kernel, padding, dilation, offset
# scale, offset bound): the general gather pair, the bounded pair (bound
# 0.5: its window of 3 rows a axis keeps both corners at +-0.5, so offsets
# set to the bound give the gather's function too; in 3D on 2 x 1 x 1 taps
# of dilation 2 along D, whose interpret-mode compile takes a quarter of a
# 3 x 3 x 3 kernel's, offsets and corners on all three axes), a columns
# case (a deformable group spanning both conv groups, which the fused pair
# does not take) in 2D and 3D.
CASES = {
    "gather2d": (0, 1, 8, 8, (8, 8), 1, 1, 3, 1, 1, 2.5, None),
    "shift2d": (1, 1, 8, 8, (8, 8), 1, 1, 3, 1, 1, 0.5, 0.5),
    "cols2d": (2, 1, 8, 8, (8, 8), 2, 1, 3, 1, 1, 2.5, None),
    "bounded3d": (3, 1, 8, 8, (4, 8, 16), 1, 1, (2, 1, 1), (1, 0, 0),
                  (2, 1, 1), 0.5, 0.5),
    "cols3d": (4, 1, 8, 8, (4, 8, 16), 2, 1, 3, 1, 1, 2.5, None),
}


@functools.lru_cache(maxsize=None)
def case(name, mode):
    """(spec, inputs as numpy arrays of their test dtypes, bf16 cotangent,
    op keywords, bound).  A few offsets lie exactly on the case's scale:
    on the bounded cases, on the bound."""
    seed, B, C, O, S, g, dg, k, pad, dil, scale, bound = CASES[name]
    nd = len(S)
    spec = DeformConvSpec.make(nd, k, 1, pad, dil, g, dg, modulated=True)
    K = spec.tap_count
    rng = np.random.default_rng(seed)
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-scale, scale, (B, dg * nd * K) + S),
            "mask": rng.uniform(0, 1, (B, dg * K) + S),
            "weight": rng.standard_normal((O, C // g) + spec.kernel) * 0.2,
            "bias": rng.standard_normal((O,))}
    arrs["offset"][0, 0, 0] = scale
    arrs["offset"][0, 1, 1] = -scale
    wtype = MODES[mode][0]
    arrs = {n: a.astype(ml_dtypes.bfloat16 if n in NAMES[:3] else wtype)
            for n, a in arrs.items()}
    cot = rng.standard_normal((B, O) + S).astype(ml_dtypes.bfloat16)
    kw = dict(padding=pad, dilation=dil, groups=g, deformable_groups=dg)
    return spec, arrs, cot, kw, bound


def _op(mod, nd):
    return (mod.modulated_deform_conv2d, mod.modulated_deform_conv3d)[nd - 2]


@functools.lru_cache(maxsize=None)
def jax_result(name, mode, impl):
    """(out, {name: gradient}) of the JAX op, as numpy arrays."""
    spec, arrs, cot, kw, bound = case(name, mode)
    op = _op(jmdc, spec.ndim)

    def f(*a):
        return op(*a, **kw, impl=impl, precision="float32",
                  offset_bound=bound)

    @jax.jit
    def step(ins, cot):
        out, vjp = jax.vjp(f, *ins)
        return out, vjp(cot)

    out, grads = step([jnp.asarray(arrs[n]) for n in NAMES], jnp.asarray(cot))
    return np.asarray(out), {n: np.asarray(g) for n, g in zip(NAMES, grads)}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def port_result(name, mode, impl):
    """(out, {name: gradient}) of the port's op on CPU tensors, as torch
    tensors of the port's dtypes."""
    spec, arrs, cot, kw, bound = case(name, mode)
    ts = {n: _torch(a).requires_grad_(True) for n, a in arrs.items()}
    out = _op(mdt, spec.ndim)(*[ts[n] for n in NAMES], **kw, impl=impl,
                              precision="float32", offset_bound=bound)
    out.backward(_torch(cot))
    return out.detach(), {n: ts[n].grad for n in NAMES}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def assert_matches(name, mode, got, want):
    """The port's (out, grads) of case `name`, `mode` against the JAX
    package's: the same dtypes, within TOL x max|JAX|; the bias gradient
    against the exact sum of the cotangent."""
    (gout, ggrads), (wout, wgrads) = got, want
    pairs = [("out", gout, wout)] + [(n, ggrads[n], wgrads[n])
                                     for n in NAMES]
    for label, g, w in pairs:
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (
            label, g.dtype, w.dtype)
        w32 = w.astype(np.float32)
        if label == "bias":
            cot = case(name, mode)[2].astype(np.float64)
            w32 = cot.sum(axis=(0,) + tuple(range(2, cot.ndim)))
        scale = float(np.abs(w32).max())
        assert scale > 0, label
        atol = TOL if label != "bias" else (
            2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-5)
        np.testing.assert_allclose(_np(g) / scale, w32 / scale, rtol=0,
                                   atol=atol, err_msg=label)
