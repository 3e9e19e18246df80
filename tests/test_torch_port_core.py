"""The port's plain PyTorch op (impl="torch") against the JAX reference.

Inputs come from a numpy seed and go to both packages.  Tolerances: fp32
forward rtol = atol = 2e-5 against JAX impl="xla"; gradients divided by the
max of the JAX gradient, atol 1e-5.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu.ops import core as jcore
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.ops import core as tcore
from modulated_deform_conv_tpu_torch.utils.config import (DeformConvSpec,
                                                          effective_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (nd, B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias, offscale)
CASES = [
    (2, 2, 4, 6, (7, 6), 3, 1, 1, 1, 2, 2, True, True, 2.5),
    (2, 1, 6, 4, (8, 9), 3, 2, 1, 1, 1, 3, False, False, 1.5),
    (2, 2, 8, 8, (9, 7), 3, 1, 2, 2, 2, 4, True, False, 4.0),
    (2, 1, 4, 2, (6, 6), (2, 3), 1, 0, 1, 1, 1, True, True, 1.0),
    (3, 1, 4, 4, (4, 5, 4), 3, 1, 1, 1, 2, 2, True, True, 1.5),
    (3, 2, 2, 2, (5, 4, 3), 2, (2, 1, 1), 1, 1, 1, 1, False, True, 2.0),
]


def _case(nd, B, C, O, S, k, stride, pad, dil, g, dg, modulated, bias,
          offscale, seed=0):
    rng = np.random.default_rng(seed)
    spec = DeformConvSpec.make(nd, k, stride, pad, dil, g, dg,
                               modulated=modulated)
    OS = spec.out_sizes(S)
    K = spec.tap_count
    arrs = {
        "x": rng.standard_normal((B, C) + tuple(S)),
        "offset": rng.uniform(-offscale, offscale, (B, dg * nd * K) + OS),
        "mask": rng.uniform(0, 1, (B, dg * K) + OS) if modulated else None,
        "weight": rng.standard_normal((O, C // g) + spec.kernel) * 0.3,
        "bias": rng.standard_normal((O,)) if bias else None,
    }
    arrs = {n: None if a is None else a.astype(np.float32)
            for n, a in arrs.items()}
    cot = rng.standard_normal((B, O) + OS).astype(np.float32)
    return spec, arrs, cot


def _jspec(spec):
    return JSpec.make(spec.ndim, spec.kernel, spec.stride, spec.padding,
                      spec.dilation, spec.groups, spec.deformable_groups,
                      spec.in_step, spec.modulated)


def _torch(arrs, requires_grad=False, dtype=torch.float32):
    return {n: None if a is None else
            torch.tensor(a, dtype=dtype, requires_grad=requires_grad)
            for n, a in arrs.items()}


def _jax(arrs):
    return {n: None if a is None else jnp.asarray(a) for n, a in arrs.items()}


def _ones_conv_counts(shape, k=3):
    out = np.zeros(shape)
    for idx in np.ndindex(*shape):
        cnt = 1
        for d, i in enumerate(idx):
            cnt *= min(shape[d] - 1, i + k // 2) - max(0, i - k // 2) + 1
        out[idx] = cnt
    return out


def test_golden_2d_plain_and_modulated():
    x = torch.ones((1, 1, 5, 5))
    off = torch.zeros((1, 18, 5, 5))
    mask = torch.ones((1, 9, 5, 5))
    w = torch.ones((1, 1, 3, 3))
    b = torch.zeros((1,))
    expect = _ones_conv_counts((5, 5))
    out = mdt.deform_conv2d(x, off, w, b, stride=1, padding=1)
    np.testing.assert_allclose(out[0, 0].numpy(), expect, atol=1e-5)
    out_m = mdt.modulated_deform_conv2d(x, off, mask, w, b, stride=1,
                                        padding=1)
    np.testing.assert_allclose(out_m[0, 0].numpy(), expect, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    spec, arrs, _ = _case(*case)
    t, j = _torch(arrs), _jax(arrs)
    got = tcore.deform_conv_nd(t["x"], t["offset"], t["mask"], t["weight"],
                               t["bias"], spec)
    want = jcore.deform_conv_nd(j["x"], j["offset"], j["mask"], j["weight"],
                                j["bias"], _jspec(spec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]])
def test_gradients_match_jax(case):
    spec, arrs, cot = _case(*case, seed=1)
    names = [n for n, a in arrs.items() if a is not None]
    t = _torch(arrs, requires_grad=True)
    out = tcore.deform_conv_nd(t["x"], t["offset"], t["mask"], t["weight"],
                               t["bias"], spec)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(*vals):
        a = dict(zip(names, vals))
        return jnp.sum(jcore.deform_conv_nd(
            a["x"], a["offset"], a.get("mask"), a["weight"], a.get("bias"),
            _jspec(spec)) * cot)

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(arrs[n]) for n in names])
    for n, g in zip(names, grads):
        g = np.asarray(g)
        scale = np.abs(g).max() + 1e-12
        np.testing.assert_allclose(t[n].grad.numpy() / scale, g / scale,
                                   rtol=0, atol=1e-5, err_msg=n)


def test_gradcheck_fp64():
    spec, arrs, _ = _case(2, 1, 2, 2, (4, 4), 3, 1, 1, 1, 1, 1, True, True,
                          0.7, seed=2)
    t = _torch(arrs, requires_grad=True, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x, o, m, w, b: tcore.deform_conv_nd(x, o, m, w, b, spec),
        (t["x"], t["offset"], t["mask"], t["weight"], t["bias"]),
        eps=1e-6, atol=1e-5)


def test_effective_step_gcd():
    assert effective_step(8, 64) == 8
    assert effective_step(6, 4) == 2
    assert effective_step(5, 3) == 1
    assert effective_step(4, 0) == 4


@pytest.mark.parametrize("in_step,col_cap", [(1, None), (3, None),
                                             (64, None), (64, 4096)])
def test_in_step_and_chunking_invariance(in_step, col_cap, monkeypatch):
    """in_step and the column-size cap (batch chunks, then leading-dim row
    chunks) change memory only: forward and gradients stay the same."""
    spec, arrs, cot = _case(2, 4, 4, 4, (6, 6), 3, 1, 1, 1, 2, 2, True, True,
                            1.5, seed=3)

    def run(step):
        t = _torch(arrs, requires_grad=True)
        s = DeformConvSpec.make(2, 3, 1, 1, 1, 2, 2, step, modulated=True)
        out = tcore.deform_conv_nd(t["x"], t["offset"], t["mask"],
                                   t["weight"], t["bias"], s)
        (out * torch.from_numpy(cot)).sum().backward()
        return [out.detach()] + [t[n].grad for n in t]

    base = run(4)
    if col_cap is not None:
        monkeypatch.setattr(tcore, "_COL_BYTES_CAP", col_cap)
    for a, b in zip(run(in_step), base):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_shape_validation_errors():
    spec, arrs, _ = _case(*CASES[0])
    t = _torch(arrs)
    with pytest.raises(ValueError, match="offset shape"):
        mdt.deform_conv2d(t["x"], t["offset"][:, :-1], t["weight"], None, 1,
                          1, 1, 2, 2)
    with pytest.raises(ValueError, match="mask shape"):
        mdt.modulated_deform_conv2d(t["x"], t["offset"], t["mask"][:, :-1],
                                    t["weight"], None, 1, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        DeformConvSpec.make(2, 3, groups=3).validate(
            (1, 4, 5, 5), (1, 18, 3, 3), (4, 2, 3, 3))
    with pytest.raises(ValueError, match="in-channels"):
        mdt.deform_conv2d(t["x"], t["offset"], torch.ones((6, 4, 3, 3)), None,
                          1, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="impl"):
        mdt.modulated_deform_conv2d(t["x"], t["offset"], t["mask"],
                                    t["weight"], None, 1, 1, 1, 2, 2,
                                    impl="xla")


def test_port_runs_with_jax_blocked():
    """The port never imports jax: with jax blocked from import, the
    package imports and its torch path runs."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch, modulated_deform_conv_tpu_torch as mdt\n"
        "x = torch.ones(1, 1, 5, 5)\n"
        "y = mdt.modulated_deform_conv2d(x, torch.zeros(1, 18, 5, 5),\n"
        "    torch.ones(1, 9, 5, 5), torch.ones(1, 1, 3, 3), None, 1, 1,\n"
        "    offset_bound=1.0)\n"
        "assert float(y[0, 0, 2, 2]) == 9.0 and float(y[0, 0, 0, 0]) == 4.0\n"
        "assert not any(m == 'modulated_deform_conv_tpu' or\n"
        "    m.startswith('modulated_deform_conv_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
