"""The port's 2D forward slice end to end against the JAX package.

The four 2D modules are initialised in flax, carried over with
`load_flax_params` and held against flax `apply`; the functional op runs at
a narrow copy of the bench's config 2 through every impl.  Inputs come from
a numpy seed; tolerance rtol = atol = 2e-5 (fp32).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu as jmdc
from modulated_deform_conv_tpu.models import modules as jmod

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.models import (flax_to_state_dict,
                                                    load_flax_params)

B, C, H, W, G, DG = 2, 32, 12, 12, 4, 4


def _nonzero_biases(tree):
    return {k: _nonzero_biases(v) if isinstance(v, dict) else
            np.linspace(-0.5, 0.5, v.size, dtype=np.float32) if k == "bias"
            else np.asarray(v) for k, v in tree.items()}


MODULES = [
    ("DeformConv2d", dict(stride=1, padding=1, deformable_groups=2), {}),
    ("ModulatedDeformConv2d",
     dict(stride=1, padding=2, dilation=2, groups=2, deformable_groups=2),
     {}),
    ("DeformConv2dPack", dict(stride=2, padding=1, deformable_groups=2), {}),
    ("ModulatedDeformConv2dPack",
     dict(stride=1, padding=1, groups=2, deformable_groups=4),
     dict(sigmoid_mask=True)),
]


@pytest.mark.parametrize("name,kw,pack_kw", MODULES)
def test_module_matches_flax(name, kw, pack_kw):
    cin, cout = 8, 12
    fm = getattr(jmod, name)(in_channels=cin, out_channels=cout,
                             kernel_size=3, use_bias=True, **kw, **pack_kw)
    tm = getattr(mdt, name)(cin, cout, 3, bias=True, device="cpu", **kw,
                            **pack_kw)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, cin, 9, 8)).astype(np.float32)
    args = [x]
    if "Pack" not in name:
        spec_os = [(s + 2 * kw.get("padding", 0)
                    - (kw.get("dilation", 1) * 2 + 1)) // kw.get("stride", 1)
                   + 1 for s in x.shape[2:]]
        dg = kw["deformable_groups"]
        args.append(rng.uniform(-2, 2, (2, dg * 18, *spec_os))
                    .astype(np.float32))
        if "Modulated" in name:
            args.append(rng.uniform(0, 1, (2, dg * 9, *spec_os))
                        .astype(np.float32))
    variables = fm.init(jax.random.key(0), *[jnp.asarray(a) for a in args])
    # flax zero-initialises the biases: give them values so that every
    # entry of the mapping is exercised.
    variables = {"params": _nonzero_biases(variables["params"])}
    load_flax_params(tm, variables)
    assert set(tm.state_dict()) == set(flax_to_state_dict(variables))
    want = fm.apply(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = tm(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("name,kw,pack_kw",
                         [m for m in MODULES if "Pack" in m[0]])
def test_pack_bf16_matches_flax(name, kw, pack_kw):
    """bf16 input, float32 parameters: the predictor convs run in bf16 with
    their weight and bias cast to it, as the JAX package's `_PredictorConv`
    does, and the result is bf16 on both sides.  Tolerance 2e-2 of
    max|flax|: the offsets and the result are bf16-rounded, each side in
    its own order (7.4e-3 measured on the CPU)."""
    fm = getattr(jmod, name)(in_channels=8, out_channels=12, kernel_size=3,
                             use_bias=True, **kw, **pack_kw)
    tm = getattr(mdt, name)(8, 12, 3, bias=True, device="cpu", **kw,
                            **pack_kw)
    x = np.random.default_rng(7).standard_normal((2, 8, 9, 8)).astype(
        np.float32)
    variables = {"params": _nonzero_biases(
        fm.init(jax.random.key(0), jnp.asarray(x))["params"])}
    load_flax_params(tm, variables)
    want = fm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_module_init_and_pack_quirks():
    m = mdt.ModulatedDeformConv2dPack(8, 8, 3, padding=1, device="cpu")
    m.requires_grad_(False)
    stdv = 1 / math.sqrt(8 * 9)
    assert m.bias is None and float(m.weight.abs().max()) <= stdv
    assert float(m.conv_offset.weight.abs().max()) > 0
    assert float(m.conv_offset.bias.abs().max()) == 0
    z = mdt.ModulatedDeformConv2dPack(8, 8, 3, padding=1, bias=True,
                                      zero_init_offset=True, device="cpu")
    z.requires_grad_(False)
    assert float(z.conv_offset.weight.abs().max()) == 0
    assert float(z.conv_mask.weight.abs().max()) == 0   # the Pack quirk
    assert float(z.bias.abs().max()) == 0
    assert set(z.state_dict()) == {
        "weight", "bias", "conv_offset.weight", "conv_offset.bias",
        "conv_mask.weight", "conv_mask.bias"}
    with pytest.raises(ValueError, match="groups"):
        mdt.DeformConv2d(8, 6, 3, groups=4, device="cpu")


@pytest.mark.parametrize("impl,bound", [
    ("auto", 2.0), ("auto", None), ("torch", 2.0), ("torch", None),
    ("cuda", 2.0), ("cuda", None), ("shiftblend", 2.0)])
def test_cfg2_narrow_end_to_end(impl, bound):
    """The main path's op at a narrow copy of config 2 (B=2, 32->32, 12x12,
    g = dg = 4, bias; offsets from U[-2, 2]) with and without the bound."""
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal((B, C, H, W)),
            rng.uniform(-2, 2, (B, DG * 18, H, W)),
            rng.uniform(0, 1, (B, DG * 9, H, W)),
            rng.standard_normal((C, C // G, 3, 3)) * 0.05,
            rng.standard_normal((C,))]
    arrs = [a.astype(np.float32) for a in arrs]
    got = mdt.modulated_deform_conv2d(
        *[torch.from_numpy(a) for a in arrs], 1, 1, 1, G, DG, impl=impl,
        offset_bound=bound)
    want = jmdc.modulated_deform_conv2d(
        *[jnp.asarray(a) for a in arrs], 1, 1, 1, G, DG, impl="xla")
    assert got.shape == (B, C, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
