"""The port's 3D modules and DCNVideoNet against the JAX package's flax ones.

Each flax model is initialised, its parameters carried over with
`load_flax_params`, and the port is held against flax `apply` on an input
made from a numpy seed:

* the four 3D deformable-conv modules, in float32, rtol = atol = 2e-5;
* DCNVideoNet at width 8, blocks (1, 1), 10 classes, on a 1 x 3 x 4 x 8 x 8
  clip, in float64 on both sides (jax.enable_x64; the port's plain path on
  CPU tensors): logits, the mean softmax cross-entropy and every
  parameter's gradient, divided by max|JAX gradient| of that parameter,
  within 1e-8; with the offset predictors as initialised (zero: every tap
  on the integer grid) and with learned-like ones.

And a unit test of the flax-kernel conversion in 3D: DHWIO -> OIDHW.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modulated_deform_conv_tpu.models import DCNVideoNet as JDCNVideoNet
from modulated_deform_conv_tpu.models import modules as jmod

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.models import (flax_to_state_dict,
                                                    load_flax_params)


def _nonzero_biases(tree):
    return {k: _nonzero_biases(v) if isinstance(v, dict) else
            np.linspace(-0.5, 0.5, v.size, dtype=np.float32) if k == "bias"
            else np.asarray(v) for k, v in tree.items()}


MODULES = [
    ("DeformConv3d", dict(stride=1, padding=1, deformable_groups=2), {}),
    ("ModulatedDeformConv3d",
     dict(stride=1, padding=2, dilation=2, groups=2, deformable_groups=2),
     {}),
    ("DeformConv3dPack", dict(stride=2, padding=1, deformable_groups=2), {}),
    ("ModulatedDeformConv3dPack",
     dict(stride=1, padding=1, groups=2, deformable_groups=4),
     dict(sigmoid_mask=True)),
]


@pytest.mark.parametrize("name,kw,pack_kw", MODULES)
def test_module3d_matches_flax(name, kw, pack_kw):
    cin, cout = 8, 12
    fm = getattr(jmod, name)(in_channels=cin, out_channels=cout,
                             kernel_size=3, use_bias=True, **kw, **pack_kw)
    tm = getattr(mdt, name)(cin, cout, 3, bias=True, device="cpu", **kw,
                            **pack_kw)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, cin, 5, 6, 7)).astype(np.float32)
    args = [x]
    if "Pack" not in name:
        d, s, p = kw.get("dilation", 1), kw["stride"], kw["padding"]
        os_ = tuple((n + 2 * p - (2 * d + 1)) // s + 1 for n in x.shape[2:])
        dg = kw["deformable_groups"]
        args.append(rng.uniform(-2, 2, (2, dg * 81) + os_).astype(np.float32))
        if "Modulated" in name:
            args.append(rng.uniform(0, 1, (2, dg * 27) + os_)
                        .astype(np.float32))
    variables = fm.init(jax.random.key(0), *[jnp.asarray(a) for a in args])
    # flax zero-initialises the biases: give them values so that every
    # entry of the mapping is exercised.
    variables = {"params": _nonzero_biases(variables["params"])}
    load_flax_params(tm, variables)
    assert set(tm.state_dict()) == set(flax_to_state_dict(variables))
    if "Pack" in name:
        assert tm.conv_offset.weight.ndim == 5
    want = fm.apply(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = tm(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("name,kw,pack_kw",
                         [m for m in MODULES if "Pack" in m[0]])
def test_pack3d_bf16_matches_flax(name, kw, pack_kw):
    """bf16 input, float32 parameters: the 3D predictor convs run in bf16
    with their weight and bias cast to it, as the JAX package's
    `_PredictorConv` does, and the result is bf16 on both sides.
    Tolerance 2e-2 of max|flax|: the offsets and the result are
    bf16-rounded, each side in its own order."""
    fm = getattr(jmod, name)(in_channels=8, out_channels=12, kernel_size=3,
                             use_bias=True, **kw, **pack_kw)
    tm = getattr(mdt, name)(8, 12, 3, bias=True, device="cpu", **kw,
                            **pack_kw)
    x = np.random.default_rng(8).standard_normal((2, 8, 5, 6, 7)).astype(
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


def test_flax_conv3d_kernel_becomes_oidhw():
    """A 5D flax `kernel` leaf (D, H, W, I, O) becomes an OIDHW `weight`,
    and the flax-named 3D bottleneck convs take the port's names."""
    k = np.arange(2 * 3 * 4 * 5 * 6, dtype=np.float32).reshape(2, 3, 4, 5, 6)
    sd = flax_to_state_dict({"params": {
        "ConvBN3d_0": {"Conv_0": {"kernel": k},
                       "GroupNorm_0": {"scale": np.ones(6), "bias":
                                       np.zeros(6)}},
        "ConvBN3d_1": {"Conv_0": {"kernel": k}}}})
    w = sd["conv1.conv.weight"].numpy()
    assert w.shape == (6, 5, 2, 3, 4)
    np.testing.assert_array_equal(w[4, 3, 1, 2, 0], k[1, 2, 0, 3, 4])
    np.testing.assert_array_equal(w, k.transpose(4, 3, 0, 1, 2))
    assert set(sd) == {"conv1.conv.weight", "conv1.norm.weight",
                       "conv1.norm.bias", "conv3.conv.weight"}
    assert tuple(sd["conv3.conv.weight"].shape) == (6, 5, 2, 3, 4)


LABELS = np.array([3])
VIDEO = dict(num_classes=10, width=8, blocks=(1, 1))


def _perturb_predictors(tree, rng):
    """Give the zero-initialised offset / mask predictors weights, so that
    the DCN layer samples between grid points."""
    out = {k: _perturb_predictors(v, rng) if isinstance(v, dict) else v
           for k, v in tree.items()}
    for name in ("conv_offset", "conv_mask"):
        if name in out:
            w = out[name]["weight"]
            out[name] = {"weight": (rng.standard_normal(w.shape) * 0.05)
                         .astype(np.float32),
                         "bias": (rng.standard_normal(w.shape[0]) * 0.5)
                         .astype(np.float32)}
    return out


@functools.lru_cache(maxsize=None)
def _flax64(offsets):
    """float64 parameters, clip, and flax's logits, loss and gradients."""
    with jax.enable_x64(True):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((1, 3, 4, 8, 8)).astype(np.float32)
        fm = JDCNVideoNet(**VIDEO)
        params = jax.tree_util.tree_map(
            np.asarray, jax.jit(fm.init)(jax.random.key(0),
                                         jnp.asarray(x))["params"])
        if offsets == "learned":
            params = _perturb_predictors(params, rng)
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                        params)
        x = x.astype(np.float64)

        def loss_fn(p):
            logits = fm.apply({"params": p}, jnp.asarray(x))
            logp = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(
                logp, jnp.asarray(LABELS)[:, None], axis=1).mean(), logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        grads = {k: v.numpy() for k, v in
                 flax_to_state_dict({"params": grads}).items()}
        return params, x, np.asarray(logits), float(loss), grads


@pytest.mark.parametrize("offsets", ["zero_init", "learned"])
def test_dcn_videonet_matches_flax_float64(offsets):
    params, x, jlogits, jloss, jgrads = _flax64(offsets)
    assert jlogits.dtype == np.float64
    tm = mdt.DCNVideoNet(**VIDEO, device="cpu", dtype=torch.float64)
    load_flax_params(tm, {"params": params})
    logits = tm(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(LABELS))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-8,
                               atol=1e-8)
    grads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(grads[name] / scale, g / scale, rtol=0,
                                   atol=1e-8, err_msg=name)
    if offsets == "learned":
        assert float(np.abs(jgrads["s1b0.dcn.conv_offset.weight"]).max()) > 0
