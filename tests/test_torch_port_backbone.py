"""The port's DCNResNet and its trainer against the JAX package's.

DCNResNet at depth 50, width 8, 10 classes, on a 2 x 3 x 32 x 32 batch:
the flax model is initialised, its parameters carried over with
`load_flax_params`, and the port is held against flax `apply` and
`jax.value_and_grad` of the mean softmax cross-entropy, with the offset
predictors as initialised (zero: every tap on the integer grid) and with
learned-like ones.  Inputs come from a numpy seed.

At this size c5 runs at 1 x 1 and its GroupNorms normalise 2 values per
group, so float32 rounding is amplified by up to 1e4 in some gradients.
flax's GroupNorm takes the variance as E[x^2] - E[x]^2 (its
use_fast_variance default), which adds cancellation on its side: with the
learned-like offsets, flax float32 gradients miss flax float64's by up to
0.48 of a parameter's max|gradient| (c5.block2.conv1.conv.weight), the
port's float32 gradients miss them by 0.033, and the two float32 sides
differ by up to 0.44 (median over parameters 0.041).  Readings taken with
this file's `_reference` and `_port` on the CPU, torch at 1, 2 and 8
threads (port float32 against flax float64: 0.0338 / 0.0328 / 0.0328).
Hence:

* float64 on both sides (jax.enable_x64; the port's DCN modules on "auto",
  the plain path on CPU tensors): logits, loss and every parameter's
  gradient, divided by max|JAX gradient| of that parameter, within 1e-8;
* float32 with the DCN modules on impl="cuda", so that all 13 DCN layers
  run the kernels' autograd Functions (their plain versions on the CPU):
  logits within 5e-3 and loss within 1e-3 of flax float32, every gradient
  within 5e-2 of flax float64 relative to its max (0.033 measured), and
  within 1e-5 of the port's plain path (impl="torch").
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modulated_deform_conv_tpu.models import DCNResNet as JDCNResNet
from modulated_deform_conv_tpu.models.backbone import ConvBN as JConvBN

from modulated_deform_conv_tpu_torch import DCNResNet
from modulated_deform_conv_tpu_torch.models.backbone import ConvBN
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import train
from modulated_deform_conv_tpu_torch.models import (flax_to_state_dict,
                                                    load_flax_params)

LABELS = np.array([3, 7])


def _params(offsets, dtype):
    """Flax-initialised parameters and the input batch, as numpy."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    fm = JDCNResNet(num_classes=10, depth=50, width=8)
    params = jax.jit(fm.init)(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if offsets == "learned":
        params = _perturb_predictors(params, rng)
    return (jax.tree_util.tree_map(lambda a: a.astype(dtype), params),
            x.astype(dtype))


def _perturb_predictors(tree, rng):
    """Give the zero-initialised offset / mask predictors weights, so that
    the DCN layers sample between grid points."""
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


def _flax(params, x):
    fm = JDCNResNet(num_classes=10, depth=50, width=8)

    def loss_fn(p):
        logits = fm.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(LABELS)[:, None],
                                    axis=1).mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    grads = {k: v.numpy() for k, v in
             flax_to_state_dict({"params": grads}).items()}
    return np.asarray(logits), float(loss), grads


@functools.lru_cache(maxsize=None)
def _reference(offsets, dtype):
    """Parameters, batch, and flax's logits, loss and gradients, in `dtype`
    ("float32" or "float64"); cached across the tests of this file."""
    with jax.enable_x64(dtype == "float64"):
        params, x = _params(offsets, np.dtype(dtype))
        return (params, x, *_flax(params, x))


def _port(params, x, impl, dtype):
    tm = DCNResNet(num_classes=10, depth=50, width=8, impl=impl,
                   device="cpu", dtype=dtype)
    load_flax_params(tm, {"params": params})
    nodes = []
    for name, mod in tm.named_modules():
        if name.endswith(".dcn"):
            mod.register_forward_hook(
                lambda m, i, o: nodes.append(type(o.grad_fn).__name__))
    logits = tm(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(LABELS))
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    return logits.detach().numpy(), float(loss.detach()), grads, nodes


def _assert_grads_close(got, want, atol):
    assert set(got) == set(want)
    for name, g in want.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(got[name] / scale, g / scale, rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("offsets", ["zero_init", "learned"])
def test_dcn_resnet50_matches_flax(offsets):
    params, x, jlogits, jloss, jgrads = _reference(offsets, "float64")
    assert jlogits.dtype == np.float64
    logits, loss, grads, _ = _port(params, x, "auto", torch.float64)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(loss, jloss, rtol=1e-8, atol=1e-8)
    _assert_grads_close(grads, jgrads, 1e-8)


def test_dcn_resnet50_kernel_path_fp32():
    params, x, jlogits, jloss, _ = _reference("learned", "float32")
    *_, jgrads64 = _reference("learned", "float64")
    logits, loss, grads, nodes = _port(params, x, "cuda", torch.float32)
    # All 13 DCN layers of c3-c5 went through the general kernels' autograd
    # Function, forward and backward.
    assert nodes == ["_GathermmFwdBackward"] * 13
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=5e-3)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-3)
    _assert_grads_close(grads, jgrads64, 5e-2)
    _, _, plain, nodes = _port(params, x, "torch", torch.float32)
    assert "_GathermmFwdBackward" not in nodes
    _assert_grads_close(grads, plain, 1e-5)


def test_convbn_bf16_promotes_like_flax():
    """ConvBN on a bf16 input with float32 parameters promotes the input,
    as flax's nn.Conv and nn.GroupNorm do: the result is float32 and
    matches flax's within 1e-5 of its max."""
    x = np.random.default_rng(4).standard_normal((2, 8, 7, 7)).astype(
        np.float32)
    fm = JConvBN(16, kernel=3)
    variables = jax.tree_util.tree_map(np.asarray, fm.init(
        jax.random.key(1), jnp.asarray(x)))
    tm = ConvBN(8, 16, 3, device="cpu")
    with torch.no_grad():
        tm.conv.weight.copy_(torch.tensor(
            variables["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        got = tm(torch.from_numpy(x).to(torch.bfloat16))
    want = fm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_dcn_resnet50_bf16_input():
    """A bf16 batch through DCNResNet with float32 parameters: the stem's
    ConvBN promotes it, so the network runs in float32 and returns float32
    logits, as flax does; the same bits as the port's float32 forward of
    the bf16-rounded batch, and within 1e-2 of flax's float32 logits (at
    this size float32 rounding is amplified, see above: 6.6e-3 measured on
    the CPU)."""
    params, x, *_ = _reference("learned", "float32")
    xb = x.astype(jnp.bfloat16)
    want = jax.jit(JDCNResNet(num_classes=10, depth=50, width=8).apply)(
        {"params": params}, jnp.asarray(xb))
    tm = DCNResNet(num_classes=10, depth=50, width=8, device="cpu")
    load_flax_params(tm, {"params": params})
    x32 = torch.from_numpy(xb.astype(np.float32))
    with torch.no_grad():
        got = tm(x32.to(torch.bfloat16))
        assert torch.equal(got, tm(x32))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-2)


def test_trainer_two_steps_on_cpu(tmp_path):
    """The in-package trainer: 2 AdamW steps on --device cpu, a falling
    loss and a checkpoint round trip."""
    out = train(steps=2, batch=2, width=8, classes=10, size=32,
                device="cpu", ckpt_dir=str(tmp_path), log=lambda s: None)
    assert len(out["losses"]) == 2 and out["losses"][1] < out["losses"][0]
    assert (tmp_path / "step_2" / "checkpoint.pt").exists()
