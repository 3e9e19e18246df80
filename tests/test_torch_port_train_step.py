"""The port's training step against the JAX trainer's jitted step.

The JAX package's trainer (examples/train_dcn_resnet.py:55-64) compiles
`train_step` with `jax.jit`: `jax.value_and_grad` of the mean softmax
cross-entropy, `optax.adamw(1e-3)` (weight decay 1e-4) and
`optax.apply_updates`.  That step is built here exactly so, in the test
(the JAX package is not touched), beside the port trainer's `train_step`
and `make_optimizer` (AdamW, lr 1e-3, weight decay 1e-4), on one DCN stage
(a DCNv2 bottleneck, 8 -> 16 channels at 8 x 8, offset and mask
predictors given weights so that taps fall between grid points) with a
mean pool and a dense head: the smallest model that runs the trainer's
whole step, its JAX side compiled in a few seconds.

The same parameters are carried over with the flax -> torch loader and
both take 2 steps in float64 on the CPU (the port's DCN layers on "auto",
the plain path on CPU tensors): the losses agree within 1e-9 relative, and
every parameter's update (after - before) within 1e-6 x lr per element.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch import nn

from modulated_deform_conv_tpu.models.backbone import DCNStage as JDCNStage

from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer, train_step)
from modulated_deform_conv_tpu_torch.models import load_flax_params
from modulated_deform_conv_tpu_torch.models.backbone import DCNStage

LR = 1e-3
B, C, S, CLASSES = 2, 8, 8, 10


class JNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        y = JDCNStage(blocks=1, channels=4, out_channels=16, name="c3")(x)
        return fnn.Dense(CLASSES, name="fc")(jnp.mean(y, axis=(2, 3)))


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        factory = dict(device="cpu", dtype=torch.float64)
        self.c3 = DCNStage(1, C, 4, 16, **factory)
        self.fc = nn.Linear(16, CLASSES, **factory)

    def forward(self, x):
        return self.fc(self.c3(x).mean((2, 3)))


def _perturb_predictors(tree, rng):
    out = {k: _perturb_predictors(v, rng) if isinstance(v, dict) else v
           for k, v in tree.items()}
    for name in ("conv_offset", "conv_mask"):
        if name in out:
            w = out[name]["weight"]
            out[name] = {"weight": rng.standard_normal(w.shape) * 0.05,
                         "bias": rng.standard_normal(w.shape[0]) * 0.5}
    return out


def _jax_steps(params, x, y, steps):
    """The JAX trainer's step, as examples/train_dcn_resnet.py builds it."""
    model = JNet()
    tx = optax.adamw(LR, weight_decay=1e-4)
    opt_state = tx.init(params)

    def loss_fn(p, x, y):
        logits = model.apply(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    @jax.jit
    def step(p, s, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    return params, losses


def test_train_step_matches_jax_jitted_step_float64():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, C, S, S))
    y = rng.integers(0, CLASSES, (B,))
    with jax.enable_x64(True):
        variables = JNet().init(jax.random.key(0), jnp.asarray(x))
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables["params"])
        params = {"params": _perturb_predictors(params, rng)}
        after, jlosses = _jax_steps(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(y), 2)
        after = jax.tree_util.tree_map(np.asarray, after)

    model = Net()
    load_flax_params(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(train_step(model, opt, xt, yt)) for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-9, atol=0)

    want_after = Net()
    load_flax_params(want_after, after)
    want = want_after.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys() == before.keys()
    for k, p0 in before.items():
        np.testing.assert_allclose((got[k] - p0).numpy(),
                                   (want[k] - p0).numpy(), rtol=0,
                                   atol=1e-6 * LR, err_msg=k)
