"""The parent side of the port's gloo sharding tests: the JAX package's
result for a case (its unsharded op, or its sharded op on the same mesh
shape and axis names on the 8 virtual CPU devices), and the comparison
with the stitched port shards.

Tolerances: forward rtol = atol = 2e-5 in "float32"; every gradient
within 1e-5 of max|JAX gradient|.
"""
import jax
import jax.numpy as jnp
import numpy as np

import modulated_deform_conv_tpu as jmdc
from modulated_deform_conv_tpu.parallel import sharding as jsh

import torch_sharding_ranks as ranks

_OPS = {
    "sharded_deform_conv2d": "deform_conv2d",
    "sharded_modulated_deform_conv2d": "modulated_deform_conv2d",
    "sharded_deform_conv3d": "deform_conv3d",
    "sharded_modulated_deform_conv3d": "modulated_deform_conv3d",
}
_OP_KW = ("stride", "padding", "dilation", "groups", "deformable_groups",
          "precision")


def jax_result(case, sharded=False):
    """(output, [grad per input or None]) of the JAX package for the case:
    its unsharded op, or with `sharded` its sharded op on the case's mesh
    shape and axis names."""
    arrs = case["inputs"]
    kw = case["kw"]
    if sharded:
        mesh = jsh.make_mesh(*case["mesh"])
        fn = getattr(jsh, case["fn"])
        jkw = {k: v for k, v in kw.items() if k != "impl"}
        op = lambda *a: fn(*a, mesh=mesh, **jkw)  # noqa: E731
    else:
        fn = getattr(jmdc, _OPS[case["fn"]])
        jkw = {k: v for k, v in kw.items() if k in _OP_KW}
        op = lambda *a: fn(*a, **jkw)  # noqa: E731
    live = [i for i, a in enumerate(arrs) if a is not None]

    def f(*vals):
        full = [None] * 5
        for i, v in zip(live, vals):
            full[i] = v
        x, off, mask, w, b = full
        args = (x, off, w) if mask is None else (x, off, mask, w)
        return op(*args, b)
    vals = [jnp.asarray(arrs[i]) for i in live]
    if case.get("cot") is None:
        return np.asarray(jax.jit(f)(*vals)), None
    out, vjp = jax.vjp(jax.jit(f), *vals)
    grads = [None] * 5
    for i, g in zip(live, jax.jit(vjp)(jnp.asarray(case["cot"]))):
        grads[i] = np.asarray(g)
    return np.asarray(out), grads


def assert_matches(results, name, case, want):
    """The stitched port output (and gradients) against the JAX result."""
    out, grads = want
    got = ranks.stitch(results, name, "out", out.shape,
                       lambda r: r["out"])
    np.testing.assert_allclose(got, out, rtol=2e-5, atol=2e-5)
    if grads is None:
        return
    roles = ("x", "x", "x", "weight", "bias")
    for i, (role, g) in enumerate(zip(roles, grads)):
        if g is None:
            continue
        got = ranks.stitch(results, name, role, g.shape,
                           lambda r, i=i: r["grads"][i])
        scale = float(np.abs(g).max())
        assert scale > 0, i
        np.testing.assert_allclose(got / scale, g / scale, rtol=0,
                                   atol=1e-5, err_msg=f"grad {i}")


def errors(results, name):
    """The (type, message) every rank recorded for a case that raises."""
    errs = {r: results[r][name].get("error") for r in results
            if not results[r][name].get("skip")}
    assert len(set(errs.values())) == 1, errs
    return next(iter(errs.values()))
