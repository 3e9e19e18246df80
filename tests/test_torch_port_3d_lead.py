"""The port's whole-volume 3D shift-blend against the JAX package's
lead-chunked mode, the mode BASELINE config 4 runs in JAX.

A volume too large for the TPU's VMEM is split by JAX along its leading
axis into halo-extended chunks (`_choose_lead`, `_lead_chunked_shift`),
each gated at the global border; grad_x of the halo rows sums across the
chunks.  The port computes the whole volume in one launch.  The JAX side is
forced into that mode here by lowering `_X_RESIDENT_BUDGET` for the test
(as tests/test_shiftblend.py does in 2D): at 1 x 8 x (12, 4, 8) with 2 x 2 x
2 taps (dilation 2, pad 1) and bound 0.5 the unchunked plan exceeds 50,000
bytes and the volume goes in 2 chunks with 2 halo rows a side.  (The
chunks run the unrolled kernels: 216 (tap, window) pairs.  Config 4 runs
the loop path inside each chunk, which tests/test_torch_port_3d_kernels.py
covers; both together take minutes in interpret mode.)

Tolerance: forward rtol = atol = 2e-5; each gradient divided by max|JAX
gradient| within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import modulated_deform_conv_tpu as jmdc
from modulated_deform_conv_tpu.ops.pallas import shiftblend as jsb
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

import modulated_deform_conv_tpu_torch as mdt

NAMES = ("x", "offset", "mask", "weight", "bias")
B, C, S, BOUND = 1, 8, (12, 4, 8), 0.5
KW = dict(padding=1, dilation=2)


def test_shiftblend3d_matches_jax_lead_chunked(monkeypatch):
    monkeypatch.setattr(jsb, "_X_RESIDENT_BUDGET", 50000)
    spec = JSpec.make(3, 2, 1, 1, 2, 1, 1, modulated=True)
    plan = jsb.SBPlan(spec, B, C, S, S, BOUND)
    assert "residency" in plan.ineligible_reason(spec)
    assert jsb._choose_lead(jax.ShapeDtypeStruct((B, C) + S, jnp.float32),
                            spec, BOUND) == (2, 2)
    rng = np.random.default_rng(5)
    arrs = {"x": rng.standard_normal((B, C) + S),
            "offset": rng.uniform(-0.45, 0.45, (B, 24) + S),
            "mask": rng.uniform(0, 1, (B, 8) + S),
            "weight": rng.standard_normal((C, C, 2, 2, 2)) * 0.1,
            "bias": rng.standard_normal((C,))}
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    cot = rng.standard_normal((B, C) + S).astype(np.float32)

    def f(*a):
        return jmdc.modulated_deform_conv3d(*a, **KW, impl="shiftblend",
                                            precision="float32",
                                            offset_bound=BOUND)

    want_out, vjp = jax.vjp(f, *[jnp.asarray(arrs[n]) for n in NAMES])
    want = dict(zip(NAMES, jax.jit(vjp)(jnp.asarray(cot))))

    ts = {n: torch.tensor(a, requires_grad=True) for n, a in arrs.items()}
    out = mdt.modulated_deform_conv3d(*[ts[n] for n in NAMES], **KW,
                                      impl="shiftblend", offset_bound=BOUND)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=2e-5, atol=2e-5)
    for n in NAMES:
        w = np.asarray(want[n])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(ts[n].grad.numpy() / scale, w / scale,
                                   rtol=0, atol=1e-5, err_msg=n)
    # The chunk boundary runs through the middle of the volume: output rows
    # 5 and 6 draw on input rows of both chunks, and so does grad_x there.
    assert float(np.abs(np.asarray(want["x"])[0, :, 4:8]).max()) > 1e-3
