"""bf16 on the port's 3D columns path (impl="cuda": a deformable group
spanning both conv groups) against the JAX package's (its columns kernels
in interpret mode and an XLA product).  Cases, tolerance and the two ways
of each case: tests/torch_bf16_cases.py.

Measured on the CPU, one worker: about 25 s, most of it the JAX side in
interpret mode.
"""
import pytest

from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm

import torch_bf16_cases as bc


@pytest.mark.parametrize("mode", list(bc.MODES))
def test_columns3d_bf16_matches_jax(mode, monkeypatch):
    calls = []
    for fn in ("cols_fwd", "cols_bwd"):
        orig = getattr(gm, fn)
        monkeypatch.setattr(gm, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append((_n, a[0].ndim - 2)), _f(*a, **k))[1])
    got = bc.port_result("cols3d", mode, "cuda")
    assert calls == [("cols_fwd", 3), ("cols_bwd", 3)]
    bc.assert_matches("cols3d", mode, got,
                      bc.jax_result("cols3d", mode, "pallas"))
