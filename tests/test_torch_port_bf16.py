"""bf16 on the port's 2D general-offset kernel paths against the JAX
package's Pallas kernels: the fused gather pair (impl="cuda" / "pallas")
and the columns path (a deformable group spanning both conv groups, which
neither package's fuse rule takes).  Cases, tolerance and the two ways of
each case (bf16 activations with fp32 weight and bias; all five in bf16):
tests/torch_bf16_cases.py.  On the CPU the port's autograd Functions run
their kernels' plain versions, which read bf16 inputs in fp32 and round
their results to the inputs' types, as the CUDA kernels do.

Measured on the CPU, one worker: about 25 s, most of it the JAX side in
interpret mode.
"""
import pytest

from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm

import torch_bf16_cases as bc


@pytest.mark.parametrize("mode", list(bc.MODES))
def test_gather2d_bf16_matches_jax(mode):
    bc.assert_matches("gather2d", mode,
                      bc.port_result("gather2d", mode, "cuda"),
                      bc.jax_result("gather2d", mode, "pallas"))


@pytest.mark.parametrize("mode", list(bc.MODES))
def test_columns2d_bf16_matches_jax(mode, monkeypatch):
    calls = []
    for fn in ("cols_fwd", "cols_bwd"):
        orig = getattr(gm, fn)
        monkeypatch.setattr(gm, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append((_n, a[0].ndim - 2)), _f(*a, **k))[1])
    got = bc.port_result("cols2d", mode, "cuda")
    assert calls == [("cols_fwd", 2), ("cols_bwd", 2)]
    bc.assert_matches("cols2d", mode, got,
                      bc.jax_result("cols2d", mode, "pallas"))
