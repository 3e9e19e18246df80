"""bf16 on the port's 2D shift-blend pair (impl="shiftblend") against the
JAX package's (`_fwd_kernel_cols` / `_bwd_kernel` in interpret mode), at
bound 0.5 with offsets inside the bound and on it.  Cases, tolerance and
the two ways of each case: tests/torch_bf16_cases.py.

Measured on the CPU, one worker: about 40 s, most of it the JAX side in
interpret mode.
"""
import pytest

import torch_bf16_cases as bc


@pytest.mark.parametrize("mode", list(bc.MODES))
def test_shift2d_bf16_matches_jax(mode):
    bc.assert_matches("shift2d", mode,
                      bc.port_result("shift2d", mode, "shiftblend"),
                      bc.jax_result("shift2d", mode, "shiftblend"))
