"""bf16 on the port's 3D fused pairs against the JAX package's 3D gather
kernels (impl="pallas", interpret mode), at bound 0.5 with offsets inside
the bound and on it: the port's gather pair (impl="cuda") and its
shift-blend pair (impl="shiftblend"), which compute the gather's function
there (the window keeps both corners of every axis).  JAX's own 3D
shift-blend pair takes about 70 s in interpret mode, so the port's is held
against the gather kernels' result, computed once.  Cases, tolerance and
the two ways of each case: tests/torch_bf16_cases.py.

Measured on the CPU, one worker: about 40 s, most of it the JAX side in
interpret mode.
"""
import pytest

import torch_bf16_cases as bc


@pytest.mark.parametrize("impl", ["cuda", "shiftblend"])
@pytest.mark.parametrize("mode", list(bc.MODES))
def test_bounded3d_bf16_matches_jax_gather(mode, impl):
    bc.assert_matches("bounded3d", mode,
                      bc.port_result("bounded3d", mode, impl),
                      bc.jax_result("bounded3d", mode, "pallas"))
