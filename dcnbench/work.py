"""The yardstick's arithmetic: an op's bytes and operations from its
shapes, the card's published peaks and the least time they allow.

Copied from the repo's chip_smoke.py (`work`, `bound_of`,
`HBM_BYTES_PER_S`, `PEAK_OPS`) so that the count does not move with the
program.  It is the op-level count: each input read once and each output
written once, 2·B·P·O·(C/g)·K operations forward and twice that backward,
whatever buffers a kernel keeps in between.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM, published dense peaks at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "tensorfloat32": 495e12, "bfloat16": 989e12}
MAIN_PRECISION = "tensorfloat32"   # the ops' default mode


def dcn_work(x_shape: Sequence[int], offset_shape: Sequence[int],
             mask_shape, weight_shape: Sequence[int], bias_shape,
             out_numel: int, groups: int, elem: int = 4
             ) -> Dict[str, Tuple[int, int]]:
    """{"fwd": (bytes, ops), "bwd": (bytes, ops)} of one deformable conv:
    the forward reads x, offset, mask, weight (and bias) and writes the
    output; the backward reads the inputs and the output's gradient and
    writes a gradient of each input."""
    in_bytes = elem * sum(math.prod(s) for s in
                          (x_shape, offset_shape, mask_shape, weight_shape)
                          if s is not None)
    bias_bytes = 0 if bias_shape is None else elem * math.prod(bias_shape)
    ops = 2 * out_numel * (x_shape[1] // groups) * math.prod(weight_shape[2:])
    out_bytes = elem * out_numel
    return {"fwd": (in_bytes + out_bytes + bias_bytes, ops),
            "bwd": (2 * in_bytes + out_bytes, 2 * ops)}


def bound_s(n_bytes: float, n_ops: float,
            precision: str = MAIN_PRECISION) -> float:
    """The least time on the card, in seconds: bytes at the HBM peak or
    operations at the precision's peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[precision])
