"""Hand-written CUDA kernels for the deformable-convolution hot path.

`maybe_cuda` is the dispatch hook of ops/api.py, the counterpart of the JAX
package's `maybe_pallas`: it returns a kernel's result when a kernel takes
the configuration, or None to take the plain PyTorch path (ops/core.py).
On CUDA tensors, "auto" takes a kernel wherever the JAX package takes a
Pallas kernel on its accelerator; on CPU tensors it takes the plain path,
as JAX's "auto" takes XLA off the TPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from ...utils.config import DeformConvSpec
from . import gathermm, shiftblend
from .lib import PRECISIONS  # noqa: F401  (public)

# Shift-blend when C/dg <= this, gathermm above.  Measured on v5e, not yet
# on the H100: the TPU's VPU-sweep vs MXU balance set it.
SB_CROSSOVER_CG = 128
# The JAX package's 3D rule: at bounds >= 1.5, gathermm when its planar mode
# applies.  Measured on v5e; on the H100 the pair it picks at BASELINE
# config 3 is the slower one per training step (PERF.md), and it stays the
# JAX package's until a sweep on the H100 replaces it.  Whether planar mode
# applies follows from the JAX package's v5e plan budgets
# (utils/device.py:75-122): a K*P_tile lane budget of 4608, an A-chunk of
# 2 MB (twice that for a planar chunk) and an input plane of 40 MB.
SB_WIDE_BOUND_3D = 1.5
LANE_BUDGET = 4608
A_CHUNK_BYTES = 2 * 1024 * 1024
X_PLANE_BYTES = 40 * 1024 * 1024


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def _jax_planar(x, spec: DeformConvSpec) -> bool:
    """Would the JAX package's gathermm plan take its 3D planar mode here?
    The decision of `gathermm._Plan` (gathermm.py:237-303) as a shape
    predicate: an in-plane chunk dividing the plane near plane/8, output
    tiles of whole rows near 256 positions, tap groups within the lane
    budget, the chunk within twice the A-chunk budget, and no streaming of
    the input plane."""
    S, OS = tuple(x.shape[2:]), spec.out_sizes(x.shape[2:])
    plane, run = S[1] * S[2], OS[2]
    cands = [d for d in range(8, plane + 1, 8) if plane % d == 0]
    if not cands or plane < 2 * min(cands):
        return False
    tgt = max(128, plane // 8)
    sch = min(cands, key=lambda d: abs(d - tgt))
    rows = min(_divisors(OS[1]), key=lambda r: abs(r * run - 256))
    pt = rows * run
    pt8 = -(-pt // 8) * 8
    ki = max((d for d in _divisors(spec.tap_count // spec.kernel[0])
              if d * pt8 <= LANE_BUDGET), default=1)
    if pt8 != pt or ki * pt * sch * 4 > 2 * A_CHUNK_BYTES:
        return False
    # Planar mode is dropped when even a channel-part split leaves the
    # (volume, channels) plane over the budget.
    sflat, cg, ncp = math.prod(S), x.shape[1] // spec.deformable_groups, 1
    while (sflat * (cg // ncp) * 4 > X_PLANE_BYTES and cg % (ncp * 2) == 0
           and cg // (ncp * 2) >= 8):
        ncp *= 2
    return sflat * (cg // ncp) * 4 <= X_PLANE_BYTES


def _prefer_shiftblend(x, spec: DeformConvSpec, offset_bound) -> bool:
    """Dispatch policy between two eligible kernels, the JAX package's
    `_prefer_shiftblend`: shift-blend for narrow channel slabs, except that
    in 3D at wide bounds planar gathermm wins."""
    if x.shape[1] // spec.deformable_groups > SB_CROSSOVER_CG:
        return False
    if (spec.ndim == 3
            and max(shiftblend._bounds(offset_bound, 3)) >= SB_WIDE_BOUND_3D
            and _jax_planar(x, spec)):
        return False
    return True


def select_kernel(x, spec: DeformConvSpec, offset_bound=None
                  ) -> Tuple[Optional[str], Optional[str]]:
    """("shiftblend" | "gathermm", None) for the kernel the config takes on
    a CUDA tensor, or (None, reason) when neither takes it."""
    sb_reason = shiftblend.ineligible_reason(x, spec, offset_bound)
    reason = gathermm.ineligible_reason(x, spec)
    if sb_reason is None and (reason is not None or _prefer_shiftblend(
            x, spec, offset_bound)):
        return "shiftblend", None
    if reason is None:
        return "gathermm", None
    return None, reason + (f"; shiftblend: {sb_reason}" if sb_reason else "")


def maybe_cuda(x, offset, mask, weight, bias, spec: DeformConvSpec,
               require: bool = False, precision: str = "tensorfloat32",
               offset_bound=None, impl: str = "auto", gate_bounds=None):
    """Return a kernel's output, or None for the plain PyTorch path.

    With require=True (impl="cuda" / "shiftblend") raises instead of
    falling back when no kernel takes the config.  `gate_bounds` that would
    take a kernel raise: that mode of the kernels is not ported yet, and
    the plain path would hide that."""
    if impl == "shiftblend":
        reason = shiftblend.ineligible_reason(x, spec, offset_bound)
        if reason is not None:
            raise NotImplementedError(
                f"shiftblend path unavailable: {reason}")
        name = "shiftblend"
    else:
        if not require and not x.is_cuda:
            return None
        name, reason = select_kernel(x, spec, offset_bound)
        if name is None:
            if require:
                raise NotImplementedError(
                    f"cuda path unavailable for this config: {reason}")
            return None
    if gate_bounds is not None:
        raise NotImplementedError(
            "gate_bounds on the kernel path is not ported yet (the sharding "
            "slice of the port); pass impl='torch'")
    if name == "shiftblend":
        return shiftblend.deform_conv_shift(x, offset, mask, weight, bias,
                                            spec, precision, offset_bound)
    return gathermm.deform_conv_fused(x, offset, mask, weight, bias, spec,
                                      precision)
