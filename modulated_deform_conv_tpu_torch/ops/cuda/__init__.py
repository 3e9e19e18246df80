"""Hand-written CUDA kernels for the deformable-convolution hot path.

`maybe_cuda` is the dispatch hook of ops/api.py, the counterpart of the JAX
package's `maybe_pallas`: it returns a kernel's result when a kernel takes
the configuration, or None to take the plain PyTorch path (ops/core.py).
On CUDA tensors, "auto" takes a kernel wherever the JAX package takes a
Pallas kernel on its accelerator; on CPU tensors it takes the plain path,
as JAX's "auto" takes XLA off the TPU.  Which of two eligible pairs it
takes follows the device profile of x's card (utils/device.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ...utils.config import DeformConvSpec
from ...utils.device import DeviceProfile, current_profile
from . import gathermm, shiftblend
from .lib import PRECISIONS  # noqa: F401  (public)
# Shape predicates copied from the JAX package's gathermm plan: its 3D
# planar mode, and `_fuse_ok` (fused pair, or columns kernels and a GEMM).
from .plan import jax_fuse_ok as _jax_fuse_ok  # noqa: F401
from .plan import jax_planar as _jax_planar


def _prefer_shiftblend(x, spec: DeformConvSpec, offset_bound,
                       profile: DeviceProfile = None) -> bool:
    """Dispatch policy between two eligible kernels, the JAX package's
    `_prefer_shiftblend` with the constants of `profile` (None: the
    profile of x's device, utils/device.py): shift-blend for narrow channel
    slabs (C/dg <= `sb_crossover_cg`), except that in 3D at bounds of
    `sb_wide_bound_3d` or more planar gathermm wins, where the copied JAX
    plan takes its planar mode."""
    prof = profile or current_profile(x)
    if x.shape[1] // spec.deformable_groups > prof.sb_crossover_cg:
        return False
    if (spec.ndim == 3
            and max(shiftblend._bounds(offset_bound, 3))
            >= prof.sb_wide_bound_3d
            and _jax_planar(x, spec, prof)):
        return False
    return True


def select_kernel(x, spec: DeformConvSpec, offset_bound=None,
                  profile: DeviceProfile = None
                  ) -> Tuple[Optional[str], Optional[str]]:
    """("shiftblend" | "gathermm", None) for the kernel the config takes on
    a CUDA tensor, or (None, reason) when neither takes it.  `profile`: the
    dispatch constants (None: the profile of x's device)."""
    sb_reason = shiftblend.ineligible_reason(x, spec, offset_bound)
    reason = gathermm.ineligible_reason(x, spec)
    if sb_reason is None and (reason is not None or _prefer_shiftblend(
            x, spec, offset_bound, profile)):
        return "shiftblend", None
    if reason is None:
        return "gathermm", None
    return None, reason + (f"; shiftblend: {sb_reason}" if sb_reason else "")


def maybe_cuda(x, offset, mask, weight, bias, spec: DeformConvSpec,
               require: bool = False, precision: str = "tensorfloat32",
               offset_bound=None, impl: str = "auto", gate_bounds=None,
               out_sizes=None, block_origin=None,
               profile: DeviceProfile = None):
    """Return a kernel's output, or None for the plain PyTorch path.

    With require=True (impl="cuda" / "shiftblend") raises instead of
    falling back when no kernel takes the config.  The sharding layer's
    block mode (`out_sizes`, a given output grid; `gate_bounds`, a per-dim
    (lo, hi) tap gate; `block_origin`, the block's placement in the whole
    input) routes to the gather kernels only, as the JAX package's
    `maybe_pallas` routes `gate_bounds`: shift-blend's own sharded mode is
    its lead mode, which the sharding layer calls directly
    (`shiftblend.deform_conv_shift_sharded`).  `profile`: the dispatch
    constants (None: the profile of x's device)."""
    block_mode = (gate_bounds is not None or block_origin is not None
                  or out_sizes is not None)
    if impl == "shiftblend":
        reason = shiftblend.ineligible_reason(x, spec, offset_bound,
                                              out_sizes)
        if gate_bounds is not None or block_origin is not None:
            reason = reason or ("gate_bounds / block_origin overrides not "
                                "supported")
        if reason is not None:
            raise NotImplementedError(
                f"shiftblend path unavailable: {reason}")
        name = "shiftblend"
    else:
        if not require and not x.is_cuda:
            return None
        if block_mode:
            reason = gathermm.ineligible_reason(x, spec, out_sizes)
            name = "gathermm" if reason is None else None
        else:
            name, reason = select_kernel(x, spec, offset_bound, profile)
        if name is None:
            if require:
                raise NotImplementedError(
                    f"cuda path unavailable for this config: {reason}")
            return None
    if name == "shiftblend":
        return shiftblend.deform_conv_shift(x, offset, mask, weight, bias,
                                            spec, precision, offset_bound)
    return gathermm.deform_conv_fused(x, offset, mask, weight, bias, spec,
                                      precision, out_sizes, gate_bounds,
                                      block_origin, profile=profile)
