"""General-offset forward kernel: `gathermm_fwd` (csrc/gathermm_fwd.cu).

Counterpart of the JAX package's `ops/pallas/gathermm.py` forward
(`deform_conv_fused`, kernel `_fwd_fused_kernel`).  The row semantics of
its `_prep` (floor and fraction per dim, the open-interval gate folded with
the mask into the corner weights) are the corner table the CUDA kernel
builds per deformable-group slab (csrc/deform_tile.cuh::tap_weights).

`gathermm_fwd` launches the kernel on CUDA tensors and runs
`gathermm_fwd_reference`, its plain PyTorch version, on CPU tensors only.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...utils.config import DeformConvSpec
from .. import core
from . import lib

# The corner table holds K * 64 entries of 20 bytes in shared memory next to
# the 66 KB column and weight tiles (csrc/gathermm_fwd.cu).
_MAX_TAPS = 128


def ineligible_reason(x: torch.Tensor, spec: DeformConvSpec) -> Optional[str]:
    """None if the general kernel path takes this config, else a reason."""
    if spec.ndim not in (2, 3):
        return "cuda kernels support 2D and 3D only"
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return f"unsupported dtype {x.dtype}"
    if x.shape[1] % spec.deformable_groups:
        return "channels not divisible by deformable_groups"
    if spec.tap_count > _MAX_TAPS:
        return (f"more than {_MAX_TAPS} kernel taps do not fit the "
                "shared-memory corner table")
    return None


def gathermm_fwd_reference(x, offset, mask, weight, bias,
                           spec: DeformConvSpec,
                           precision: str = "tensorfloat32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function on the same
    float32 tensors (columns by gather, grouped contraction with fp32
    accumulation; "bfloat16" rounds both operands to bf16)."""
    return core._deform_conv_nd(x, offset, mask, weight, bias, spec,
                                precision=precision)


def gathermm_fwd(x, offset, mask, weight, bias, spec: DeformConvSpec,
                 precision: str = "tensorfloat32") -> torch.Tensor:
    """General-offset DCN forward, (B, O, *OS) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Inputs: float32, contiguous, on one device."""
    if x.device.type == "cpu":
        return gathermm_fwd_reference(x, offset, mask, weight, bias, spec,
                                      precision)
    lib.check_inputs("gathermm_fwd", x, offset, mask, weight, bias, spec)
    reason = ineligible_reason(x, spec)
    if reason is not None:
        raise NotImplementedError(f"gathermm_fwd: {reason}")
    B, C, H, W = x.shape
    O = weight.shape[0]
    OH, OW = spec.out_sizes((H, W))
    out = torch.empty((B, O, OH, OW), dtype=torch.float32, device=x.device)
    wt = lib.grouped_weight(weight, spec.groups)
    lib.launch("gathermm_fwd", x, (x, offset, mask, wt, bias, out), (
        B, C, H, W, O, OH, OW, spec.groups, spec.deformable_groups,
        *spec.kernel, *spec.stride, *spec.padding, *spec.dilation,
        lib.PRECISION_CODES[precision]))
    gathermm_fwd.launches += 1
    return out


gathermm_fwd.launches = 0


class _GathermmFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, spec, precision):
        return gathermm_fwd(x, offset, mask, weight, bias, spec, precision)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("backward kernel lands with slice 2")


def deform_conv_fused(x, offset, mask, weight, bias, spec: DeformConvSpec,
                      precision: str = "tensorfloat32") -> torch.Tensor:
    """Full general-offset deformable conv with bias (dispatch entry).

    bf16 and fp16 inputs are upcast to fp32 for the kernel; the result
    has x's dtype."""
    f32 = lib.as_f32
    out = _GathermmFwd.apply(f32(x), f32(offset), f32(mask), f32(weight),
                             f32(bias), spec, precision)
    return out.to(x.dtype)
