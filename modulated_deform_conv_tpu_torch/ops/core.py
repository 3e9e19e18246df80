"""Core N-d deformable convolution in plain PyTorch: the reference op.

This is the port's counterpart of the JAX package's `ops/core.py` (its
"xla" impl) and the oracle every kernel of the port is held against.  It
runs in 2D and 3D, on the CPU and on the card, and its backward comes from
autograd.

Semantics contract (shared with the JAX package):

* sample position per output point o, tap f = (i..), dim d:
    pos_d = o_d*stride_d - pad_d + i_d*dilation_d + offset[d, f];
* the whole tap is zeroed iff any pos_d <= -1 or pos_d >= S_d (the open
  interval gate);
* otherwise multilinear interpolation where out-of-image corners
  contribute zero;
* modulated variants multiply the sampled value by a per-tap mask;
* input channel c uses deformable group c // (C / deformable_groups);
* offset channel layout per deformable group: ndim*f + d for tap f;
* grouped GEMM out[g] = W[g] @ cols[g], then bias in fp32, then a cast.

Trap: on CUDA the backward of `torch.gather` is an atomic `scatter_add`,
so gradients of this path are not bitwise deterministic there unless
`torch.use_deterministic_algorithms(True)` is on.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.config import DeformConvSpec, effective_step

# Per-chunk budget for the column intermediate; tests lower it to exercise
# the chunked paths.
_COL_BYTES_CAP = 1 << 30


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sampling / accumulation precision: fp32, or the input's if wider."""
    return torch.promote_types(torch.float32, dtype)


def _base_positions(spec: DeformConvSpec, out_sizes: Tuple[int, ...],
                    device) -> torch.Tensor:
    """Sampling-grid base (ndim, K, P) float32:
    base[d, f, p] = o_d(p)*stride_d - pad_d + i_d(f)*dilation_d."""
    nd = spec.ndim
    K = spec.tap_count
    P = math.prod(out_sizes)
    taps = np.stack(np.meshgrid(*[np.arange(k) for k in spec.kernel],
                                indexing="ij"), axis=0).reshape(nd, K)
    ostride = [1] * nd
    for d in range(nd - 2, -1, -1):
        ostride[d] = ostride[d + 1] * out_sizes[d + 1]
    flat = torch.arange(P, device=device)
    rows = []
    for d in range(nd):
        out_d = ((flat // ostride[d]) % out_sizes[d]).to(torch.float32)
        tap_d = torch.as_tensor(taps[d], dtype=torch.float32, device=device)
        rows.append(out_d[None, :] * spec.stride[d] - spec.padding[d]
                    + tap_d[:, None] * spec.dilation[d])
    return torch.stack(rows)


def deform_conv_columns(x: torch.Tensor, offset: torch.Tensor,
                        mask: Optional[torch.Tensor], spec: DeformConvSpec,
                        out_sizes: Optional[Tuple[int, ...]] = None,
                        gate_bounds=None, corner_window=None,
                        block_origin=None) -> torch.Tensor:
    """Offset-driven gather producing the column tensor.

    Args:
      x:      (B, C, *S) input.
      offset: (B, dg*ndim*K, *OS) fractional offsets.
      mask:   (B, dg*K, *OS) modulation scalars, or None.
      spec:   static op configuration.
      gate_bounds: optional per-dim (lo, hi) replacing the default open
        interval tap gate (-1, S_d); the sharding layer gates its
        halo-extended blocks at the global border with it.
      corner_window: optional per-dim (lo, W) of the bounded-offset
        contract (the shift-blend kernel's): along axis d, corner c of a tap
        is kept only if lo <= floor(pos_d) - anchor_d + c <= lo + W - 1,
        the anchor base_d + shift in the whole input, and only inside the
        gate, as the shift-blend op checks its corners against the image it
        gates at (in a block: the whole input's image).
      block_origin: optional per-dim (shift, origin) placing x, a block of a
        larger input, in it: the position is taken in the whole input,
        (base_d + shift) + offset, rounded as it rounds there, and gated
        there (the gate moved by the origin); only the integer low corner
        moves to the block, floor(pos_d) - origin.  The sharding layer's
        blocks.

    Returns:
      columns (B, P, C, K), sampled in >= fp32 and cast back to x.dtype.
    """
    nd, dg = spec.ndim, spec.deformable_groups
    B, C = x.shape[0], x.shape[1]
    S = tuple(x.shape[2:])
    OS = spec.out_sizes(S) if out_sizes is None else tuple(out_sizes)
    K, P = spec.tap_count, math.prod(OS)
    Cg = C // dg
    acc = _acc_dtype(x.dtype)

    base = _base_positions(spec, OS, x.device).permute(1, 0, 2)  # (K, nd, P)
    off = offset.reshape(B, dg, K, nd, P).to(acc)
    if block_origin is not None:
        shift, origin = (torch.tensor(v, dtype=torch.float32,
                                      device=x.device).reshape(nd, 1)
                         for v in zip(*block_origin))
        base = base + shift
    pos = base[None, None] + off                          # (B, dg, K, nd, P)

    gate = torch.ones(pos.shape[:3] + pos.shape[4:], dtype=torch.bool,
                      device=x.device)                        # (B, dg, K, P)
    gates = []        # per dim, the gate in the whole input's coordinates
    for d in range(nd):
        lo = -1.0 if gate_bounds is None else gate_bounds[d][0]
        hi = float(S[d]) if gate_bounds is None else gate_bounds[d][1]
        o = 0.0 if block_origin is None else float(block_origin[d][1])
        gates.append((lo + o, hi + o))
        gate = (gate & (pos[:, :, :, d] > lo + o)
                & (pos[:, :, :, d] < hi + o))

    low = torch.floor(pos)
    frac = pos - low
    # The window is taken in the whole input, around the tap's anchor there
    # (base + shift), before the low corner moves to the block.
    glow = low if corner_window is not None else None
    rel = None if corner_window is None else low - base[None, None]
    if block_origin is not None:
        low = low - origin.to(low.dtype)
    ilow = low.to(torch.int64)

    s_flat = math.prod(S)
    x_cl = x.movedim(1, -1).reshape(B, s_flat, dg, Cg)
    spatial_stride = [1] * nd
    for d in range(nd - 2, -1, -1):
        spatial_stride[d] = spatial_stride[d + 1] * S[d + 1]

    val = torch.zeros((B, K * P, dg, Cg), dtype=acc, device=x.device)
    # Static loop over the 2^nd interpolation corners.
    for corner in itertools.product((0, 1), repeat=nd):
        w = torch.ones(pos.shape[:3] + pos.shape[4:], dtype=acc,
                       device=x.device)                       # (B, dg, K, P)
        valid = gate.clone()
        flat_idx = torch.zeros_like(w, dtype=torch.int64)
        for d in range(nd):
            idx_d = ilow[:, :, :, d] + corner[d]
            valid &= (idx_d >= 0) & (idx_d <= S[d] - 1)
            if rel is not None:
                lo_d, win_d = corner_window[d]
                row = rel[:, :, :, d] + corner[d]
                g_d = glow[:, :, :, d] + corner[d]
                valid &= ((row >= lo_d) & (row <= lo_d + win_d - 1)
                          & (g_d > gates[d][0]) & (g_d < gates[d][1]))
            w = w * (frac[:, :, :, d] if corner[d]
                     else 1.0 - frac[:, :, :, d])
            flat_idx = flat_idx + idx_d.clamp(0, S[d] - 1) * spatial_stride[d]
        w = torch.where(valid, w, torch.zeros((), dtype=acc, device=x.device))
        gidx = flat_idx.permute(0, 2, 3, 1).reshape(B, K * P, dg)
        v = torch.gather(x_cl, 1, gidx[..., None].expand(B, K * P, dg, Cg))
        wq = w.permute(0, 2, 3, 1).reshape(B, K * P, dg)[..., None]
        val = val + wq * v.to(acc)

    if mask is not None:
        m = mask.reshape(B, dg, K, P).to(acc)
        val = val * m.permute(0, 2, 3, 1).reshape(B, K * P, dg)[..., None]

    # (B, K*P, dg, Cg) -> (B, P, C, K)
    cols = val.reshape(B, K, P, dg, Cg).permute(0, 2, 3, 4, 1)
    return cols.reshape(B, P, C, K).to(x.dtype)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _deform_conv_nd(x, offset, mask, weight, bias, spec: DeformConvSpec,
                    out_sizes: Optional[Tuple[int, ...]] = None,
                    precision: str = "tensorfloat32", gate_bounds=None,
                    corner_window=None, block_origin=None) -> torch.Tensor:
    """One un-chunked forward: column gather, grouped contraction with
    >= fp32 accumulation, bias in >= fp32, cast to x.dtype.

    precision="bfloat16" rounds the columns and the weights to bf16 before
    the contraction (bf16 operands, fp32 accumulation); the other modes
    contract in full fp32 here."""
    B, C = x.shape[0], x.shape[1]
    OS = spec.out_sizes(x.shape[2:]) if out_sizes is None else tuple(out_sizes)
    P = math.prod(OS)
    K, g = spec.tap_count, spec.groups
    O = weight.shape[0]
    acc = _acc_dtype(x.dtype)

    cols = deform_conv_columns(x, offset, mask, spec, OS,
                               gate_bounds=gate_bounds,
                               corner_window=corner_window,
                               block_origin=block_origin)     # (B, P, C, K)
    cols = cols.reshape(B, P, g, C // g, K).to(acc)
    w = weight.reshape(g, O // g, C // g, K).to(x.dtype).to(acc)
    if precision == "bfloat16":
        cols, w = _round_bf16(cols), _round_bf16(w)
    out = torch.einsum("bpgck,gock->bpgo", cols, w).reshape(B, P, O)
    if bias is not None:
        out = out + bias.to(acc)[None, None, :]
    out = out.to(x.dtype).reshape((B,) + tuple(OS) + (O,))
    return out.movedim(-1, 1)                                 # (B, O, *OS)


def conv_vjp(x, offset, mask, weight, grad_out, spec: DeformConvSpec,
             precision: str = "tensorfloat32", corner_window=None,
             out_sizes=None, gate_bounds=None, block_origin=None):
    """(grad_x, grad_offset, grad_mask, grad_weight) of the bias-free
    `_deform_conv_nd` at these inputs for the cotangent `grad_out`, by
    autograd; grad_mask is None without a mask.  The kernels' backward
    wrappers use it as their plain version (bias is added outside them)."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in (x, offset, mask, weight)]
        out = _deform_conv_nd(ins[0], ins[1], ins[2], ins[3], None, spec,
                              out_sizes=out_sizes, precision=precision,
                              gate_bounds=gate_bounds,
                              corner_window=corner_window,
                              block_origin=block_origin)
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(out, live, grad_out))
    return tuple(None if t is None else next(grads) for t in ins)


def _remat(fn, *tensors):
    """Run `fn` under activation checkpointing when autograd will need it:
    the chunk's columns are recomputed in the backward instead of saved."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return checkpoint(fn, *tensors, use_reentrant=False)
    return fn(*tensors)


def _row_chunked(x, offset, mask, weight, bias, spec: DeformConvSpec,
                 OS, nb0: int, precision: str = "tensorfloat32",
                 gate_bounds=None) -> torch.Tensor:
    """Evaluate the op in blocks of the leading output dim.

    Bounds the per-block column intermediate for very large volumes.  The
    block's local output grid maps to global coordinates by folding the
    block origin into the dim-0 offset channels, so sample positions stay
    global and the gate bounds pass through unshifted."""
    nd = spec.ndim
    B = x.shape[0]
    blk0 = OS[0] // nb0
    blk_os = (blk0,) + tuple(OS[1:])
    K, dg = spec.tap_count, spec.deformable_groups
    acc = _acc_dtype(offset.dtype)

    off_r = offset.reshape((B, dg * K, nd) + tuple(OS))
    ch_shift = torch.zeros((dg * K, nd), dtype=acc, device=offset.device)
    ch_shift[:, 0] = 1.0
    ch_shift = ch_shift.reshape((1, dg * K, nd) + (1,) * nd)
    mask_r = None if mask is None else mask.reshape((B, dg * K) + tuple(OS))

    def block(off_blk, m_blk, x, weight, bias):
        return _deform_conv_nd(x, off_blk, m_blk, weight, bias, spec,
                               out_sizes=blk_os, precision=precision,
                               gate_bounds=gate_bounds)

    outs = []
    for i in range(nb0):
        o0 = i * blk0
        # The origin shift is added in >= fp32: in bf16 or fp16 it would
        # quantize the sample position.
        off_blk = (off_r.narrow(3, o0, blk0).to(acc)
                   + ch_shift * float(o0 * spec.stride[0]))
        off_blk = off_blk.reshape((B, dg * nd * K) + blk_os)
        m_blk = (None if mask_r is None else
                 mask_r.narrow(2, o0, blk0).reshape((B, dg * K) + blk_os))
        outs.append(_remat(block, off_blk, m_blk, x, weight, bias))
    return torch.cat(outs, dim=2)


def deform_conv_nd(x: torch.Tensor, offset: torch.Tensor,
                   mask: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: Optional[torch.Tensor], spec: DeformConvSpec,
                   out_sizes: Optional[Tuple[int, ...]] = None,
                   precision: str = "tensorfloat32",
                   gate_bounds=None, block_origin=None) -> torch.Tensor:
    """Full forward with `in_step` micro-batch chunking.

    `in_step` is a pure memory knob: the chunk is gcd(batch, in_step),
    further capped so one chunk's columns stay under `_COL_BYTES_CAP`, and
    the result does not depend on it.  When even one sample's columns
    exceed the cap, the leading output dim is chunked instead."""
    B = x.shape[0]
    step = effective_step(B, spec.in_step)
    OS = spec.out_sizes(x.shape[2:]) if out_sizes is None else tuple(out_sizes)
    bytes_per_sample = (spec.tap_count * math.prod(OS) * x.shape[1]
                        * max(4, x.element_size()))
    cap = max(1, _COL_BYTES_CAP // bytes_per_sample)
    if bytes_per_sample > _COL_BYTES_CAP and out_sizes is None:
        total = B * bytes_per_sample
        for nb0 in range(2, OS[0] + 1):
            if OS[0] % nb0 == 0 and total // nb0 <= _COL_BYTES_CAP:
                return _row_chunked(x, offset, mask, weight, bias, spec,
                                    OS, nb0, precision, gate_bounds)
        if bytes_per_sample // OS[0] > _COL_BYTES_CAP:
            raise ValueError(
                "deformable-conv column intermediate too large even with "
                f"row chunking ({bytes_per_sample // OS[0]} bytes per "
                "output row); reduce the spatial extent or channel count")
    while step > cap or B % step:
        step -= 1
    if step >= B or step <= 0:
        return _deform_conv_nd(x, offset, mask, weight, bias, spec,
                               out_sizes, precision, gate_bounds,
                               block_origin=block_origin)

    def chunk(xc, oc, mc, weight, bias):
        return _deform_conv_nd(xc, oc, mc, weight, bias, spec, out_sizes,
                               precision, gate_bounds,
                               block_origin=block_origin)

    outs = []
    for i in range(0, B, step):
        mc = None if mask is None else mask[i:i + step]
        outs.append(_remat(chunk, x[i:i + step], offset[i:i + step], mc,
                           weight, bias))
    return torch.cat(outs, dim=0)
