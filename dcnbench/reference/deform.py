"""A plain deformable convolution (DCNv1 / DCNv2, 2D and 3D), frozen.

The benchmark's yardstick for the deformable layers: written from the DCN
papers' equations (Dai et al. 2017, arXiv:1703.06211; Zhu et al. 2019,
arXiv:1811.11168) in plain torch, with the conventions the program
documents for its public op:

* output point o, tap f (row-major over the kernel), axis d:
    pos_d = o_d * stride_d - pad_d + f_d * dilation_d + offset[g, nd*f + d]
  where g is the deformable group of the input channel (c // (C / dg));
* a tap contributes nothing where any pos_d <= -1 or pos_d >= S_d;
* elsewhere multilinear interpolation over the 2**nd corners, a corner
  outside the input contributing zero;
* DCNv2 multiplies the sampled value by mask[g, f];
* the grouped product out[o] = sum over c, f of W[o, c, f] * sample[c, f].

Differentiable by autograd in every input.  `precision="bfloat16"` rounds
the products' operands (the sampled columns and the weight) to bfloat16
and rounds the output to bfloat16, the arithmetic of a bf16 network: the
benchmark's control.  Nothing here imports the program.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint


def out_size(s: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (s + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _sample(x, offset, mask, ks, stride, padding, dilation, dg):
    """The sampled, modulated columns (B, C, K, P) in float32 or wider."""
    nd = len(ks)
    B, C = x.shape[:2]
    S = x.shape[2:]
    OS = [out_size(S[d], ks[d], stride[d], padding[d], dilation[d])
          for d in range(nd)]
    K, P, Cg = math.prod(ks), math.prod(OS), C // dg
    acc = torch.promote_types(x.dtype, torch.float32)
    dev = x.device

    # Base position of every (tap, output point) per axis: (nd, K, P).
    taps = torch.cartesian_prod(*[torch.arange(k, device=dev) for k in ks])
    taps = taps.reshape(K, nd)
    outs = torch.cartesian_prod(*[torch.arange(o, device=dev) for o in OS])
    outs = outs.reshape(P, nd)
    base = torch.stack([
        outs[None, :, d] * stride[d] - padding[d] + taps[:, None, d]
        * dilation[d] for d in range(nd)]).to(acc)             # (nd, K, P)
    off = offset.reshape(B, dg, K, nd, P).to(acc).movedim(3, 0)
    pos = base[:, None, None] + off                      # (nd, B, dg, K, P)

    inside = torch.ones(pos.shape[1:], dtype=torch.bool, device=dev)
    for d in range(nd):
        inside &= (pos[d] > -1) & (pos[d] < S[d])
    low = torch.floor(pos)
    frac = pos - low
    low = low.long()

    xs = x.reshape(B, dg, Cg, math.prod(S)).to(acc)
    cols = torch.zeros((B, dg, Cg, K * P), dtype=acc, device=dev)
    for corner in itertools.product((0, 1), repeat=nd):
        weight = inside.to(acc)
        flat = torch.zeros_like(low[0])
        for d in range(nd):
            idx = low[d] + corner[d]
            weight = weight * (frac[d] if corner[d] else 1 - frac[d])
            weight = weight * ((idx >= 0) & (idx < S[d])).to(acc)
            flat = flat * S[d] + idx.clamp(0, S[d] - 1)
        flat = flat.reshape(B, dg, 1, K * P).expand(B, dg, Cg, K * P)
        cols = cols + torch.gather(xs, 3, flat) * weight.reshape(
            B, dg, 1, K * P)
    if mask is not None:
        cols = cols * mask.reshape(B, dg, 1, K * P).to(acc)
    return cols.reshape(B, C, K, P), OS


def _conv_block(x, offset, mask, weight, bias, ks, stride, padding,
                dilation, groups, dg, precision):
    cols, OS = _sample(x, offset, mask, ks, stride, padding, dilation, dg)
    B, C, K, P = cols.shape
    O = weight.shape[0]
    w = weight.reshape(groups, O // groups, C // groups, K)
    cols = cols.reshape(B, groups, C // groups, K, P)
    if precision == "bfloat16":
        out = torch.einsum("gock,bgckp->bgop", w.to(torch.bfloat16),
                           cols.to(torch.bfloat16)).float()
    else:
        out = torch.einsum("gock,bgckp->bgop", w.to(cols.dtype), cols)
    out = out.reshape(B, O, P)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None]
    return out.reshape((B, O) + tuple(OS))


def deform_conv(x: torch.Tensor, offset: torch.Tensor,
                mask: Optional[torch.Tensor], weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                stride: Sequence[int] = 1, padding: Sequence[int] = 0,
                dilation: Sequence[int] = 1, groups: int = 1,
                deformable_groups: int = 1, precision: str = "float32",
                col_bytes: int = 1 << 30) -> torch.Tensor:
    """The deformable convolution of x (B, C, *S) with `weight` (O, C/g,
    *k), sampled at the offsets (B, dg*nd*K, *OS), modulated by `mask`
    (B, dg*K, *OS) where given.  Runs as many samples at a time as keep
    their sampled columns under `col_bytes` (one at least), each block
    under activation checkpointing where autograd needs it."""
    nd = x.dim() - 2
    ks = tuple(weight.shape[2:])
    per_sample = 4 * x.shape[1] * math.prod(ks) * math.prod(offset.shape[2:])
    block = max(1, col_bytes // per_sample)
    tup = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd
    args = (ks, tup(stride), tup(padding), tup(dilation), groups,
            deformable_groups, precision)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, offset, mask, weight, bias))
    outs = []
    for i in range(0, x.shape[0], block):
        part = [t if t is None else t[i:i + block] for t in (x, offset, mask)]
        if grad:
            outs.append(checkpoint(_conv_block, *part, weight, bias, *args,
                                   use_reentrant=False))
        else:
            outs.append(_conv_block(*part, weight, bias, *args))
    return torch.cat(outs)

