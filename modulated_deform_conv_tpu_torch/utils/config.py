"""Op-configuration dataclass and hyperparameter normalization.

A copy of the JAX package's `utils/config.py`: importing anything from that
package pulls in jax and flax, and the port must run without them.  Every
knob of one call is a frozen dataclass, so the kernel wrappers and the
plain PyTorch path see the same static configuration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

IntOrSeq = Union[int, Sequence[int]]


def ntuple(x: IntOrSeq, n: int) -> Tuple[int, ...]:
    """Normalize a scalar-or-sequence to an n-tuple (torch `_pair` /
    `_triple` analog)."""
    if isinstance(x, (tuple, list)):
        t = tuple(int(v) for v in x)
        if len(t) != n:
            raise ValueError(f"expected length-{n} tuple, got {t}")
        return t
    return (int(x),) * n


def effective_step(batch: int, in_step: int) -> int:
    """Effective micro-batch chunk = gcd(batch, in_step).

    The chunk always divides the batch, so results are independent of
    `in_step` (a pure memory knob)."""
    if in_step <= 0:
        return batch
    return math.gcd(batch, in_step)


@dataclasses.dataclass(frozen=True)
class DeformConvSpec:
    """Static configuration of one deformable-convolution call.

    Covers both 2D and 3D (ndim = number of spatial dims)."""
    ndim: int
    kernel: Tuple[int, ...]
    stride: Tuple[int, ...]
    padding: Tuple[int, ...]
    dilation: Tuple[int, ...]
    groups: int
    deformable_groups: int
    in_step: int = 64
    modulated: bool = False

    @classmethod
    def make(cls, ndim: int, kernel: IntOrSeq, stride: IntOrSeq = 1,
             padding: IntOrSeq = 0, dilation: IntOrSeq = 1, groups: int = 1,
             deformable_groups: int = 1, in_step: int = 64,
             modulated: bool = False) -> "DeformConvSpec":
        return cls(
            ndim=ndim,
            kernel=ntuple(kernel, ndim),
            stride=ntuple(stride, ndim),
            padding=ntuple(padding, ndim),
            dilation=ntuple(dilation, ndim),
            groups=int(groups),
            deformable_groups=int(deformable_groups),
            in_step=int(in_step),
            modulated=bool(modulated),
        )

    @property
    def tap_count(self) -> int:
        """K = prod(kernel): number of sampling taps per output position."""
        return math.prod(self.kernel)

    def out_sizes(self, in_sizes: Sequence[int]) -> Tuple[int, ...]:
        """floor((S + 2p - (d*(k-1)+1))/s) + 1 per axis."""
        out = []
        for s_in, k, st, p, d in zip(in_sizes, self.kernel, self.stride,
                                     self.padding, self.dilation):
            o = (s_in + 2 * p - (d * (k - 1) + 1)) // st + 1
            if o <= 0:
                raise ValueError(
                    f"non-positive output size {o} for input {s_in} with "
                    f"k={k} s={st} p={p} d={d}")
            out.append(o)
        return tuple(out)

    def validate(self, x_shape, offset_shape, weight_shape, mask_shape=None,
                 bias_shape=None, out_sizes=None) -> Tuple[int, ...]:
        """Check the shape contract; returns the output spatial sizes.

        Contract: input (B, C, *S); weight (O, C/g, *k);
        offset (B, dg*ndim*K, *OS); mask (B, dg*K, *OS); bias (O,).  OS is
        `out_sizes` where given (a sharded block's output grid), else
        derived from S."""
        nd = self.ndim
        if len(x_shape) != nd + 2:
            raise ValueError(f"input must be rank {nd + 2}, got {x_shape}")
        B, C = x_shape[0], x_shape[1]
        S = tuple(x_shape[2:])
        O, Cg = weight_shape[0], weight_shape[1]
        if tuple(weight_shape[2:]) != self.kernel:
            raise ValueError(
                f"weight kernel dims {weight_shape[2:]} != spec {self.kernel}")
        if C % self.groups or O % self.groups:
            raise ValueError(f"channels {C}->{O} not divisible by groups "
                             f"{self.groups}")
        if Cg * self.groups != C:
            raise ValueError(f"weight in-channels {Cg}*g != input C={C}")
        if C % self.deformable_groups:
            raise ValueError(f"C={C} not divisible by deformable_groups="
                             f"{self.deformable_groups}")
        OS = (self.out_sizes(S) if out_sizes is None
              else tuple(int(o) for o in out_sizes))
        K = self.tap_count
        want_off = (B, self.deformable_groups * nd * K) + OS
        if tuple(offset_shape) != want_off:
            raise ValueError(f"offset shape {offset_shape} != {want_off}")
        if self.modulated:
            want_mask = (B, self.deformable_groups * K) + OS
            if mask_shape is None or tuple(mask_shape) != want_mask:
                raise ValueError(f"mask shape {mask_shape} != {want_mask}")
        if bias_shape is not None and tuple(bias_shape) != (O,):
            raise ValueError(f"bias shape {bias_shape} != ({O},)")
        return OS
