"""GroupNorm with its epilogue in one kernel pair: y = act(GN(x) * gamma +
beta [+ identity]), act ReLU or none (csrc/groupnorm.cu), its plain
version, and `group_norm_act`, the op the backbone's norms call.

No port of a TPU kernel: the JAX backbone's GroupNorm, ReLU and residual
add are flax ops that XLA fuses into its step.  torch runs GroupNorm's
moments and apply, the ReLU and the add as separate passes over the
activation forward, and five to eight backward; the work is bound by
memory, so the kernels read each input once and write each output once,
one launch a layer each way (and one small launch that adds the
parameters' gradients over the batch).

The arithmetic, in float32 in the kernels, each output rounded to its
type once; a group (n, g) holds the L = C/G * prod(spatial) values of its
channels:

    forward   mean, rstd = the group's mean, 1 / sqrt(its variance + eps)
              y = act((x - mean) rstd gamma_c + beta_c [+ identity])
    backward  dz = dy [y > 0] with the ReLU, else dy; d_identity = dz
              S1 = sum_c gamma_c sum dz, S2 = sum_c gamma_c sum dz (x - mean)
              dx = rstd gamma_c dz - rstd S1 / L - rstd^3 (x - mean) S2 / L
              dgamma_c = sum_n rstd sum dz (x - mean), dbeta_c = sum_n sum dz

`group_norm_reference` and `group_norm_backward_reference` are that
arithmetic from torch's ops in float64: the card tests' and
chip_smoke.py's yardstick.  `norm_calls` lists a network's norms.

`group_norm_act` launches the kernels on CUDA tensors, and raises where
they do not take them (float16, an identity of another type or shape);
on CPU tensors, and in float64, it is torch's GroupNorm, add and ReLU, op
by op, as the backbone ran them before the kernels (a norm of a few
values a group amplifies float32's rounding by orders of magnitude, so
the CPU tests against the JAX package keep torch's).  `plan` splits each
group over a cluster of blocks from the shapes and the card's limits
(`Card`) alone.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import lib

# Shared memory a block keeps values in: at most SHARED_BYTES (two blocks
# an SM of the H100's 228 KiB, with room for the block's sums), and where a
# cluster of MAX_CLUSTER blocks can, at most SHARED_PREFERRED (an SM's
# share at the kernels' four blocks an SM), so that an SM overlaps more
# blocks' phases.
SHARED_BYTES = 104 * 1024
SHARED_PREFERRED = 52 * 1024
# The portable cluster size, the most blocks a group is split over; a group
# is split for parallelism alone over at most MAX_SPLIT blocks of at least
# MIN_SLICE values each (larger clusters cost more to run than they save).
MAX_CLUSTER = 8
MAX_SPLIT = 4
MIN_SLICE = 1024
# Values a vector: slices and passes are cut at multiples of it.
VEC = 4


class Card(NamedTuple):
    """What the plan reads of the card: its SMs, the blocks an SM the
    kernels are compiled for (their launch bounds), its shared memory an
    SM in bytes."""
    sms: int
    blocks_per_sm: int
    sm_shared: int


def _slice(L: int, k: int) -> int:
    """ceil(L / k), rounded up to a multiple of VEC."""
    return -(-(-(-L // k)) // VEC) * VEC


def plan(N: int, G: int, L: int, itemsize: int, arrays: int,
         card: Card) -> Tuple[int, int, int]:
    """(k, slice, chunk): a group of L values is split over a cluster of k
    blocks of `slice` values each, which keep `chunk` values of each of
    their `arrays` inputs (1 forward: x; 2 backward: dz and x) in shared
    memory at a time.  k is the least that keeps a slice within
    SHARED_PREFERRED (else MAX_CLUSTER), then doubles up to MAX_SPLIT while
    the N * G * 2k blocks still run at once on `card` and their slices
    keep MIN_SLICE values.  chunk is the slice where it fits
    SHARED_BYTES: one pass, the inputs read once; else as much as fits, and
    the block reads its inputs again for the apply."""
    def nbytes(k):
        return _slice(L, k) * itemsize * arrays

    def at_once(k):
        per_sm = min(card.blocks_per_sm,
                     card.sm_shared // (nbytes(k) + 2048))
        return N * G * k <= card.sms * per_sm

    k = 1
    while k < MAX_CLUSTER and nbytes(k) > SHARED_PREFERRED:
        k *= 2
    while (k < MAX_SPLIT and at_once(2 * k)
           and _slice(L, 2 * k) >= MIN_SLICE):
        k *= 2
    sl = _slice(L, k)
    chunk = (sl if nbytes(k) <= SHARED_BYTES
             else SHARED_BYTES // (itemsize * arrays) // VEC * VEC)
    return k, sl, chunk


def card_of(device: torch.device) -> Card:
    """The `Card` of a CUDA device, from the kernels' library."""
    return _card(torch.cuda.current_device() if device.index is None
                 else device.index)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Card:
    fn = lib.kernel("groupnorm", "groupnorm_card")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    err = fn(index, out)
    if err:
        raise RuntimeError(f"groupnorm_card: CUDA error {err}")
    return Card(*out)


def _groups_shape(x: torch.Tensor, num_groups: int):
    """(N, C, S, L): batch, channels, values a channel, values a group."""
    N, C = x.shape[:2]
    S = math.prod(x.shape[2:])
    return N, C, S, C // num_groups * S


def group_norm_reference(x, num_groups: int, weight, bias, eps: float,
                         identity=None, relu: bool = False):
    """The kernels' forward from torch's ops in float64: (y in x's type,
    mean, rstd), mean and rstd (N, G) float64."""
    x64 = x.double()
    var, mean = torch.var_mean(x64.reshape(x.shape[0], num_groups, -1), -1,
                               unbiased=False)
    z = F.group_norm(x64, num_groups, weight.double(), bias.double(), eps)
    z = z if identity is None else z + identity.double()
    return (z.relu() if relu else z).to(x.dtype), mean, (var + eps).rsqrt()


def group_norm_backward_reference(dy, x, y, weight, num_groups: int,
                                  eps: float, relu: bool, identity: bool):
    """The kernels' backward from torch's autograd in float64: (dx,
    dgamma, dbeta, d_identity or None), dx and d_identity in x's type,
    dgamma and dbeta in the weight's.  The ReLU's mask is y's, the forward
    output that the backward reads (read only with the ReLU)."""
    x64 = x.double().requires_grad_(True)
    w64 = weight.double().requires_grad_(True)
    b64 = torch.zeros_like(w64, requires_grad=True)
    dz = dy.double() * (y > 0) if relu else dy.double()
    dx, dgamma, dbeta = torch.autograd.grad(
        F.group_norm(x64, num_groups, w64, b64, eps), (x64, w64, b64), dz)
    return (dx.to(x.dtype), dgamma.to(weight.dtype), dbeta.to(weight.dtype),
            dz.to(x.dtype) if identity else None)


def norm_calls(net, shape) -> list:
    """(x's shape, groups, identity given, relu) of every norm `net` runs
    (models/backbone.py's calls of `group_norm_act`) on an input of
    `shape`, in call order.  `net` is on the meta device: nothing is
    computed."""
    from ...models import backbone
    calls, real = [], backbone.group_norm_act

    def spy(x, G, w, b, eps, identity=None, relu=False):
        calls.append((tuple(x.shape), G, identity is not None, relu))
        return real(x, G, w, b, eps, identity, relu)

    backbone.group_norm_act = spy
    try:
        with torch.no_grad():
            net(torch.empty(shape, device="meta"))
    finally:
        backbone.group_norm_act = real
    return calls


def _check(name: str, x, num_groups: int, params, like) -> None:
    """Raise unless the kernels take these tensors as they are: x CUDA,
    float32 or bfloat16, contiguous, at least 2D, C divisible by
    num_groups, a group under 2**31 values; each of `params` (C,) float32
    on x's device; each of `like` (None skipped) of x's shape, type and
    device, contiguous."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in lib.IO_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim < 2 or x.shape[1] % num_groups or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (N, C, ...) "
                         f"tensor with C divisible by {num_groups}, got "
                         f"{tuple(x.shape)}")
    if _groups_shape(x, num_groups)[3] >= 2 ** 31:
        raise ValueError(f"{name}: a group of {tuple(x.shape)} holds 2**31 "
                         "values or more")
    for t in params:
        if (t.shape != (x.shape[1],) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: weight and bias must be contiguous "
                             f"float32 ({x.shape[1]},) tensors on {x.device}")
    for t in like:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every activation must be a "
                             f"contiguous {x.dtype} {tuple(x.shape)} tensor "
                             f"on {x.device}")


def groupnorm_fwd(x, num_groups: int, weight, bias, eps: float,
                  identity=None, relu: bool = False,
                  route: Optional[Tuple[int, int, int]] = None):
    """The forward kernel: (y, mean, rstd), those of
    `group_norm_reference` rounded to float32 (y to x's type), on CUDA
    tensors only (weight and bias float32).  `route` forces
    the plan (k, slice, chunk) for tests and timing; None takes `plan`'s.
    Counts the values it normalises in the launch table (`lib.counts`)."""
    _check("groupnorm_fwd", x, num_groups, (weight, bias), (identity,))
    N, C, S, L = _groups_shape(x, num_groups)
    k, sl, chunk = route or plan(N, num_groups, L, x.element_size(), 1,
                                 card_of(x.device))
    y = torch.empty_like(x)
    stats = torch.empty((2, N, num_groups), dtype=torch.float32,
                        device=x.device)
    lib.launch("groupnorm", x, [x, weight, bias, identity, y, stats[0],
                                stats[1]],
               [N, C, S, num_groups, int(relu), lib.IO_CODES[x.dtype], k, sl,
                chunk], [eps], entry="groupnorm_fwd", values=x.numel())
    return y, stats[0], stats[1]


def groupnorm_bwd(dy, x, y, mean, rstd, weight, num_groups: int,
                  relu: bool, identity: bool,
                  route: Optional[Tuple[int, int, int]] = None):
    """The backward kernel and its parameters' sum: (dx, dgamma, dbeta,
    d_identity or None), those of `group_norm_backward_reference` in
    float32, on CUDA tensors only (weight float32; y read only with the ReLU).
    `route` as in `groupnorm_fwd`."""
    if relu and y is None:
        raise ValueError("groupnorm_bwd: the ReLU's backward reads y")
    _check("groupnorm_bwd", x, num_groups, (weight,),
           (dy, y if relu else None))
    N, C, S, L = _groups_shape(x, num_groups)
    for label, t in (("mean", mean), ("rstd", rstd)):
        if (t.shape != (N, num_groups) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"groupnorm_bwd: {label} must be the forward's "
                             f"float32 ({N}, {num_groups})")
    k, sl, chunk = route or plan(N, num_groups, L, x.element_size(), 2,
                                 card_of(x.device))
    dx = torch.empty_like(x)
    did = torch.empty_like(x) if identity else None
    part = torch.empty((N, 2, C), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, C), dtype=torch.float32, device=x.device)
    lib.launch("groupnorm", x, [dy, x, y if relu else None, mean, rstd,
                                weight, dx, did, part, grads[0], grads[1]],
               [N, C, S, num_groups, lib.IO_CODES[x.dtype], k, sl, chunk],
               entry="groupnorm_bwd")
    return dx, grads[0], grads[1], did


class _GroupNormAct(torch.autograd.Function):
    """act(GroupNorm(x) [+ identity]) on the kernels.  Saves x, mean, rstd
    and, with the ReLU, y: what torch's GroupNorm and ReLU save."""

    @staticmethod
    def forward(ctx, x, weight, bias, identity, num_groups, eps, relu):
        y, mean, rstd = groupnorm_fwd(
            x, num_groups, weight.detach().float().contiguous(),
            bias.detach().float().contiguous(), eps, identity, relu)
        ctx.num_groups, ctx.relu = num_groups, relu
        ctx.identity = identity is not None
        ctx.save_for_backward(x, weight, mean, rstd, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd, y = ctx.saved_tensors
        dx, dgamma, dbeta, did = groupnorm_bwd(
            dy.contiguous(), x, y, mean, rstd,
            weight.detach().float().contiguous(), ctx.num_groups, ctx.relu,
            ctx.identity)
        return (dx, dgamma.to(weight.dtype), dbeta.to(weight.dtype), did,
                None, None, None)


def group_norm_act(x, num_groups: int, weight, bias, eps: float,
                   identity=None, relu: bool = False) -> torch.Tensor:
    """act(group_norm(x) * weight + bias [+ identity]), act ReLU where
    `relu`, as one op: the kernel pair on CUDA tensors (x and identity
    float32 or bfloat16, of one type and shape, else it raises; weight and
    bias of any floating type), torch's ops on CPU tensors and in float64.
    Differentiable in x, weight, bias and identity."""
    if weight is None or bias is None:
        raise ValueError("group_norm_act takes an affine GroupNorm: weight "
                         "and bias")
    if not x.is_cuda or x.dtype == torch.float64:
        y = F.group_norm(x, num_groups, weight, bias, eps)
        y = y if identity is None else y + identity
        return F.relu(y) if relu else y
    return _GroupNormAct.apply(
        x.contiguous(), weight, bias,
        None if identity is None else identity.contiguous(), num_groups, eps,
        relu)
