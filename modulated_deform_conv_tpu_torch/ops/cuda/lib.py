"""Build, load and launch the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled at first use
by `nvcc` into `build/lib<name>-<hash>.so` at the repository root (the hash
covers the sources and flags, so an edited source builds anew) and loaded
with ctypes.  `build()` starts one `nvcc` per source, all at once.  Nothing
here runs at import: the package imports on machines without CUDA.

`launch` keeps the launch table: every launch it makes, by C entry, and
the values of the launches whose callers count them.  `counts` reads it.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, NamedTuple, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
KERNELS = ("gathermm_fwd", "shiftblend_fwd", "gathermm_bwd", "shiftblend_bwd",
           "gathermm3d_fwd", "shiftblend3d_fwd", "gathermm3d_bwd",
           "shiftblend3d_bwd", "gathermm_cols_fwd", "gathermm_cols_bwd",
           "gathermm3d_cols_fwd", "gathermm3d_cols_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# Precision modes as the kernels number them (csrc/deform_tile.cuh).
PRECISION_CODES = {"float32": 0, "tensorfloat32": 1, "bfloat16": 2}
PRECISIONS = tuple(PRECISION_CODES)
# The activations' types the kernels read and write as they are, as their
# `io` argument numbers them (csrc/deform_tile.cuh, with_io).
IO_CODES = {torch.float32: 0, torch.bfloat16: 1}

_FUNCS: Dict[str, object] = {}
_LAUNCHES: collections.Counter = collections.Counter()
_VALUES: collections.Counter = collections.Counter()


class Counts(NamedTuple):
    """A snapshot of the launch table, by C entry: the launches, and the
    values of the launches whose callers count them (the AdamW update's
    values updated, the column forward's column values written, the
    GroupNorm forward's values normalised).  One snapshot subtracted from
    a later one gives what ran between them."""
    launches: collections.Counter
    values: collections.Counter


def counts() -> Counts:
    """The launch table as it stands."""
    return Counts(collections.Counter(_LAUNCHES),
                  collections.Counter(_VALUES))


def sources() -> tuple:
    """The name of every kernel source, `csrc/<name>.cu`: the KERNELS, the
    ports of the TPU kernels, and those that port none (the AdamW update,
    GroupNorm, calibrate.py's FMA probe, the spans' marks)."""
    return tuple(sorted(f.stem for f in CSRC.glob("*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one `nvcc` each,
    all started together.  Returns nvcc's output per kernel built (with
    `verbose`, ptxas's register and shared-memory report); raises if any
    build fails."""
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, errors = {}, []
    for name, tmp, out, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def kernel(name: str, entry: Optional[str] = None):
    """The C entry point `entry` (default `name`) of `csrc/<name>.cu`,
    built if needed."""
    entry = entry or name
    fn = _FUNCS.get(entry)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.restype = ctypes.c_int
        _FUNCS[entry] = fn
    return fn


def io_dtype(x, offset, mask=None) -> Optional[torch.dtype]:
    """The activations' type T that the kernels take as it is: float32 or
    bfloat16 where x, offset and mask (where given) all have it; None where
    they do not (float16, or mixed types), the route that upcasts them to
    float32 first.  The weight and bias do not enter the rule: each is
    float32 or bfloat16 on its own."""
    dtypes = {t.dtype for t in (x, offset, mask) if t is not None}
    return x.dtype if len(dtypes) == 1 and x.dtype in IO_CODES else None


def kernel_inputs(x, offset, mask, weight, bias):
    """The tensors a kernel path's autograd Function takes: x, offset and
    mask as they are (contiguous) where `io_dtype` gives their type, else
    upcast to float32; weight and bias as they are where float32 or
    bfloat16, else upcast.  The rule decides before any launch."""
    if io_dtype(x, offset, mask) is None:
        x, offset, mask = as_f32(x), as_f32(offset), as_f32(mask)
    else:
        x, offset = x.contiguous(), offset.contiguous()
        mask = None if mask is None else mask.contiguous()
    weight, bias = (None if t is None else t.contiguous()
                    if t.dtype in IO_CODES else as_f32(t)
                    for t in (weight, bias))
    return x, offset, mask, weight, bias


def widen(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t in at least float32 (bf16 and fp16 upcast, exactly; a no-op on
    float32 and float64): how the plain versions read a kernel's inputs."""
    return None if t is None else t.to(torch.promote_types(t.dtype,
                                                            torch.float32))


def cast_grads(grads, inputs):
    """Each gradient in its input's type (None stays None)."""
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, inputs))


def bias_grad(grad_out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """grad_out summed over every dim but the channels, with at least fp32
    accumulation, in the bias's type."""
    acc = torch.promote_types(grad_out.dtype, torch.float32)
    return grad_out.sum((0,) + tuple(range(2, grad_out.ndim)),
                        dtype=acc).to(dtype)


def check_inputs(name: str, x, offset, mask, weight, bias, spec,
                 out_sizes=None) -> None:
    """Raise unless the kernel can take these tensors as they are: of the
    kernel's rank (the `*3d_*` kernels 3D, the others 2D), x, offset and
    mask of one type in IO_CODES (float32 or bfloat16), weight and bias
    each float32 or bfloat16, contiguous, all on x's CUDA device, shapes per
    `spec` on the output grid `out_sizes` (None: derived from x).  The
    column kernels take no weight (None)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    ndim = 3 if "3d_" in name else 2
    if spec.ndim != ndim:
        raise NotImplementedError(f"{name}: takes {ndim}D configs, got "
                                  f"{spec.ndim}D")
    weight_shape = ((spec.groups, x.shape[1] // spec.groups) + spec.kernel
                    if weight is None else weight.shape)
    spec.validate(x.shape, offset.shape, weight_shape,
                  None if mask is None else mask.shape,
                  None if bias is None else bias.shape, out_sizes)
    for label, t in (("input", x), ("offset", offset), ("mask", mask),
                     ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, input on "
                             f"{x.device}")
        want = x.dtype if label in ("input", "offset", "mask") else None
        if t.dtype not in IO_CODES or want not in (None, t.dtype):
            raise TypeError(f"{name}: {label} must be "
                            f"{want or 'float32 or bfloat16'}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def out_grid(x, spec, out_sizes=None):
    """The output grid: `out_sizes` where given, else derived from x."""
    return (spec.out_sizes(x.shape[2:]) if out_sizes is None
            else tuple(int(o) for o in out_sizes))


def block_floats(spec, S, gate_bounds=None, block_origin=None):
    """The gather kernels' block-mode floats (csrc/deform_tile.cuh, Geo):
    the tap gate (lo, hi) per spatial dim, (-1, S_d) where `gate_bounds` is
    None, moved by the block's origin (the kernels compare it in the whole
    input's coordinates), then the block's placement (shift, origin) per
    dim, (0, 0) where `block_origin` is None.  Raises unless -1 <= lo < hi
    <= S_d on every dim: a tap then passes the gate only where its first
    kept corner (per dim max(floor(pos), 0)) lies in the block, which the
    column backward's owner tile relies on."""
    gate_bounds = gate_bounds or [(-1.0, float(s)) for s in S]
    block_origin = block_origin or [(0.0, 0.0)] * spec.ndim
    if len(gate_bounds) != spec.ndim or len(block_origin) != spec.ndim:
        raise ValueError(f"gate_bounds / block_origin need one pair per dim "
                         f"of a {spec.ndim}D op")
    out = []
    for d, ((lo, hi), s, (_, origin)) in enumerate(zip(gate_bounds, S,
                                                       block_origin)):
        lo, hi = float(lo), float(hi)
        if not -1.0 <= lo < hi <= s:
            raise ValueError(f"gate_bounds dim {d}: need -1 <= lo < hi <= "
                             f"{s}, got ({lo}, {hi})")
        out += [lo + origin, hi + origin]
    for shift, origin in block_origin:
        out += [float(shift), float(origin)]
    return tuple(out)


def check_grad_out(name: str, grad_out, x, shape) -> None:
    """Raise unless the backward's cotangent is of x's type, contiguous, of
    the output's shape and on x's device."""
    if (tuple(grad_out.shape) != tuple(shape) or grad_out.device != x.device
            or grad_out.dtype != x.dtype
            or not grad_out.is_contiguous()):
        raise ValueError(f"{name}: grad_out must be a contiguous {x.dtype} "
                         f"{tuple(shape)} tensor on {x.device}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device}")


def as_f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The kernels' input form: float32 and contiguous (a no-op if so)."""
    return None if t is None else t.to(torch.float32).contiguous()


def _f32_copy(view: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 copy of `view`, in one pass whatever its type."""
    return torch.empty(view.shape, dtype=torch.float32,
                       device=view.device).copy_(view)


def fwd_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(O, C/g, *k) -> (g, K, C/g, O/g): the forward kernels' weight layout,
    float32 (a bf16 weight widens in the same copy), each (tap, channel) row
    holding the group's output channels contiguously, the rows of one tap
    consecutive."""
    O, Cg = weight.shape[:2]
    return _f32_copy(weight.reshape(groups, O // groups, Cg, -1)
                     .permute(0, 3, 2, 1))


def tap_major_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(O, C/g, *k) -> (g, O/g, K, C/g): the backward kernels' weight
    layout, float32, each output channel's (tap, channel) rows tap-major."""
    O, Cg = weight.shape[:2]
    return _f32_copy(weight.reshape(groups, O // groups, Cg, -1)
                     .transpose(2, 3))


def ungrouped_weight(wt: torch.Tensor, weight_shape) -> torch.Tensor:
    """The backward kernels' grad_weight layout back to the weight's: (g,
    C/g*K, O/g), row c * K + k, -> (O, C/g, *k)."""
    return wt.transpose(1, 2).reshape(weight_shape)


def grad_weight_splits(spec, B: int, C: int, O: int, P: int) -> int:
    """How many splits of the (batch, position) axis the backward kernels
    sum grad_weight partials over (csrc/deform_bwd.cuh::launch_gw_mma):
    enough blocks to fill the card, at least 512 positions a split.  It
    depends on the shapes only, so the summation order does too."""
    rows = C // spec.groups * spec.tap_count
    Og = O // spec.groups
    blocks = -(-rows // 64) * -(-Og // 64) * spec.groups
    return max(1, min(-(-(B * P) // 512), 1024 // blocks))


def fwd_splits(spec, B: int, C: int, O: int, P: int) -> int:
    """How many parts the tensor-core forward kernels split their
    contraction into (csrc/deform_fwd.cuh): enough blocks of 64 positions
    x up to 256 output channels for two on each of the H100's 132 SMs, at
    least 4 stages of 32 (channel, tap) rows a part.  It depends on the
    shapes only, so the summation order does too."""
    Og = O // spec.groups
    tiles = 1 if Og <= 64 else 2 if Og <= 128 else 4
    blocks = -(-(B * P) // 64) * spec.groups * -(-Og // (64 * tiles))
    stages = spec.tap_count * -(-(C // spec.groups) // 32)
    return max(1, min(-(-264 // blocks), stages // 4))


def fwd_buffers(x, weight, spec, out):
    """Scratch of a tensor-core forward kernel, float32 whatever x's type:
    x channels-last (B, positions, C), the split parts (splits, *out.shape)
    or None, and the split count."""
    B, C = x.shape[:2]
    P = math.prod(out.shape[2:])
    splits = fwd_splits(spec, B, C, weight.shape[0], P)
    xt = torch.empty((B, math.prod(x.shape[2:]), C), dtype=torch.float32,
                     device=x.device)
    part = (torch.empty((splits,) + tuple(out.shape), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    return xt, part, splits


def bwd_buffers(x, offset, mask, weight, spec, P: int, needs,
                b_step: Optional[int] = None):
    """Outputs (None where not wanted) and scratch of a backward kernel:
    grad_x, grad_offset, grad_mask (each in its input's type), grad_weight
    in the kernels' weight layout, and the float32 scratch: the gcols
    buffer (b_step, K, P, C), x channels-last (B, positions, C) for the
    correlation and grad_weight, the grad_weight partials, and their split
    count.  b_step is the 3D kernels' batch
    chunk (None in 2D: the whole batch)."""
    want_x, want_off, want_mask, want_w = needs
    B, C = x.shape[:2]
    O, g, K = weight.shape[0], spec.groups, spec.tap_count
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                       device=x.device)
    splits = grad_weight_splits(spec, B, C, O, P)
    gx = torch.empty_like(x) if want_x else None
    goff = torch.empty_like(offset) if want_off else None
    gmask = torch.empty_like(mask) if want_mask and mask is not None else None
    gwt = empty(g, C // g * K, O // g) if want_w else None
    gcols = (empty(b_step or B, K, P, C) if gx is not None or goff is not None
             or gmask is not None else None)
    xt = (empty(B, math.prod(x.shape[2:]), C) if goff is not None
          or gmask is not None or gwt is not None else None)
    part = empty(splits, g, C // g * K, O // g) if want_w else None
    return gx, goff, gmask, gwt, gcols, xt, part, splits


def launch(name: str, x: torch.Tensor, tensors, ints, floats=(),
           entry: Optional[str] = None,
           values: Optional[int] = None) -> None:
    """Launch kernel `name` (its C entry `entry`, default `name`) on x's
    device and current stream: the C entry takes the tensors' pointers, the
    ints, the floats, then the stream.  Raise with the CUDA error if the
    launch was refused; else count it in the launch table under its C
    entry, with `values` (None: the caller counts none)."""
    fn = kernel(name, entry)
    # Every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer.
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, *ints, *floats, stream)
    entry = entry or name
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{err}")
    _LAUNCHES[entry] += 1
    if values is not None:
        _VALUES[entry] += values
