"""`debug_check_bounds`: the opt-in guard of the bounded-offset contract.

Eager, the check is read on the host (a synchronisation with the device)
and a violation warns.  Inside a CUDA graph capture nothing may be read on
the host, so the check stays on the device, as JAX's `jax.lax.cond` and
`jax.debug.print` keep it inside a jitted step: it is recorded into the
`BoundsRecord` that the capturing step owns (utils/graphs.py's `capture`
opens it with `recording`), and the step warns when it reads its loss.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional

import torch


def bounds_message(max_abs: float, offset_bound) -> str:
    """The warning of a violated bounded-offset contract, eager or
    captured."""
    return ("modulated_deform_conv_tpu_torch: max |offset| = "
            f"{max_abs} exceeds the declared offset_bound = {offset_bound}; "
            "out-of-bound tap contributions are dropped (bounded-offset "
            "contract)")


class BoundsRecord:
    """The checks of one captured step: per check a device pair (within
    bound as 0 / 1, max |offset|) and its declared bound.  `read_with(t)`
    copies the flags to the host in one transfer with t, and warns for
    every check that failed."""

    def __init__(self):
        self.bounds: List[object] = []
        self.flags: Optional[torch.Tensor] = None
        self._pairs: List[torch.Tensor] = []

    def record(self, ok: torch.Tensor, max_abs: torch.Tensor,
               offset_bound) -> None:
        """Add one check: `ok` and `max_abs` are 0-dim device tensors; no
        host read."""
        self._pairs.append(torch.stack([ok.to(torch.float32),
                                        max_abs.to(torch.float32)]))
        self.bounds.append(offset_bound)

    def seal(self) -> None:
        """Gather the checks into one (n, 2) tensor (inside the capture, so
        each replay rewrites it)."""
        if self._pairs:
            self.flags = torch.stack(self._pairs)
        self._pairs = []

    def read_with(self, t: torch.Tensor, stacklevel: int = 2) -> float:
        """t's value (one element) as a Python float, read in the same
        device-to-host copy as the flags; warn for each failed check."""
        if self.flags is None:
            return float(t)
        host = torch.cat([t.detach().reshape(1).double(),
                          self.flags.reshape(-1).double()]).cpu()
        for (ok, max_abs), bound in zip(host[1:].reshape(-1, 2).tolist(),
                                        self.bounds):
            if not ok:
                warnings.warn(bounds_message(max_abs, bound),
                              stacklevel=stacklevel + 1)
        return float(host[0])


_ACTIVE: List[BoundsRecord] = []


def capturing(t: torch.Tensor) -> bool:
    """Is t a CUDA tensor while its current stream records a graph?"""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def recording(record: BoundsRecord):
    """Checks made inside the block under a capture go to `record`."""
    _ACTIVE.append(record)
    try:
        yield record
    finally:
        _ACTIVE.pop()


def record_bounds(ok: torch.Tensor, max_abs: torch.Tensor,
                  offset_bound) -> None:
    """Record a check made inside a capture into the innermost `recording`
    block's record; raises outside one (no record owns the flags)."""
    if not _ACTIVE:
        raise RuntimeError(
            "debug_check_bounds inside a CUDA graph capture needs the "
            "capture of utils.graphs.capture, whose step owns the flags; "
            "a bare torch.cuda.graph cannot read them")
    _ACTIVE[-1].record(ok, max_abs, offset_bound)


def check(offset: torch.Tensor, offset_bound, stacklevel: int) -> None:
    """The op's check of |offset| <= offset_bound: warn now (eager, reading
    the check on the host) or record it on the device (under a capture)."""
    from .cuda.shiftblend import offsets_within_bound
    ok = offsets_within_bound(offset, offset_bound)
    if capturing(offset):
        record_bounds(ok, offset.detach().abs().max(), offset_bound)
    elif not bool(ok):
        warnings.warn(bounds_message(float(offset.abs().max()),
                                     offset_bound),
                      stacklevel=stacklevel + 1)
