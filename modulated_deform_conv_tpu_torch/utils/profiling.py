"""Tracing, timing, an analytic cost model and process-wide counters.

The port's counterpart of the JAX package's `utils/profiling.py` (which
imports jax, so nothing of it is imported here):

* `trace(logdir)`: a `torch.profiler` trace of the block, written as a
  Chrome trace file under `logdir`;
* `annotate(name)`: a named range in that trace (`record_function`) and,
  with a CUDA device, an NVTX range;
* `Timer(device)`: the elapsed time of a block, on CUDA events of the
  named CUDA device, or on the host clock for device="cpu" only;
* `op_stats`, `halo_stats` and `Counters` / `counters`: the sharding layer
  adds, per call, the analytic halo traffic and GEMM FLOPs of the global
  op; a harness divides them by the time it measures.  These are plain
  Python state, with no device traffic.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from typing import Dict, Iterator, Optional, Sequence

import torch

from .config import DeformConvSpec

logger = logging.getLogger("modulated_deform_conv_tpu_torch")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block with `torch.profiler` (CPU activity, and the
    CUDA devices' kernels where CUDA is available) and write the trace to
    `logdir/trace-<pid>-<n>.json` (Chrome trace format: Perfetto or
    chrome://tracing open it).  Yields the profiler, whose
    `key_averages()` the caller may read after the block; its `path`
    attribute holds the file written."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith("trace-")])
        prof.path = os.path.join(logdir, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(prof.path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: `torch.profiler.record_function` (seen by `trace`)
    and, where CUDA is available, an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Timer:
    """The elapsed time of a block on the named device, `elapsed_ms`.

    On a CUDA device, CUDA events are recorded on its current stream
    around the block and the exit synchronises on the end event, so the
    time is the device's time from the first to the last work queued in
    the block.  The host clock is used only for device="cpu", where the
    caller asked for it; a CUDA device that is not there raises."""

    def __init__(self, device, name: str = "timer"):
        self.device = torch.device(device)
        self.name = name
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"Timer({str(self.device)!r}): no CUDA "
                                   "device is visible")
        elif self.device.type != "cpu":
            raise ValueError(f"Timer: device 'cuda[:n]' or 'cpu', got "
                             f"{self.device}")
        self.elapsed_ms: Optional[float] = None
        self._start = self._end = None
        self._t0 = 0.0

    def __enter__(self):
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._end.record(torch.cuda.current_stream(self.device))
            self._end.synchronize()
            self.elapsed_ms = self._start.elapsed_time(self._end)
        else:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        logger.info("%s: %.4f ms on %s", self.name, self.elapsed_ms,
                    self.device)
        return False


def op_stats(spec: DeformConvSpec, x_shape: Sequence[int],
             out_channels: int, bytes_per_el: int = 4) -> Dict[str, float]:
    """Analytic cost model of one forward call.

    gemm_flops:    the grouped contraction,
    sample_flops:  the multilinear interpolation (2^nd corners, ~3 flops
                   per corner-weight product chain and accumulate),
    gather_bytes:  bytes moved by the offset-driven gather (2^nd corner
                   reads per tap per channel),
    col_bytes:     the materialized column traffic of the unfused path.
    """
    B, C = x_shape[0], x_shape[1]
    OS = spec.out_sizes(tuple(x_shape[2:]))
    P = math.prod(OS)
    K = spec.tap_count
    O = out_channels
    corners = 2 ** spec.ndim
    return {
        "gemm_flops": 2.0 * B * P * O * (C // spec.groups) * K,
        "sample_flops": float(B * P * K * C * corners * 3),
        "gather_bytes": float(B * P * K * C * corners * bytes_per_el),
        "col_bytes": float(B * P * K * C * bytes_per_el),
        "out_elems": float(B * P * O),
    }


class Counters:
    """Process-wide counters: named floats that calls add to."""

    def __init__(self):
        self._c: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        self._c[name] = self._c.get(name, 0.0) + float(value)
        logger.debug("counter %s += %s", name, value)

    def get(self, name: str, default: float = 0.0) -> float:
        return self._c.get(name, default)

    def snapshot(self) -> Dict[str, float]:
        return dict(self._c)

    def reset(self) -> None:
        self._c.clear()


counters = Counters()


def halo_stats(spec: DeformConvSpec, x_shape: Sequence[int], halo: int,
               n_spatial_shards: int, bytes_per_el: int = 4,
               dim: int = 0) -> Dict[str, float]:
    """Analytic halo-exchange traffic of one sharded forward call.

    Each interior spatial shard sends `halo` rows up and down along
    spatial dim `dim` (2 payloads of halo * prod(other spatial dims) * C
    elements); edge shards send one.  The backward sends the same payloads
    back, doubling the traffic of a training step.  For a 2-axis spatial
    mesh call this once per sharded dim (the second exchange's payload
    grows by the first dim's halo rows; pass the extended shape for an
    exact figure).
    """
    C = x_shape[1]
    spatial = list(x_shape[2:])
    rest = math.prod(spatial[:dim] + spatial[dim + 1:]) if spatial else 1
    row_bytes = C * rest * bytes_per_el * x_shape[0]
    sends = 2 * (n_spatial_shards - 1)            # up + down ring edges
    payload = halo * row_bytes
    return {
        "halo_rows": float(halo),
        "halo_bytes_fwd": float(sends * payload),
        "halo_bytes_fwdbwd": float(2 * sends * payload),
        "ppermute_calls_fwd": float(2 if halo and n_spatial_shards > 1
                                    else 0),
    }
