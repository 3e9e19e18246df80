"""Analytic cost model and process-wide counters.

The part of the JAX package's `utils/profiling.py` that the sharding layer
calls (`op_stats`, `Counters` / `counters`, `halo_stats`), copied: that
module imports jax.  The sharding layer adds, per call, the analytic halo
traffic and GEMM FLOPs of the global op; a harness divides them by the
time it measures.  Everything is plain Python state, with no device
traffic.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, Sequence

from .config import DeformConvSpec

logger = logging.getLogger("modulated_deform_conv_tpu_torch")


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
