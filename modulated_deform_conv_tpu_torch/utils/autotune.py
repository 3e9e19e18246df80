"""Opt-in micro-autotune of the kernels' plan knobs: the counterpart of the
JAX package's utils/autotune.py.

`autotune(fn, key, variants)` times `fn` once per knob variant on the card,
pins the fastest as process-wide overrides and caches it per (device name,
key): in memory, and on disk in the JSON file named by MDC_AUTOTUNE_CACHE
where that is set.  Dispatch never times anything by itself: without a
call here the plans take their defaults.

A variant is timed as captured chains of fn (utils/graphs.py::time_chain,
the counterpart of the JAX package's chain-differenced mode,
`_time_differenced`): the device's time for a call, the host's dispatch
cost differenced away.  The knobs are read when a wrapper is called, so
each variant is captured afresh, as the JAX package builds a fresh jitted
chain per variant.

The knobs are those of the port's plans that leave every result's bits as
they are, so that results keep depending on shapes alone: the column
forward's route (`COLF_ROUTE`: "plane" or "gather", applied where the
shapes admit it; ops/cuda/gathermm.py::cols_fwd_plan) and its block target
(`COLF_BLOCKS`, blocks a launch aims at).  The contraction splits
(`lib.fwd_splits`, `lib.grad_weight_splits`) change summation orders and
are no knobs here.

    from modulated_deform_conv_tpu_torch.utils import autotune
    best = autotune.autotune(lambda: op(x, off, mask, w, b), key="c4 B=32")
    # e.g. {"COLF_BLOCKS": 528}, applied to later calls in this process

Overrides are process-global, as the JAX package's: alternating two tuned
shapes needs a call (cached: it only re-applies) or `reset()` between
them.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence

from . import graphs
from .device import device_name

logger = logging.getLogger("modulated_deform_conv_tpu_torch")

KNOBS = ("COLF_ROUTE", "COLF_BLOCKS")
# 0.5x-4x the default block target (the range swept by hand in PERF.md),
# and the other route.
DEFAULT_VARIANTS = ({}, {"COLF_BLOCKS": 528}, {"COLF_BLOCKS": 2112},
                    {"COLF_BLOCKS": 4224}, {"COLF_ROUTE": "gather"})

_CACHE: Dict[str, dict] = {}


def _cache_path() -> Optional[str]:
    return os.environ.get("MDC_AUTOTUNE_CACHE")


def _load_disk() -> Dict[str, dict]:
    path = _cache_path()
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_disk(cache: Dict[str, dict]) -> None:
    path = _cache_path()
    if path:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)


def current() -> dict:
    """The knobs now applied."""
    from ..ops.cuda import gathermm as gm
    return {"COLF_ROUTE": gm._COLF_ROUTE_OVERRIDE,
            "COLF_BLOCKS": gm._COLF_BLOCKS_OVERRIDE}


def apply(overrides: dict) -> None:
    """Set the knobs: those absent from `overrides` go back to the plan's
    defaults."""
    unknown = set(overrides) - set(KNOBS)
    if unknown:
        raise ValueError(f"unknown autotune knobs {sorted(unknown)}; "
                         f"known: {KNOBS}")
    from ..ops.cuda import gathermm as gm
    route = overrides.get("COLF_ROUTE")
    if route not in (None, "plane", "gather"):
        raise ValueError(f"COLF_ROUTE must be 'plane' or 'gather', got "
                         f"{route!r}")
    gm._COLF_ROUTE_OVERRIDE = route
    gm._COLF_BLOCKS_OVERRIDE = int(overrides.get("COLF_BLOCKS") or 0)


def autotune(fn: Callable[[], object], key: str,
             variants: Sequence[dict] = DEFAULT_VARIANTS,
             reps: int = graphs.SAMPLES, device=None,
             timer: Optional[Callable] = None) -> dict:
    """Pick the fastest knob variant for fn and pin it.

    `key` names the shapes tuned (the cache keys on the device name and
    key).  Each variant is a dict of KNOBS; `timer(fn) -> ms` times one
    variant (default: the median of `graphs.time_chain(fn, samples=reps)`,
    on the card; fn takes no arguments and closes over its CUDA
    tensors).  A variant that raises, its capture included, is skipped
    and its error kept in the RuntimeError raised, caching nothing, when
    every variant failed.  Raises ValueError with no variant to time.
    Returns the winner, left applied."""
    full_key = f"{device_name(device)}::{key}"
    cached = _CACHE.get(full_key) or _load_disk().get(full_key)
    if cached is not None:
        apply(cached)
        return dict(cached)
    variants = [dict(v) for v in variants]
    if not variants:
        raise ValueError("autotune: no variants to time")
    saved = current()
    try:
        for v in variants:
            apply(v)             # reject unknown knobs before timing any
    finally:
        apply({k: v for k, v in saved.items() if v})
    if timer is None:
        if device_name(device) in ("cpu", "meta"):
            raise RuntimeError("autotune times on a CUDA card; pass timer= "
                               "to time elsewhere")

        def timer(f):
            return graphs.time_chain(f, samples=reps)["ms"]
    best_t, best_v, failures = float("inf"), None, {}
    try:
        for v in variants:
            apply(v)
            try:
                t = timer(fn)
            except (RuntimeError, ValueError, NotImplementedError) as e:
                failures[json.dumps(v, sort_keys=True)] = repr(e)
                logger.info("autotune %s: variant %s failed: %r", key, v, e)
                continue
            if t < best_t:
                best_t, best_v = t, v
    finally:
        apply({k: v for k, v in saved.items() if v})
    if best_v is None:
        raise RuntimeError(f"autotune {key!r}: every variant failed: "
                           f"{failures}")
    _CACHE[full_key] = best_v
    disk = _load_disk()
    disk[full_key] = best_v
    _save_disk(disk)
    apply(best_v)
    return dict(best_v)


def reset() -> None:
    """Back to the plans' defaults, and forget the winners cached in memory
    (the disk cache stays)."""
    _CACHE.clear()
    apply({})
