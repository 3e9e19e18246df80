"""Per-device dispatch constants: the counterpart of the JAX package's
utils/device.py.

The port's dispatch ("auto") chooses between kernel pairs by rules whose
constants depend on the card: the shift-blend / gathermm crossover, the 3D
wide-bound rule, the sharded lead-mode rule and the fused-pair-or-columns
rule.  `DeviceProfile` holds them, keyed on the CUDA device's name
(`torch.cuda.get_device_name`).  A built-in table holds two entries:

* the reference profile, the JAX package's v5e values exactly (its
  dispatch on CPU tensors, as JAX's `current_profile` returns v5e off the
  TPU, so the port and the JAX package pick the same pair there);
* an H100 entry, matched by substring of the device name, whose values
  `python -m modulated_deform_conv_tpu_torch.calibrate` measured.

An unknown CUDA name resolves to the reference profile, and says so once
through `logging`.  The four byte / lane budgets are copies of the JAX
package's v5e plan budgets (TPU VMEM): they decide which kernel the copied
JAX predicates pick (ops/cuda/plan.py), not how the port's kernels tile.

Precedence, as the JAX package's: an env var wins over the entry of the
`MDC_PROFILE` JSON file (written by calibrate, keyed by device name), which
wins over the table.

Env overrides:
  MDC_SB_CROSSOVER       shift-blend when C/dg <= this (the JAX name)
  MDC_LANE_BUDGET        the copied gathermm plan's lane budget (the JAX name)
  MDC_PROFILE            path of a calibrate JSON file (the JAX name)
  MDC_SB_WIDE_BOUND_3D   3D: planar gathermm at bounds >= this ("inf": never)
  MDC_SB_LEAD_CROSSOVER  sharded lead mode when C/dg <= this
  MDC_COLS_MIN_MACS      2D: the columns path where the product's multiply-
                         adds B*P * O * C/groups * K are at least this, the
                         fused gather pair below ("none": never)
  MDC_COLS_MIN_MACS_3D   the same in 3D
The JAX package's MDC_VMEM_BYTES has no counterpart: the card has no VMEM.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import math
import os
from typing import Optional

logger = logging.getLogger("modulated_deform_conv_tpu_torch")

_MB = 1024 * 1024

# The JAX package's device kind on its measured chip: the reference
# profile's name, and its key in an MDC_PROFILE file.
REFERENCE_KIND = "TPU v5 lite"


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Resolved dispatch constants for one device."""
    kind: str
    sb_crossover_cg: int          # shift-blend when C/dg <= this
    sb_wide_bound_3d: float       # 3D: planar gathermm at bounds >= this
    sb_lead_crossover_cg: int     # sharded lead mode when C/dg <= this
    cols_min_macs: Optional[int]  # 2D: columns from this many multiply-adds
    cols_min_macs_3d: Optional[int]   # 3D: the same
    lane_budget: int              # v5e copy: gathermm K * P_tile lanes
    a_chunk_bytes: int            # v5e copy: one f32 A-chunk of VMEM
    x_plane_bytes: int            # v5e copy: one resident input slab
    fused_footprint_bytes: int    # v5e copy: the fused backward's VMEM

    def prefers_columns(self, macs: int, ndim: int = 2) -> bool:
        """The profile's cap on the fused gather pair: the columns path for
        an `ndim`-D product of `macs` multiply-adds (B*P * O * C/groups *
        K)."""
        t = self.cols_min_macs_3d if ndim == 3 else self.cols_min_macs
        return t is not None and macs >= t


# The JAX package's v5e values (its utils/device.py at 128 MB of VMEM, the
# crossover in ops/pallas/__init__.py, the 3D bound 1.5 of
# `_prefer_shiftblend`, the lead rule C/dg <= 128 of parallel/sharding.py,
# `_fuse_ok`'s 80 MB footprint).
REFERENCE = dict(sb_crossover_cg=128, sb_wide_bound_3d=1.5,
                 sb_lead_crossover_cg=128, cols_min_macs=None,
                 cols_min_macs_3d=None,
                 lane_budget=4608, a_chunk_bytes=2 * _MB,
                 x_plane_bytes=40 * _MB, fused_footprint_bytes=80 * _MB)

# Measured entries, matched by lowercase substring of the device name,
# first hit wins; fields not given keep the reference value.
_TABLE = (
    ("h100", dict(
        # NVIDIA H100 80GB HBM3, 700.00 W, "tensorfloat32": `calibrate
        # --repeat 3`, the full sweep three times on captured,
        # chain-differenced steps (utils/graphs.py::time_chain), derived
        # over all its points (calibrate_h100.json and .log, committed
        # with the records; PERF.md, section 6).  Shift-blend's step is 5-8% ahead of the
        # fused gather pair's at every C/dg of 8-256 (spreads <= 0.02).
        sb_crossover_cg=256,
        # The 3D shift-blend pair is 12-14% ahead at bounds 0.5-2.0; at 2.5
        # the 3D gather pair is 0.7-2.0% ahead (decisive in one run of
        # three, a tie in the other two; spreads <= 0.02).
        sb_wide_bound_3d=2.5,
        # The gather kernels' block mode, on the pair the fuse rules below
        # pick for the shard, is ahead of the lead mode at every point:
        # 1.24-2.09x at cfg2-H4 (C/dg 32-256, the columns path), 1.02x at
        # cfg3-D4's C/dg 32 (the fused 3D pair) and 1.67-3.0x at 64-256
        # (the 3D columns path).  So the lead mode is never taken.
        sb_lead_crossover_cg=0,
        # 2D: the columns path is ahead at every point: DCNResNet-50's
        # layers (9.2e8 multiply-adds, the least) 1.41-2.09x, config 2's
        # shape 1.33x (groups 4) and 2.45-2.47x (groups 1), c3's shape
        # 1.84-3.99x at B=2-32 and 128-512 channels, config 5 3.7-7.2x
        # (spreads <= 0.064).
        cols_min_macs=924844032,
        # 3D: the columns path is ahead at every point, 1.18-2.36x, from
        # config 3's shape at B=1 and 32 channels (4.5e8, the least) to
        # DCNVideoNet's layers (4.4e10).
        cols_min_macs_3d=452984832,
    )),
)

_ENV = {"sb_crossover_cg": "MDC_SB_CROSSOVER",
        "lane_budget": "MDC_LANE_BUDGET",
        "sb_wide_bound_3d": "MDC_SB_WIDE_BOUND_3D",
        "sb_lead_crossover_cg": "MDC_SB_LEAD_CROSSOVER",
        "cols_min_macs": "MDC_COLS_MIN_MACS",
        "cols_min_macs_3d": "MDC_COLS_MIN_MACS_3D"}
_FIELDS = tuple(REFERENCE)


def _parse(field: str, value):
    """A field's value from JSON or an env string."""
    if field == "sb_wide_bound_3d":
        return math.inf if value is None or str(value).lower() in (
            "inf", "infinity", "none") else float(value)
    if field in ("cols_min_macs", "cols_min_macs_3d"):
        return None if value is None or str(value).lower() in (
            "none", "inf", "") else int(value)
    return int(value)


def table_entry(kind: str) -> Optional[dict]:
    """The built-in table's measured values for `kind`, or None."""
    norm = kind.lower()
    for sub, values in _TABLE:
        if sub in norm:
            return dict(values)
    return None


def _load_profile_file(kind: str) -> dict:
    """The MDC_PROFILE file's entry for `kind` ({} without one)."""
    path = os.environ.get("MDC_PROFILE")
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        return dict(json.load(f).get(kind, {}))


@functools.lru_cache(maxsize=None)
def _profile_for_kind(kind: str) -> DeviceProfile:
    values = dict(REFERENCE)
    if kind != REFERENCE_KIND:
        entry = table_entry(kind)
        if entry is None:
            logger.warning("modulated_deform_conv_tpu_torch: no measured "
                           "dispatch profile for %r; using the reference "
                           "(v5e) profile", kind)
        else:
            values.update(entry)
    filed = _load_profile_file(kind)
    for field in _FIELDS:
        if field in filed:
            values[field] = _parse(field, filed[field])
        env = os.environ.get(_ENV.get(field, ""))
        if env:
            values[field] = _parse(field, env)
    return DeviceProfile(kind=kind, **values)


def clear_cache() -> None:
    """Forget resolved profiles (after changing the env or the file)."""
    _profile_for_kind.cache_clear()


def device_name(device_or_kind=None) -> str:
    """A CUDA tensor's or device's card name (None: the current CUDA
    device where there is one), the device type of another tensor or
    device ("cpu", "meta"), or the string given."""
    if isinstance(device_or_kind, str):
        if device_or_kind.split(":")[0] not in ("cuda", "cpu", "meta"):
            return device_or_kind
    import torch
    if device_or_kind is None:
        if not torch.cuda.is_available():
            return "cpu"
        device_or_kind = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(getattr(device_or_kind, "device", device_or_kind))
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def device_kind(device_or_kind=None) -> str:
    """The name a profile is keyed on: `device_name`, with REFERENCE_KIND
    for a CPU or meta tensor or device."""
    name = device_name(device_or_kind)
    return REFERENCE_KIND if name in ("cpu", "meta") else name


def current_profile(device_or_kind=None) -> DeviceProfile:
    """Dispatch constants for a tensor's device, a device, or a named kind
    (None: the current CUDA device, or the reference profile without
    one)."""
    return _profile_for_kind(device_kind(device_or_kind))


def reference_profile() -> DeviceProfile:
    """The JAX package's v5e profile (with the env and file overrides)."""
    return _profile_for_kind(REFERENCE_KIND)
