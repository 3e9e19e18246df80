"""The JAX package's gathermm plan decisions, as shape predicates.

Two of the JAX package's dispatch choices follow from the tiling plan its
Pallas gathermm kernels build (`ops/pallas/gathermm.py::_Plan`, :108-313):
whether a 3D config takes the planar mode (which `_prefer_shiftblend`
reads), and whether the fused pair or the columns path runs (`_fuse_ok`,
:1112-1123).  The port computes neither plan for its own kernels, so it
copies the parts of the plan that those two decisions read, to take the
same kernel as the JAX package on the same shapes:

* the output tile PT, the tap split K0 x KI (KP = KI * PT lanes) and the
  input chunk SCH / padded plane SPAD, in flat mode and in 3D planar mode;
* the channel-part split NCP (CgP = C/dg / NCP channels a part) and the
  streaming veto that drops planar mode;
* the factor-row count NR.

The budgets are the JAX package's v5e profile (utils/device.py:75-122),
measured on v5e, not on the H100: the port's profile (utils/device.py)
carries them as copies, read from the profile of x's device (the reference
profile on CPU and meta tensors).  They decide which kernel runs, not how
the port's kernels tile.  `fuse_ok` is the port's fused-or-columns rule:
`jax_fuse_ok` and the profile's cap on output channels a conv group.
"""
from __future__ import annotations

import math
from typing import NamedTuple

from ...utils.config import DeformConvSpec
from ...utils.device import DeviceProfile, current_profile

# The profile's v5e budgets: `lane_budget`, K * P_tile lanes a tap group
# may use; `a_chunk_bytes`, one f32 A-chunk (SCH x KP) in VMEM, twice that
# in planar mode; `x_plane_bytes`, one (plane, channels) input slab resident
# in VMEM; `fused_footprint_bytes`, the most VMEM the fused backward's
# blocks and scratch may take (`_fuse_ok`).


class Plan(NamedTuple):
    PT: int       # output positions per tile
    K0: int       # tap groups
    KI: int       # taps per group
    KP: int       # KI * PT
    SCH: int      # input chunk (flat positions)
    SPAD: int     # input plane padded to whole chunks
    NR: int       # factor rows per tap group
    NCP: int      # channel parts of a deformable group
    CgP: int      # channels per part
    planar: bool  # 3D planar mode


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _flat_tiling(spec: DeformConvSpec, S, OS, prof: DeviceProfile):
    """(PT, K0, KI, SCH, SPAD) of the flat mode (gathermm.py:130-206)."""
    K, P, run = spec.tap_count, math.prod(OS), OS[-1]
    pmax = _ceil8(P)
    cands = set()
    for tgt in (512, 384, 256, 128):
        cands.add(min(tgt, pmax))
        if run <= tgt:
            cands.add(min(max(tgt // run, 1) * run, pmax))
    halo = (spec.kernel[0] - 1) * spec.dilation[0] + 1 + 4
    best = None
    for pt in sorted(cands):
        pt = _ceil8(pt)
        for k0 in _divisors(K):                 # the smallest k0 that fits
            ki = K // k0
            if ki * pt > prof.lane_budget:
                continue
            lanes = -(-ki * pt // 128) * 128
            rows = pt / run + (0 if pt % run == 0 else 1)
            cost = (lanes * (rows + halo) + 8192.0) / pt
            if best is None or cost < best[0]:
                best = (cost, k0, ki, pt)
            break
    _, k0, ki, pt = best
    kp = ki * pt
    in_row = math.prod(S[1:])
    window = int(((pt / run) * spec.stride[0] + 1 + halo) * in_row)
    sch = max(8, min(int(window / 6), prof.a_chunk_bytes // (kp * 4)) // 8 * 8)
    unit = math.lcm(S[-1], 8)
    if unit <= 2 * sch or (unit * kp * 4 <= prof.a_chunk_bytes
                           and unit <= 2 * window):
        sch = max(unit, sch // unit * unit)
    sflat = math.prod(S)
    sch = min(sch, _ceil8(sflat))
    return pt, k0, ki, sch, -(-sflat // sch) * sch


def _planar_tiling(spec: DeformConvSpec, S, OS, prof: DeviceProfile):
    """(PT, K0, KI, SCH, SPAD) of the 3D planar mode, or None where it does
    not apply (gathermm.py:237-279): an in-plane chunk dividing the plane
    near plane/8, output tiles of whole rows near 256 positions, tap groups
    within the lane budget and the chunk within twice the A-chunk."""
    plane, run = S[1] * S[2], OS[2]
    cands = [d for d in range(8, plane + 1, 8) if plane % d == 0]
    if not cands or plane < 2 * min(cands):
        return None
    tgt = max(128, plane // 8)
    sch = min(cands, key=lambda d: abs(d - tgt))
    rows = min(_divisors(OS[1]), key=lambda r: abs(r * run - 256))
    pt = rows * run
    pt8 = _ceil8(pt)
    ki = max((d for d in _divisors(spec.tap_count // spec.kernel[0])
              if d * pt8 <= prof.lane_budget), default=1)
    if pt8 != pt or ki * pt * sch * 4 > 2 * prof.a_chunk_bytes:
        return None
    return pt, spec.tap_count // ki, ki, sch, math.prod(S)


def jax_plan(x, spec: DeformConvSpec, out_sizes=None,
             profile: DeviceProfile = None) -> Plan:
    """The JAX package's `_Plan` fields that its dispatch reads, for input
    x (any tensor with x.shape) under spec, on the output grid `out_sizes`
    (None: derived from x, as the JAX package's `_plan_for`), with the
    budgets of `profile` (None: the profile of x's device)."""
    prof = profile or current_profile(x)
    S = tuple(x.shape[2:])
    OS = (spec.out_sizes(S) if out_sizes is None
          else tuple(int(o) for o in out_sizes))
    cg = x.shape[1] // spec.deformable_groups
    flat = _flat_tiling(spec, S, OS, prof)
    tiling = ((_planar_tiling(spec, S, OS, prof) if spec.ndim == 3
               else None) or flat)
    spad = tiling[4]
    # The channel-part split: halve the parts while the (plane, channels)
    # slab is over the budget; past it even so, the plane is streamed,
    # which takes one part and drops planar mode.
    ncp = 1
    while (spad * (cg // ncp) * 4 > prof.x_plane_bytes and cg % (ncp * 2) == 0
           and cg // (ncp * 2) >= 8):
        ncp *= 2
    if spad * (cg // ncp) * 4 > prof.x_plane_bytes:
        ncp, tiling = 1, flat
    pt, k0, ki, sch, spad = tiling
    return Plan(pt, k0, ki, ki * pt, sch, spad, 8 if spec.ndim == 2 else 16,
                ncp, cg // ncp, tiling is not flat)


def jax_planar(x, spec: DeformConvSpec,
               profile: DeviceProfile = None) -> bool:
    """Would the JAX package's gathermm plan take its 3D planar mode here?"""
    return spec.ndim == 3 and jax_plan(x, spec, None, profile).planar


def jax_fuse_ok(x, spec: DeformConvSpec, O: int, out_sizes=None,
                profile: DeviceProfile = None) -> bool:
    """Would the JAX package run its fused gathermm pair here (`_fuse_ok`),
    rather than the columns kernels and a separate GEMM?  False where a
    channel part straddles conv groups, or where the fused backward's
    blocks (double-buffered) and scratch would pass 80 MB of VMEM.
    `out_sizes`: the output grid (a sharded block's), None to derive it;
    `profile`: whose budgets (None: the profile of x's device)."""
    prof = profile or current_profile(x)
    p = jax_plan(x, spec, out_sizes, prof)
    if (x.shape[1] // spec.groups) % p.CgP:
        return False
    og = O // spec.groups
    blocks = 2 * 4 * (p.SPAD * p.CgP + p.K0 * p.NR * p.KP
                      + p.K0 * og * p.KI * p.CgP + og * p.PT)
    scratch = 4 * (2 * p.CgP * p.KP + p.KI * p.CgP * p.PT + og * p.PT
                   + p.NR * p.KP)
    return blocks + scratch <= prof.fused_footprint_bytes


def fuse_ok(x, spec: DeformConvSpec, O: int, out_sizes=None,
            profile: DeviceProfile = None) -> bool:
    """The fused gather pair (True) or the columns path (False): the JAX
    package's `_fuse_ok` (`jax_fuse_ok`), and the profile's cap, the
    columns path where the product's multiply-adds B*P * O * C/groups * K
    reach `cols_min_macs` (`cols_min_macs_3d` in 3D).  Shapes alone decide
    it.  Under the reference profile (no cap) this is `jax_fuse_ok`."""
    prof = profile or current_profile(x)
    OS = (spec.out_sizes(tuple(x.shape[2:])) if out_sizes is None
          else tuple(out_sizes))
    macs = (x.shape[0] * math.prod(OS) * O * (x.shape[1] // spec.groups)
            * spec.tap_count)
    if prof.prefers_columns(macs, spec.ndim):
        return False
    return jax_fuse_ok(x, spec, O, out_sizes, prof)
