"""Measure a CUDA card and derive its dispatch profile: the counterpart of
the JAX package's calibrate.py.

    python -m modulated_deform_conv_tpu_torch.calibrate [--out PATH] [--quick]
        [--repeat N]

It runs on the card, and raises without one.  Every time is a captured,
chain-differenced one (utils/graphs.py::time_chain, the counterpart of
the JAX package's `_chain` / `_amortized`): a chain of `graphs.N_LO` and
one of `graphs.N_HI` calls of the step, each captured as a CUDA graph,
replayed in turns `graphs.SAMPLES` times between CUDA events; a sample is
the difference over the extra calls, so the host's dispatch cost cancels
and the time is the device's.  A time's run-to-run spread is the range
of its samples without the highest and the lowest, over their median.
A step that cannot be captured raises: nothing is timed eagerly.

The raw rates ride along in the JSON (`"measured"`), as the JAX package's
do: the TF32 and bf16 tensor-core matmul rates (`torch.matmul` on 8192 x
8192), the HBM bandwidth (an elementwise kernel over 1 GiB: every byte
read and written once), and the FP32 FMA rate (csrc/calibrate_fma.cu:
eager PyTorch cannot reach it, each elementwise op being bound by memory).

The dispatch constants come from timing the two candidate pairs of each
rule on the same inputs: the training step, forward plus backward of
sum(out^2) in every input, through the kernel wrappers, each pair forced.
The JAX package scaled its v5e crossover by a matmul / vector-unit rate
ratio, which means nothing for the port's kernels.

* `sb_crossover_cg`: BASELINE config 2's shape (B=8, 256 channels, 56x56,
  3x3, bound 2) at deformable_groups 32 down to 1 (C/dg 8-256), and once
  at 512 channels (C/dg 128); shift-blend pair against the fused gather
  pair.  The largest C/dg where shift-blend is no slower.
* `sb_wide_bound_3d`: config 3's shape (B=2, 64 channels, 16x32x32,
  3x3x3) at bounds 0.5-2.5, the 3D shift-blend pair against the 3D gather
  pair.  The least bound from which gathermm wins (inf: never).
* `cols_min_macs` (2D) and `cols_min_macs_3d`: config 5's c3 / c4 / c5
  (B=32), c3's shape at B=2-16 and at 128 and 256 channels, DCNResNet-50's
  six DCN layer shapes (width 64, B=8, 224x224) and config 2's shape
  unbounded (groups 4 and 1); config 3's shape unbounded, at B=1 and at 32
  channels, and DCNVideoNet's two DCN layers: the fused pair against the
  column kernels and the grouped GEMM.  The columns path where the
  product's multiply-adds B*P * O * C/groups * K reach it (where the JAX
  package's `_fuse_ok` holds; the fused pair below it); None: never.
* `sb_lead_crossover_cg`: the interior shard of config 2 split 4 ways on H
  (C=256, dg 8-1) and of config 3 split 4 ways on D (dg=1, C 32-256),
  max_offset 2, shift-blend's lead mode against the gather kernels' block
  mode: C/dg 32-256.

`derive` turns the timing table into the profile with the tie rule: a
value moves off its base (the reference profile's; with --quick, the
committed one) only where the other candidate wins by more than the
run-to-run spread.  --quick times one point either side of each reference
value (where the card's values part from the JAX package's), for
chip_smoke.py, and reports any committed value the points contradict.
The JSON is keyed by device name and written by temp file and rename,
with the timing mode and the chain lengths; utils/device.py reads it under
MDC_PROFILE=PATH.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .utils import graphs
from .utils.config import DeformConvSpec
from .utils.device import (REFERENCE, REFERENCE_KIND, DeviceProfile,
                           current_profile, device_kind)

PRECISION = "tensorfloat32"

CG_POINTS = (8, 16, 32, 64, 128, 256)        # C/dg at config 2's width
WIDE_CG = 128                                # the 512-channel point's C/dg
BOUND_POINTS = (0.5, 1.0, 1.5, 2.0, 2.5)
LEAD_CG_POINTS = (32, 64, 128, 256)
LEAD_MAX_OFFSET = 2.0
# name -> (B, C, S, stride, groups), 3x3 or 3x3x3, O = C, dg = 1: config 5
# (benchmarks/suite.py:64-70), c3's shape at smaller batches and widths,
# the DCN 3x3 layers of DCNResNet-50 at width 64, B=8, 224x224 (the first
# block of c3-c5 at stride 2), config 2's shape without a bound (groups 4,
# and 1), config 3's shape without a bound, and DCNVideoNet's two DCN layers
# (width 32, B=8, 16x112x112).
FUSE_SHAPES = {
    "cfg5-c3": (32, 512, (28, 28), 1, 1),
    "cfg5-c4": (32, 1024, (14, 14), 1, 1),
    "cfg5-c5": (32, 2048, (7, 7), 1, 1),
    "c3-b2": (2, 512, (28, 28), 1, 1), "c3-b4": (4, 512, (28, 28), 1, 1),
    "c3-b8": (8, 512, (28, 28), 1, 1), "c3-b16": (16, 512, (28, 28), 1, 1),
    "c3-w128": (32, 128, (28, 28), 1, 1),
    "c3-w256": (32, 256, (28, 28), 1, 1),
    "r50-c3-s2": (8, 128, (56, 56), 2, 1), "r50-c3": (8, 128, (28, 28), 1, 1),
    "r50-c4-s2": (8, 256, (28, 28), 2, 1), "r50-c4": (8, 256, (14, 14), 1, 1),
    "r50-c5-s2": (8, 512, (14, 14), 2, 1), "r50-c5": (8, 512, (7, 7), 1, 1),
    "cfg2-g4": (8, 256, (56, 56), 1, 4), "cfg2-g1": (8, 256, (56, 56), 1, 1),
    "cfg3": (2, 64, (16, 32, 32), 1, 1),
    "cfg3-b1": (1, 64, (16, 32, 32), 1, 1),
    "cfg3-w32": (2, 32, (16, 32, 32), 1, 1),
    "cfg3-w32-b1": (1, 32, (16, 32, 32), 1, 1),
    "video-s1": (8, 64, (16, 56, 56), 1, 1),
    "video-s2": (8, 128, (16, 28, 28), 1, 1),
}
DISPATCH_FIELDS = ("sb_crossover_cg", "sb_wide_bound_3d",
                   "sb_lead_crossover_cg", "cols_min_macs", "cols_min_macs_3d")


# ---- timing -----------------------------------------------------------------


# How every time here is taken, recorded in the result and the JSON.
TIMING = {"mode": "chain", "n_lo": graphs.N_LO, "n_hi": graphs.N_HI,
          "samples": graphs.SAMPLES}


def _step(fn, leaves):
    """(step, live): a training step of fn, grads of sum(out^2) in every
    leaf that is a tensor, taking those leaves (`live`) as its inputs;
    the leaves that are None (no mask, no bias) are closed over, since a
    capture takes tensors only."""
    live = [t for t in leaves if t is not None]

    def step(*ins):
        it = iter(ins)
        out = fn(*[None if t is None else next(it) for t in leaves])
        return torch.autograd.grad((out * out).sum(), ins)
    step.__name__ = getattr(fn, "__name__", "step")
    return step, live


# ---- raw rates --------------------------------------------------------------


def measure_matmul(device, dtype, n: int = 8192) -> float:
    """Tensor-core matmul rate (FLOP/s) of an n x n product: "float32"
    operands with TF32 allowed, or bf16."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), device=device, generator=g).to(dtype)
    b = torch.randn((n, n), device=device, generator=g).to(dtype)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ms = graphs.time_chain(lambda: torch.matmul(a, b))["ms"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return 2 * n ** 3 / (ms * 1e-3)


def measure_hbm_copy(device, nbytes: int = 1 << 30) -> float:
    """HBM bandwidth (bytes/s) of an elementwise kernel over `nbytes`,
    each byte read once and written once (the JAX package's
    `x * 1.0000001`).  Not `copy_`: captured, it is a memcpy node, which
    does not run as an SM kernel and reads a lower rate."""
    src = torch.ones(nbytes // 4, device=device)
    dst = torch.empty_like(src)
    ms = graphs.time_chain(lambda: torch.mul(src, 1.0000001, out=dst))["ms"]
    return 2 * nbytes / (ms * 1e-3)


def measure_fma(device, iters: int = 1 << 14) -> float:
    """FP32 FMA rate (FLOP/s) of csrc/calibrate_fma.cu: 8 chains a thread,
    256 threads a block, 8 blocks an SM."""
    from .ops.cuda import lib
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * 256, device=device)

    def fma():
        lib.launch("calibrate_fma", out, (out,), (blocks, iters))
        return out
    ms = graphs.time_chain(fma)["ms"]
    torch.cuda.synchronize(device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("calibrate_fma: non-finite chains")
    return 2 * 8 * iters * blocks * 256 / (ms * 1e-3)


# ---- the sweeps -------------------------------------------------------------


def _macs(B, C, S, stride, groups) -> int:
    """Multiply-adds of a FUSE_SHAPES layer's product: B*P * O * C/g * K."""
    return (B * math.prod(-(-s // stride) for s in S) * C * C // groups
            * 3 ** len(S))


def _inputs(device, B, C, S, k, stride, groups, dg, bound, O=None,
            modulated=True, bias=True, seed=0):
    """(spec, [x, offset, mask, weight, bias]) from numpy `seed`, offsets
    U[-bound, bound], as leaves that take gradients."""
    nd = len(S)
    spec = DeformConvSpec.make(nd, k, stride, k // 2, 1, groups, dg,
                               modulated=modulated)
    O = O or C
    OS = spec.out_sizes(S)
    K = spec.tap_count
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = [rng.standard_normal((B, C) + S, dtype=f32),
            rng.uniform(-bound, bound, (B, dg * nd * K) + OS).astype(f32),
            rng.uniform(0, 1, (B, dg * K) + OS).astype(f32)
            if modulated else None,
            rng.standard_normal((O, C // groups) + (k,) * nd, dtype=f32)
            * f32(0.05),
            rng.standard_normal((O,), dtype=f32) * f32(0.1) if bias else None]
    return spec, [None if a is None else
                  torch.from_numpy(a).to(device).requires_grad_(True)
                  for a in arrs]


def _pair(name_a, fn_a, name_b, fn_b, leaves) -> dict:
    """Both candidates' training steps on the same leaves, each timed as
    captured chains (`graphs.time_chain`)."""
    out = {}
    for name, fn in ((name_a, fn_a), (name_b, fn_b)):
        step, live = _step(fn, leaves)
        out[name] = graphs.time_chain(step, *live)
        torch.cuda.empty_cache()
    return out


def sweep_crossover(device, points) -> List[dict]:
    """points: (C, dg) pairs at config 2's shape."""
    from .ops.cuda import gathermm, shiftblend
    out = []
    for C, dg in points:
        g = min(4, dg)
        spec, leaves = _inputs(device, 8, C, (56, 56), 3, 1, g, dg, 2.0)

        def sb(*t, spec=spec):
            return shiftblend.deform_conv_shift(*t, spec, PRECISION, 2.0)

        def gm(*t, spec=spec):
            return gathermm.deform_conv_fused_pair(*t, spec, PRECISION)
        out.append({"cg": C // dg, "C": C, "dg": dg, "groups": g,
                    **_pair("shiftblend", sb, "gathermm", gm, leaves)})
    return out


def sweep_wide_bound(device, bounds) -> List[dict]:
    """Config 3's shape (deform_conv3d, no mask, no bias) at each bound."""
    from .ops.cuda import gathermm, plan, shiftblend
    out = []
    for b in bounds:
        spec, leaves = _inputs(device, 2, 64, (16, 32, 32), 3, 1, 1, 1, b,
                               modulated=False, bias=False)
        x = leaves[0]
        if shiftblend.ineligible_reason(x, spec, b) is not None:
            continue

        def sb(*t, spec=spec, b=b):
            return shiftblend.deform_conv_shift(*t, spec, PRECISION, b)

        def gm(*t, spec=spec):
            return gathermm.deform_conv_fused_pair(*t, spec, PRECISION)
        out.append({"bound": b, "planar": plan.jax_planar(
            x, spec, current_profile(REFERENCE_KIND)),
            **_pair("shiftblend", sb, "gathermm", gm, leaves)})
    return out


def sweep_fuse(device, names) -> List[dict]:
    """The named FUSE_SHAPES, fused pair against the columns path."""
    from .ops.cuda import gathermm, plan
    out = []
    for name in names:
        B, C, S, stride, g = FUSE_SHAPES[name]
        spec, leaves = _inputs(device, B, C, S, 3, stride, g, g, 2.0)

        def fused(*t, spec=spec):
            return gathermm.deform_conv_fused_pair(*t, spec, PRECISION)

        def cols(*t, spec=spec):
            return gathermm.deform_conv_cols(*t, spec, PRECISION)
        out.append({"name": name, "og": C,
                    "ndim": len(S), "macs": _macs(B, C, S, stride, g),
                    "jax_fuse_ok": plan.jax_fuse_ok(
            leaves[0], spec, C, None, current_profile(REFERENCE_KIND)),
            **_pair("fused", fused, "columns", cols, leaves)})
        del leaves
        torch.cuda.empty_cache()
    return out


def lead_case(device, layout: str, cg: int):
    """(spec, shards, leaves of the interior shard) of a lead layout:
    "cfg2-H4" (C=256, dg = 256 / cg, groups min(4, dg)) or "cfg3-D4" (C =
    cg, dg = 1, config 3's other shapes), split 4 ways on the leading
    dim, max_offset 2, the block cut as the ring delivers it."""
    from .parallel import sharding as sh
    if layout == "cfg2-H4":
        dg = 256 // cg
        spec, ins = _inputs(device, 8, 256, (56, 56), 3, 1, min(4, dg), dg,
                            LEAD_MAX_OFFSET)
    else:
        spec, ins = _inputs(device, 2, cg, (16, 32, 32), 3, 1, 1, 1,
                            LEAD_MAX_OFFSET, modulated=False, bias=False)
    ins = [None if t is None else t.detach() for t in ins]
    x, off, mask, w, b = ins
    nd = spec.ndim
    names = ["s0"] + [None] * (nd - 1)
    plan = sh.shard_plan(x.shape, off.shape, w.shape,
                         None if mask is None else mask.shape,
                         None if b is None else b.shape, spec, {"s0": 4},
                         None, names, LEAD_MAX_OFFSET)
    coords = (1,)
    sl = sh.shard_slices(off.shape, {2: "s0"}, {"s0": 1}, {"s0": 4})
    leaves = [None if t is None else t.clone().requires_grad_(True)
              for t in (sh.cut_block(x, plan.shards, coords), off[sl],
                        None if mask is None else mask[sl], w, b)]
    return spec, plan.shards, coords, leaves


def sweep_lead(device, points) -> List[dict]:
    """points: (layout, C/dg); the lead mode against the gather kernels'
    block mode on the interior shard."""
    from .parallel import sharding as sh
    out = []
    for layout, cg in points:
        spec, shards, coords, leaves = lead_case(device, layout, cg)

        def lead(*t, spec=spec, shards=shards, coords=coords):
            return sh.shard_conv(*t, spec, shards, coords, LEAD_MAX_OFFSET,
                                 "auto", PRECISION, lead=True)

        def gather(*t, spec=spec, shards=shards, coords=coords):
            return sh.shard_conv(*t, spec, shards, coords, LEAD_MAX_OFFSET,
                                 "cuda", PRECISION, lead=False)
        out.append({"layout": layout, "cg": cg,
                    **_pair("lead", lead, "gather", gather, leaves)})
    return out


# ---- the derivation ---------------------------------------------------------


def winner(a: dict, b: dict) -> Optional[int]:
    """0 or 1 where that candidate is faster by more than the run-to-run
    spread of either, None for a tie."""
    spread = max(a["spread"], b["spread"])
    if a["ms"] < b["ms"] * (1 - spread):
        return 0
    if b["ms"] < a["ms"] * (1 - spread):
        return 1
    return None


def _verdicts(points, key, first, second) -> Dict[float, Optional[str]]:
    """Per key value: the one candidate that wins decisively at every point
    of that value where any does, else None (ties, or points that
    disagree)."""
    wins: Dict[float, set] = {}
    for p in points:
        w = winner(p[first], p[second])
        wins.setdefault(p[key], set())
        if w is not None:
            wins[p[key]].add((first, second)[w])
    return {k: (next(iter(v)) if len(v) == 1 else None)
            for k, v in wins.items()}


def _upper(points, key, low, high, base, floor=0):
    """A threshold t with `low` taken where key <= t, `high` above: base,
    raised past the keys above it while `low` wins there, then lowered
    below the keys at or under it while `high` wins there."""
    v = _verdicts(points, key, low, high)
    keys = sorted(v)
    t = base
    for k in [k for k in keys if k > t]:
        if v[k] != low:
            break
        t = k
    for k in [k for k in reversed(keys) if k <= t]:
        if v[k] != high:
            break
        below = [q for q in keys if q < k]
        t = below[-1] if below else floor
    return t


def derive(kind: str, timings: dict, base: Optional[dict] = None) -> dict:
    """The profile's dispatch constants for `kind` from a timing table (the
    sweeps' output: "crossover", "wide_bound_3d", "fuse", "lead", any of
    them absent), starting from `base` (None: the reference profile) and
    keeping a value unless the other candidate wins by more than the
    run-to-run spread.  A pure function: no card needed."""
    base = dict(REFERENCE if base is None else base)
    out = {"kind": kind}
    out["sb_crossover_cg"] = _upper(timings.get("crossover", []), "cg",
                                    "shiftblend", "gathermm",
                                    base["sb_crossover_cg"])
    out["sb_lead_crossover_cg"] = _upper(timings.get("lead", []), "cg",
                                         "lead", "gather",
                                         base["sb_lead_crossover_cg"])
    # The 3D rule takes gathermm at bounds >= t where planar mode applies:
    # the same threshold on the negated bound, gathermm its lower side.
    wide = [dict(p, neg=-p["bound"]) for p in timings.get("wide_bound_3d", [])
            if p.get("planar", True)]
    out["sb_wide_bound_3d"] = -_upper(wide, "neg", "gathermm", "shiftblend",
                                      -base["sb_wide_bound_3d"],
                                      floor=-math.inf)
    fuse = [p for p in timings.get("fuse", []) if p.get("jax_fuse_ok", True)]
    for nd, field in ((2, "cols_min_macs"), (3, "cols_min_macs_3d")):
        out[field] = _fuse_rule([p for p in fuse if p.get("ndim", 2) == nd],
                                base[field])
    return out


def _fuse_rule(points, base):
    """cols_min_macs: the base, unless a point's decisive winner is not the
    pair the base takes there; then the least multiply-adds of a point the
    columns path wins with no point the fused pair wins at or above it
    (None where there is none)."""
    def columns(p, t):
        return t is not None and p["macs"] >= t
    wins = [(p, ("fused", "columns")[w]) for p in points
            for w in [winner(p["fused"], p["columns"])] if w is not None]
    if all((w == "columns") == columns(p, base) for p, w in wins):
        return base
    fused = [p["macs"] for p, w in wins if w == "fused"]
    ok = [p["macs"] for p, w in wins
          if w == "columns" and all(m < p["macs"] for m in fused)]
    return min(ok) if ok else None


def _around(grid, t, upper=True):
    """The last grid point on t's lower side and the first past it (upper:
    the lower side is <= t; else < t)."""
    lo = [k for k in grid if (k <= t if upper else k < t)]
    hi = [k for k in grid if (k > t if upper else k >= t)]
    return ([lo[-1]] if lo else []) + ([hi[0]] if hi else [])


def quick_points(prof: Optional[DeviceProfile] = None) -> dict:
    """One point either side of each value of `prof` (None: the reference
    profile's, where a card's measured values diverge from the JAX
    package's), with every point of the full sweep at those keys."""
    prof = prof or current_profile(REFERENCE_KIND)
    full = full_points()
    cg = _around(CG_POINTS, prof.sb_crossover_cg)
    near = {}
    for nd, t in ((2, prof.cols_min_macs), (3, prof.cols_min_macs_3d)):
        macs = {n: _macs(*v) for n, v in FUSE_SHAPES.items()
                if len(v[2]) == nd and n not in ("cfg5-c4", "cfg5-c5")}
        keys = _around(sorted(set(macs.values())),
                       math.inf if t is None else t, upper=False)
        near.update({n: m for n, m in macs.items() if m in keys})
    lead = _around(LEAD_CG_POINTS, prof.sb_lead_crossover_cg)
    return {"crossover": [p for p in full["crossover"] if p[0] // p[1] in cg],
            "wide_bound_3d": _around(BOUND_POINTS, prof.sb_wide_bound_3d,
                                     upper=False),
            "fuse": [n for n in full["fuse"] if n in near],
            "lead": [p for p in full["lead"] if p[1] in lead]}


def full_points() -> dict:
    """Every point of the four sweeps."""
    return {"crossover": [(256, 256 // cg) for cg in CG_POINTS]
            + [(512, 512 // WIDE_CG)],
            "wide_bound_3d": list(BOUND_POINTS),
            "fuse": list(FUSE_SHAPES),
            "lead": [(lay, cg) for lay in ("cfg2-H4", "cfg3-D4")
                     for cg in LEAD_CG_POINTS]}


def calibrate(device="cuda", quick: bool = False, repeat: int = 1,
              log=print) -> dict:
    """Measure the card: {"kind", "measured", "timings", "profile",
    "base", "quick", "contradicts", "timing"} (TIMING: how the times
    were taken).  The sweeps run `repeat` times and the profile
    is derived over every run's points (a key's verdict needs every
    decisive point there to agree).  With `quick`, the points either side
    of the reference profile's values, derived from the card's resolved
    profile; `contradicts` lists the values the points move."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("calibrate measures a CUDA card; none is "
                           f"available as {device}")
    from .ops.cuda import lib
    lib.build(lib.sources())
    kind = device_kind(device)
    with torch.cuda.device(device):
        measured = {
            "tf32_matmul_flops": measure_matmul(device, torch.float32),
            "bf16_matmul_flops": measure_matmul(device, torch.bfloat16),
            "hbm_copy_bytes_per_s": measure_hbm_copy(device),
            "fp32_fma_flops": measure_fma(device)}
        log("raw rates: " + ", ".join(
            f"{k} {v / 1e12:.2f} T" for k, v in measured.items()))
        prof = current_profile(device)
        base = ({f: getattr(prof, f) for f in DISPATCH_FIELDS} if quick
                else {f: REFERENCE[f] for f in DISPATCH_FIELDS})
        pts = quick_points() if quick else full_points()
        timings = {rule: [] for rule in pts}
        for run in range(repeat):
            for rule, rows in (
                    ("crossover", sweep_crossover(device, pts["crossover"])),
                    ("wide_bound_3d", sweep_wide_bound(
                        device, pts["wide_bound_3d"])),
                    ("fuse", sweep_fuse(device, pts["fuse"])),
                    ("lead", sweep_lead(device, pts["lead"]))):
                timings[rule] += [dict(r, run=run) for r in rows]
    for rule, rows in timings.items():
        for r in rows:
            pair = [k for k, v in r.items() if isinstance(v, dict)]
            log(f"{rule} " + " ".join(f"{k}={v}" for k, v in r.items()
                                      if k not in pair) + ": " + " / ".join(
                f"{k} {r[k]['ms']:.4f} ms (spread {r[k]['spread']:.3f})"
                for k in pair))
    derived = derive(kind, timings, base)
    contradicts = [f for f in DISPATCH_FIELDS if derived[f] != base[f]]
    return {"kind": kind, "measured": measured, "timings": timings,
            "profile": derived, "base": base, "quick": quick,
            "contradicts": contradicts, "timing": dict(TIMING)}


def write_profile(path: str, result: dict) -> None:
    """Add the result's profile under its device name to the JSON file at
    path (temp file and rename), with its raw rates, timings and how they
    were taken."""
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing[result["kind"]] = {**result["profile"],
                                "measured": result["measured"],
                                "timings": result["timings"],
                                "quick": result["quick"],
                                "timing": result["timing"]}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Measure this CUDA card and write an MDC_PROFILE json.")
    ap.add_argument("--out", default=os.environ.get("MDC_PROFILE",
                                                    "mdc_profile.json"))
    ap.add_argument("--quick", action="store_true",
                    help="one point either side of each reference value, "
                    "checked against the committed profile")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the sweeps this many times, derive over all")
    args = ap.parse_args(argv)
    res = calibrate("cuda", args.quick, args.repeat)
    write_profile(args.out, res)
    print(f"device: {res['kind']}; timing {json.dumps(res['timing'])}")
    print("derived: " + json.dumps(res["profile"]))
    if res["contradicts"]:
        print(f"moved off the base profile: {res['contradicts']} "
              f"(base {json.dumps(res['base'])})")
    print(f"wrote {args.out}; activate with MDC_PROFILE={args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
