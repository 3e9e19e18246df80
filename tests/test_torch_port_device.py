"""The port's device layer (utils/device.py, calibrate.py) against the JAX
package's (utils/device.py, its dispatch rules).

* Profile resolution: the built-in table, the unknown-name fallback (the
  reference profile, logged once) and the precedence env > MDC_PROFILE
  file > table.
* Under the same MDC_SB_CROSSOVER / MDC_LANE_BUDGET / MDC_PROFILE, the
  port's reference profile and JAX's `current_profile` resolve the same
  crossover and lane budget, and both dispatches move the same way.
* The reference profile reproduces JAX's dispatch on `meta` tensors:
  `select_kernel`, the fuse rule and the sharded lead-mode rule.
* The H100 profile takes the pair its entry names at configs 2, 3, 5
  (c3-c5) and at the lead layouts, and differs from JAX's choice exactly
  at the DISPATCH cases marked as deliberate divergences.
* `calibrate.derive` on synthetic timing tables (no card), its JSON round
  trip through MDC_PROFILE, and calibrate's refusal to run off the card.
Nothing here runs a kernel or computes a convolution.
"""
import json
import logging
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from modulated_deform_conv_tpu.ops import pallas as jpl
from modulated_deform_conv_tpu.ops.pallas import gathermm as jgm
from modulated_deform_conv_tpu.ops.pallas import shiftblend as jsb
from modulated_deform_conv_tpu.utils import device as jdev
from modulated_deform_conv_tpu.utils.config import DeformConvSpec as JSpec

from modulated_deform_conv_tpu_torch import calibrate
from modulated_deform_conv_tpu_torch.ops.cuda import plan, select_kernel
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils import device
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

from test_torch_port_3d_kernels import DISPATCH3D, H100_DIVERGES3D
from test_torch_port_columns import FUSE_SWEEP
from test_torch_port_kernels import DISPATCH, H100_DIVERGES

H100 = "NVIDIA H100 80GB HBM3"
ENV = ("MDC_SB_CROSSOVER", "MDC_LANE_BUDGET", "MDC_PROFILE",
       "MDC_SB_WIDE_BOUND_3D", "MDC_SB_LEAD_CROSSOVER", "MDC_COLS_MIN_MACS",
       "MDC_COLS_MIN_MACS_3D", "MDC_VMEM_BYTES")


@pytest.fixture(autouse=True)
def clean_profiles(monkeypatch):
    """No profile env var set, and both packages' resolved profiles
    forgotten before and after each test."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    device.clear_cache()
    jdev._profile_for_kind.cache_clear()
    yield
    device.clear_cache()
    jdev._profile_for_kind.cache_clear()


def _jspec(spec):
    return JSpec.make(spec.ndim, spec.kernel, spec.stride, spec.padding,
                      spec.dilation, spec.groups, spec.deformable_groups,
                      spec.in_step, spec.modulated)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _jax_choice(B, C, S, spec, bound, dtype="float32"):
    """The pair JAX's maybe_pallas takes on its TPU (None: neither)."""
    js = _jspec(spec)
    xj = jax.ShapeDtypeStruct((B, C) + S, jnp.dtype(dtype))
    sb_reason = jsb.ineligible_reason(xj, js, bound)
    reason = jgm.ineligible_reason(xj, js)
    if sb_reason is None:
        p = jsb.SBPlan(js, B, C, S, js.out_sizes(S), bound)
        if reason is not None or jpl._prefer_shiftblend(xj, js, p):
            return "shiftblend"
    return "gathermm" if reason is None else None


# ---- resolution -------------------------------------------------------------


def test_table_and_reference():
    """CPU and meta tensors resolve to the reference profile, the JAX
    package's v5e values; an H100's name to the table's H100 entry."""
    ref = device.current_profile(torch.zeros(1))
    assert ref is device.current_profile(_meta((1,)))
    assert ref.kind == device.REFERENCE_KIND == "TPU v5 lite"
    assert (ref.sb_crossover_cg, ref.sb_wide_bound_3d,
            ref.sb_lead_crossover_cg, ref.cols_min_macs) == (128, 1.5, 128,
                                                            None)
    j = jdev.current_profile()
    assert (ref.lane_budget, ref.a_chunk_bytes, ref.x_plane_bytes) == (
        j.lane_budget, j.gm_a_chunk_budget, j.gm_x_plane_budget)
    h = device.current_profile(H100)
    entry = device.table_entry(H100)
    assert entry and all(getattr(h, k) == v for k, v in entry.items())
    assert device.table_entry("NVIDIA H100 PCIe") == entry


def test_unknown_card_falls_back_once(caplog):
    """An unknown CUDA name takes the reference profile's values under its
    own name, and says so once."""
    with caplog.at_level(logging.WARNING, "modulated_deform_conv_tpu_torch"):
        a = device.current_profile("NVIDIA A100-SXM4-80GB")
        b = device.current_profile("NVIDIA A100-SXM4-80GB")
    assert a is b and a.kind == "NVIDIA A100-SXM4-80GB"
    ref = device.reference_profile()
    assert {f: getattr(a, f) for f in device.REFERENCE} == {
        f: getattr(ref, f) for f in device.REFERENCE}
    assert len([r for r in caplog.records if "A100" in r.getMessage()]) == 1


def test_precedence_env_over_file_over_table(tmp_path, monkeypatch):
    path = tmp_path / "profile.json"
    path.write_text(json.dumps({H100: {
        "sb_crossover_cg": 64, "sb_wide_bound_3d": "inf",
        "cols_min_macs": None, "measured": {"tf32_matmul_flops": 4e14}}}))
    table = device.current_profile(H100)
    monkeypatch.setenv("MDC_PROFILE", str(path))
    device.clear_cache()
    filed = device.current_profile(H100)
    assert filed.sb_crossover_cg == 64 and math.isinf(filed.sb_wide_bound_3d)
    assert filed.cols_min_macs is None
    assert filed.sb_lead_crossover_cg == table.sb_lead_crossover_cg
    monkeypatch.setenv("MDC_SB_CROSSOVER", "32")
    monkeypatch.setenv("MDC_SB_WIDE_BOUND_3D", "2.0")
    monkeypatch.setenv("MDC_SB_LEAD_CROSSOVER", "16")
    monkeypatch.setenv("MDC_COLS_MIN_MACS", "1000")
    monkeypatch.setenv("MDC_COLS_MIN_MACS_3D", "none")
    assert device.current_profile(H100) is filed        # cached per name
    device.clear_cache()
    env = device.current_profile(H100)
    assert (env.sb_crossover_cg, env.sb_wide_bound_3d,
            env.sb_lead_crossover_cg, env.cols_min_macs,
            env.cols_min_macs_3d) == (32, 2.0, 16, 1000, None)


@pytest.mark.parametrize("env,filed", [
    ({"MDC_SB_CROSSOVER": "64", "MDC_LANE_BUDGET": "2304"}, None),
    ({}, {"sb_crossover_cg": 32, "lane_budget": 1152}),
    ({"MDC_SB_CROSSOVER": "256"}, {"sb_crossover_cg": 32}),
])
def test_overrides_match_jax(env, filed, tmp_path, monkeypatch):
    """The same env and MDC_PROFILE file give the port's reference profile
    the crossover and lane budget that JAX's `current_profile` resolves
    off the TPU, and move both dispatches alike at config 2's shape."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if filed is not None:
        path = tmp_path / "p.json"
        path.write_text(json.dumps({"TPU v5 lite": filed}))
        monkeypatch.setenv("MDC_PROFILE", str(path))
    j = jdev.current_profile()
    p = device.current_profile(torch.zeros(1))
    assert (p.sb_crossover_cg, p.lane_budget) == (j.sb_crossover_cg,
                                                  j.lane_budget)
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 4, 4, modulated=True)
    for C in (128, 256, 512):
        got = select_kernel(_meta((8, C, 56, 56)), spec, 2.0)[0]
        assert got == _jax_choice(8, C, (56, 56), spec, 2.0), C


# ---- the reference profile is JAX's dispatch --------------------------------


def _dispatch_cases():
    """(case, B, C, S, spec args, bound, dtype) of DISPATCH and DISPATCH3D."""
    out = []
    for c in DISPATCH:
        B, C, S, k, stride, pad, g, dg, bound, dtype = c
        out.append((c, B, C, S, (len(S), k, stride, pad, 1, g, dg), bound,
                    dtype))
    for c in DISPATCH3D:
        B, C, S, k, pad, dil, bound, dtype = c
        out.append((c, B, C, S, (3, k, 1, pad, dil, 1, 1), bound, dtype))
    return out


@pytest.mark.parametrize("case", _dispatch_cases())
def test_reference_profile_dispatch_is_jax(case):
    _, B, C, S, sargs, bound, dtype = case
    spec = DeformConvSpec.make(*sargs, modulated=True)
    x = _meta((B, C) + S, getattr(torch, dtype))
    got = select_kernel(x, spec, bound, profile=device.reference_profile())
    assert got[0] == _jax_choice(B, C, S, spec, bound, dtype)


def test_reference_profile_fuse_rule_is_jax():
    ref = device.reference_profile()
    for B, C, O, S, k, stride, g, dg in FUSE_SWEEP:
        spec = DeformConvSpec.make(len(S), k, stride, k // 2, 1, g, dg,
                                   modulated=True)
        js = _jspec(spec)
        jp = jgm._Plan(js, B, C, S, js.out_sizes(S), jnp.float32)
        assert plan.fuse_ok(_meta((B, C) + S), spec, O, None, ref) == \
            jgm._fuse_ok(jp, C, g, O), (B, C, O, S, g, dg)


def _lead_cases():
    """(x_l shape, spec args, bound): one leading-dim split of 4 shards, a
    3-row halo (2D) or 4-plane halo (3D), across C/dg, groups and bound."""
    out = []
    for C, dg, g, bound in ((8, 1, 1, 2.0), (64, 1, 1, 2.0), (128, 1, 1, 1.0),
                            (256, 2, 2, 2.0), (256, 1, 1, 2.0),
                            (264, 1, 1, 2.0), (64, 2, 1, 0.0),
                            (96, 1, 1, 2.0), (512, 4, 4, 2.0)):
        out.append(((1, C, 8, 8), (2, 3, 1, 1, 1, g, dg), bound, 3))
    for C in (16, 128):
        out.append(((1, C, 4, 8, 16), (3, 3, 1, 1, 1, 1, 1), 2.0, 4))
    return out


@pytest.mark.parametrize("case", _lead_cases())
def test_reference_lead_rule_is_jax(case):
    """`lead_prefers` under the reference profile is JAX's on-TPU lead-mode
    rule (sharding.py:179-203: C/dg <= 128 and its lead reason), on meta
    tensors.  JAX's VMEM budget reasons have no counterpart on the card."""
    shape, sargs, bound, halo = case
    spec = DeformConvSpec.make(*sargs, modulated=True)
    shard = sh._SpatialShard(0, "space", 4, halo, shape[2], shape[2])
    ext = (shape[0], shape[1], shape[2] + 2 * halo) + shape[3:]
    reason = jsb.sharded_lead_reason(ext, jnp.float32, _jspec(spec), bound,
                                     halo, 4 * shape[2])
    if reason is not None and ("residency" in reason or "residual" in reason):
        pytest.skip("a TPU VMEM budget reason")
    want = (bound > 0 and reason is None
            and shape[1] // spec.deformable_groups <= 128)
    assert sh.lead_prefers(_meta(shape), spec, (shard,), bound,
                           device.reference_profile()) == want


# ---- the H100 profile -------------------------------------------------------


@pytest.mark.parametrize("case", _dispatch_cases())
def test_h100_dispatch_diverges_only_where_marked(case):
    """On the H100 profile the port takes JAX's pair except at the cases
    marked in DISPATCH / DISPATCH3D (H100_DIVERGES, H100_DIVERGES3D), where
    it takes the marked pair."""
    key, B, C, S, sargs, bound, dtype = case
    spec = DeformConvSpec.make(*sargs, modulated=True)
    marked = {**H100_DIVERGES, **H100_DIVERGES3D}
    want = _jax_choice(B, C, S, spec, bound, dtype)
    if key in marked:
        assert marked[key] != want
        want = marked[key]
    x = _meta((B, C) + S, getattr(torch, dtype))
    assert select_kernel(x, spec, bound,
                         profile=device.current_profile(H100))[0] == want


# Which pair the H100 entry takes at the repo's configurations (PERF.md,
# section 6; the chained sweep put every measured unbounded shape on the
# columns path): (B, C, S, k, stride, g, dg, bound) -> pair; the general
# pair is "fused" or "columns".
H100_PAIRS = {
    "cfg2 bounded": ((8, 256, (56, 56), 3, 1, 4, 4, 2.0), "shiftblend"),
    "cfg2 general": ((8, 256, (56, 56), 3, 1, 4, 4, None), "columns"),
    "cfg1 bounded": ((2, 32, (64, 64), 3, 1, 1, 1, 2.0), "shiftblend"),
    "cfg1 general": ((2, 32, (64, 64), 3, 1, 1, 1, None), "fused"),
    "cfg3": ((2, 64, (16, 32, 32), 3, 1, 1, 1, 2.0), "shiftblend"),
    "cfg3 general": ((2, 64, (16, 32, 32), 3, 1, 1, 1, None), "columns"),
    "DCNVideoNet s1b0": ((8, 64, (16, 56, 56), 3, 1, 1, 1, None), "columns"),
    "DCNVideoNet s2b0": ((8, 128, (16, 28, 28), 3, 1, 1, 1, None), "columns"),
    "cfg4": ((4, 128, (32, 64, 64), 3, 1, 1, 1, 2.0), "shiftblend"),
    "cfg5 c3": ((32, 512, (28, 28), 3, 1, 1, 1, None), "columns"),
    "cfg5 c4": ((32, 1024, (14, 14), 3, 1, 1, 1, None), "columns"),
    "cfg5 c5": ((32, 2048, (7, 7), 3, 1, 1, 1, None), "columns"),
    "DCNResNet-50 c3 first": ((8, 128, (56, 56), 3, 2, 1, 1, None),
                              "columns"),
    "DCNResNet-50 c4": ((8, 256, (14, 14), 3, 1, 1, 1, None), "columns"),
    "DCNResNet-50 c5": ((8, 512, (7, 7), 3, 1, 1, 1, None), "columns"),
    "DCNResNet-50 c5 first": ((8, 512, (14, 14), 3, 2, 1, 1, None),
                              "columns"),
    # Below the least multiply-adds the columns path was timed ahead at
    # (DCNResNet-50's layers at B=8), the fused pair stays.
    "DCNResNet-50 c4 B=4": ((4, 256, (14, 14), 3, 1, 1, 1, None), "fused"),
    "3D small volume": ((2, 64, (4, 16, 16), 3, 1, 1, 1, None), "fused"),
}


@pytest.mark.parametrize("name", sorted(H100_PAIRS))
def test_h100_pairs_at_the_configs(name):
    (B, C, S, k, stride, g, dg, bound), want = H100_PAIRS[name]
    spec = DeformConvSpec.make(len(S), k, stride, 1, 1, g, dg,
                               modulated=True)
    prof = device.current_profile(H100)
    x = _meta((B, C) + S)
    got = select_kernel(x, spec, bound, profile=prof)[0]
    if got == "gathermm":
        got = "fused" if plan.fuse_ok(x, spec, C, None, prof) else "columns"
    assert got == want


# The lead layouts of chip_smoke.py: (x_l shape, spec args, halo) of one
# shard of four on the leading dim, max_offset 2 -> lead mode taken on the
# H100 (never: its lead crossover is 0, the gather kernels' block mode
# ahead at every swept C/dg; the reference profile's 128 takes all but
# C/dg 256).
H100_LEAD = {
    "cfg2-H4": (((8, 256, 14, 56), (2, 3, 1, 1, 1, 4, 4), 3), False),
    "cfg3-D4": (((2, 64, 4, 32, 32), (3, 3, 1, 1, 1, 1, 1), 3), False),
    "cfg4-D4": (((1, 128, 8, 64, 64), (3, 3, 1, 1, 1, 1, 1), 3), False),
    "cfg2-H4 at dg 8": (((8, 256, 14, 56), (2, 3, 1, 1, 1, 4, 8), 3), False),
    "cfg2-H4 at dg 1": (((8, 256, 14, 56), (2, 3, 1, 1, 1, 1, 1), 3), False),
}


@pytest.mark.parametrize("name", sorted(H100_LEAD))
def test_h100_lead_layouts(name):
    (shape, sargs, halo), want = H100_LEAD[name]
    spec = DeformConvSpec.make(*sargs, modulated=True)
    shard = sh._SpatialShard(0, "space", 4, halo, shape[2], shape[2])
    assert sh.lead_prefers(_meta(shape), spec, (shard,), 2.0,
                           device.current_profile(H100)) == want
    assert sh.lead_prefers(_meta(shape), spec, (shard,), 2.0,
                           device.reference_profile()) == (
        shape[1] // spec.deformable_groups <= 128)


def test_budget_rules_left_out_on_purpose():
    """JAX's shift-blend residency and residual budgets guard the TPU's
    VMEM and 16 GB of HBM; the port's kernels have neither limit, so the
    port keeps shift-blend where JAX falls back to gathermm."""
    B, C, S = 128, 256, (112, 112)
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 4, 4, modulated=True)
    xj = jax.ShapeDtypeStruct((B, C) + S, jnp.float32)
    assert "residual" in jsb.ineligible_reason(xj, _jspec(spec), 2.0)
    assert _jax_choice(B, C, S, spec, 2.0) == "gathermm"
    for prof in (device.reference_profile(), device.current_profile(H100)):
        assert select_kernel(_meta((B, C) + S), spec, 2.0,
                             profile=prof)[0] == "shiftblend"


# ---- calibrate --------------------------------------------------------------


def _t(ms, spread=0.02):
    return {"ms": ms, "spread": spread}


def _table():
    """A synthetic sweep: shift-blend ahead up to C/dg 64, a tie at 128,
    gathermm ahead at 256; the 3D shift-blend pair ahead up to bound 2;
    the columns path ahead in 2D from 1e9 multiply-adds, but not at 3e8,
    and in 3D from 3e8; the lead mode
    ahead up to 32."""
    cross = [{"cg": cg, "shiftblend": _t(a), "gathermm": _t(b)} for cg, a, b
             in ((8, 1.0, 2.0), (64, 1.0, 1.5), (128, 1.0, 1.01),
                 (256, 2.0, 1.0))]
    wide = [{"bound": b, "planar": True, "shiftblend": _t(s),
             "gathermm": _t(g)} for b, s, g in ((0.5, 1.0, 2.0),
                                                (1.5, 1.0, 1.5),
                                                (2.0, 1.0, 1.2),
                                                (2.5, 1.5, 1.0))]
    fuse = [{"ndim": nd, "macs": n, "jax_fuse_ok": ok, "fused": _t(f),
             "columns": _t(c)}
            for nd, n, ok, f, c in ((2, 1e8, True, 1.0, 2.0),
                                    (2, 3e8, True, 1.0, 2.0),
                                    (2, 6e8, True, 1.0, 1.01),
                                    (2, 1e9, True, 3.0, 1.0),
                                    (2, 6e10, True, 10.0, 3.0),
                                    (2, 5e7, False, 10.0, 2.0),
                                    (3, 1e8, True, 1.0, 2.0),
                                    (3, 3e8, True, 2.0, 1.0),
                                    (3, 4e10, True, 3.0, 1.0))]
    lead = [{"layout": "cfg2-H4", "cg": cg, "lead": _t(a), "gather": _t(b)}
            for cg, a, b in ((32, 1.0, 1.2), (64, 1.2, 1.0),
                             (128, 1.2, 1.0), (256, 1.2, 1.0))]
    return {"crossover": cross, "wide_bound_3d": wide, "fuse": fuse,
            "lead": lead}


def test_derive_from_a_sweep():
    got = calibrate.derive(H100, _table())
    assert got == {"kind": H100, "sb_crossover_cg": 128,
                   "sb_wide_bound_3d": 2.5, "sb_lead_crossover_cg": 32,
                   "cols_min_macs": 1e9, "cols_min_macs_3d": 3e8}


def test_derive_tie_rule():
    """Ties keep the base value; a win by less than the spread is a tie."""
    table = _table()
    assert calibrate.derive("x", {})["sb_crossover_cg"] == 128
    flat = {k: [dict(r, **{n: _t(1.0) for n, v in r.items()
                           if isinstance(v, dict)}) for r in rows]
            for k, rows in table.items()}
    got = calibrate.derive("x", flat)
    assert {f: got[f] for f in calibrate.DISPATCH_FIELDS} == {
        f: device.REFERENCE[f] for f in calibrate.DISPATCH_FIELDS}
    # gathermm 8% ahead at 128: a tie under a 10% spread, a win under 5%.
    cross = [{"cg": 128, "shiftblend": _t(1.08, s), "gathermm": _t(1.0, s)}
             for s in (0.10, 0.05)]
    assert calibrate.derive("x", {"crossover": cross[:1]})[
        "sb_crossover_cg"] == 128
    assert calibrate.derive("x", {"crossover": cross[1:]})[
        "sb_crossover_cg"] == 0
    # From a committed base, points that agree with it move nothing.
    base = calibrate.derive(H100, table)
    assert calibrate.derive(H100, table, base) == base


def test_quick_points_straddle_the_reference():
    """--quick times one point either side of each reference value, every
    full-sweep point at those keys; the H100 profile's values diverge from
    the reference there, so the quick points hold them."""
    pts = calibrate.quick_points()
    assert sorted({C // dg for C, dg in pts["crossover"]}) == [128, 256]
    assert pts["wide_bound_3d"] == [1.0, 1.5]
    assert pts["fuse"] == ["cfg5-c3", "video-s1", "video-s2"]
    assert sorted({cg for _, cg in pts["lead"]}) == [128, 256]
    full = calibrate.full_points()
    for rule in pts:
        assert all(p in full[rule] for p in pts[rule])
    h = device.current_profile(H100)
    ref = device.reference_profile()
    assert h.sb_crossover_cg >= 256 > ref.sb_crossover_cg
    assert h.sb_wide_bound_3d > 1.5 >= ref.sb_wide_bound_3d
    assert h.sb_lead_crossover_cg < 128 <= ref.sb_lead_crossover_cg
    c3 = calibrate._macs(*calibrate.FUSE_SHAPES["cfg5-c3"])
    assert h.prefers_columns(c3) and not ref.prefers_columns(c3)


def test_profile_json_round_trip(tmp_path, monkeypatch):
    """calibrate's file, read back through MDC_PROFILE, gives the derived
    values for its device name."""
    table = _table()
    res = {"kind": H100, "profile": calibrate.derive(H100, table),
           "measured": {"hbm_copy_bytes_per_s": 3.0e12}, "timings": table,
           "quick": False, "timing": dict(calibrate.TIMING)}
    path = str(tmp_path / "p.json")
    calibrate.write_profile(path, res)
    calibrate.write_profile(path, dict(res, kind="other"))
    data = json.loads(open(path).read())
    assert set(data) == {H100, "other"}
    monkeypatch.setenv("MDC_PROFILE", path)
    device.clear_cache()
    p = device.current_profile(H100)
    assert {f: getattr(p, f) for f in calibrate.DISPATCH_FIELDS} == {
        f: res["profile"][f] for f in calibrate.DISPATCH_FIELDS}


def test_calibrate_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        calibrate.calibrate("cpu")
