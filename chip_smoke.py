#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main path, the DCNv2 2D forward at the bench's config 2
(B=8, 256->256 channels, 56x56, 3x3, stride 1, pad 1, groups =
deformable_groups = 4, bias, offsets from U[-2, 2]), through the entry
points a user calls: `modulated_deform_conv2d` with and without
`offset_bound=2.0`, and `ModulatedDeformConv2dPack`.  It builds both
kernels from `modulated_deform_conv_tpu_torch/csrc/`, checks that the path
launched them, holds each kernel against its plain PyTorch version in
every precision mode, times them with CUDA events, and prints one JSON
line per kernel table and a last line {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
It exits nonzero, and prints no result, without a CUDA device or without
the package beside it.  Imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

B, C, O, H, W, KS, G, DG = 8, 256, 256, 56, 56, 3, 4, 4
BOUND = 2.0
# Kernel vs plain version, max|d| / max|ref| per precision mode.
LIMITS = {"float32": 1e-5,
          "tensorfloat32": 5e-3,   # 10-bit mantissa over a 576-long sum
          "bfloat16": 2e-2}
# H100 SXM published peaks (dense): bytes/s and operations/s per type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "tensorfloat32": 495e12, "bfloat16": 989e12}
MAIN_PRECISION = "tensorfloat32"   # the ops' default mode
TIMED_ITERS = 20


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, ref):
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def time_ms(fn, iters=TIMED_ITERS, per_sample=10, warmup=3):
    """Median over `iters` samples of the time of one fn() call, each sample
    CUDA events around `per_sample` back-to-back calls (so the host's
    enqueue of one call overlaps the device's run of the previous)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def cfg2_inputs(torch, dev):
    """bench.py's config-2 inputs (bench.py:212-221), seeded with numpy."""
    K = KS * KS
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = rng.standard_normal((B, C, H, W)).astype(f32)
    off = rng.uniform(-2, 2, (B, DG * 2 * K, H, W)).astype(f32)
    mask = rng.uniform(0, 1, (B, DG * K, H, W)).astype(f32)
    w = (rng.standard_normal((O, C // G, KS, KS)) * 0.05).astype(f32)
    bias = np.zeros((O,), f32)
    return [torch.from_numpy(a).to(dev) for a in (x, off, mask, w, bias)]


def small_cases(torch, dev):
    """Small configs with ragged tiles, offsets far beyond the bound (partial
    and full corner drops) and far outside the image, no mask / no bias,
    stride and dilation, and deformable groups straddling conv groups."""
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    rng = np.random.default_rng(1)
    cases = []
    # name, kernel, (B, C, O, H, W, k, stride, pad, dil, g, dg), modulated,
    # bias, offset scale, bound
    table = [
        ("shiftblend_fwd", (2, 32, 48, 13, 11, 3, 1, 1, 1, 2, 4), True, True, 4.0, 1.5),
        ("shiftblend_fwd", (1, 16, 16, 9, 9, 3, 1, 2, 2, 1, 2), False, False, 5.0, 2.0),
        ("shiftblend_fwd", (2, 64, 80, 10, 19, 5, 1, 2, 1, 2, 2), True, True, 3.0, 2.5),
        ("gathermm_fwd", (2, 32, 48, 13, 11, 3, 2, 1, 1, 1, 4), True, True, 6.0, None),
        ("gathermm_fwd", (1, 12, 8, 9, 7, 3, 1, 2, 2, 2, 3), False, False, 2.0, None),
        ("gathermm_fwd", (2, 64, 130, 20, 17, 3, 1, 1, 1, 2, 1), True, False, 1.5, None),
    ]
    for name, (b, c, o, h, w_, k, s, p, d, g, dg), modulated, with_bias, scale, bound in table:
        spec = DeformConvSpec.make(2, k, s, p, d, g, dg, modulated=modulated)
        oh, ow = spec.out_sizes((h, w_))
        K = k * k
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        x = t(rng.standard_normal((b, c, h, w_)))
        off = t(rng.uniform(-scale, scale, (b, dg * 2 * K, oh, ow)))
        mask = t(rng.uniform(0, 1, (b, dg * K, oh, ow))) if modulated else None
        wt = t(rng.standard_normal((o, c // g, k, k)) * 0.1)
        bias = t(rng.standard_normal((o,))) if with_bias else None
        cases.append((name, spec, (x, off, mask, wt, bias), bound))
    return cases


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import modulated_deform_conv_tpu_torch as mdt
        from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
        from modulated_deform_conv_tpu_torch.ops.cuda import lib
        from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
        from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    check("jax" not in sys.modules, "the port imported jax")

    # Phase 1: the card, and the TF32 switches the plain versions depend on.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = True          # dense anchor in TF32
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    kernels = {"shiftblend_fwd": (sb.shiftblend_fwd, sb.shiftblend_fwd_reference),
               "gathermm_fwd": (gm.gathermm_fwd, gm.gathermm_fwd_reference)}

    def reset():
        for fn, _ in kernels.values():
            fn.launches = 0

    def counts():
        return {n: fn.launches for n, (fn, _) in kernels.items()}

    # Phase 2: build both kernels from the sources, in parallel.
    t0 = time.time()
    logs = lib.build(lib.KERNELS, verbose=True)
    print(f"build: {time.time() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # Phase 3: the main path at config 2, through the functional op.
    x, off, mask, w, bias = cfg2_inputs(torch, dev)
    spec = DeformConvSpec.make(2, KS, 1, 1, 1, G, DG, modulated=True)

    def op(**kw):
        return mdt.modulated_deform_conv2d(x, off, mask, w, bias, 1, 1, 1, G,
                                           DG, **kw)

    with torch.no_grad():
        reset()
        out_bounded = op(impl="auto", offset_bound=BOUND)
        out_general = op(impl="auto")
        torch.cuda.synchronize()
        main_launches = counts()
        print(f"main path launches: {main_launches}")
        for n, c in main_launches.items():
            check(c >= 1, f"{n} was not launched on the main path")
        ref = op(impl="torch")
        for label, out in (("bounded", out_bounded), ("general", out_general)):
            check(out.shape == (B, O, H, W), f"{label} output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{label} output not finite")
            e = rel_err(out, ref)
            print(f"main path {label} vs impl='torch': rel err {e:.3e}")
            check(e <= LIMITS[MAIN_PRECISION], f"main path {label} disagrees: {e:.3e}")

        # Phase 4: each kernel against its plain version, every mode.
        results = {n: {"rel_err": {}} for n in kernels}
        extra = {"shiftblend_fwd": (BOUND,), "gathermm_fwd": ()}
        for name, (fn, ref_fn) in kernels.items():
            for prec, limit in LIMITS.items():
                got = fn(x, off, mask, w, bias, spec, prec, *extra[name])
                want = ref_fn(x, off, mask, w, bias, spec, prec, *extra[name])
                e = rel_err(got, want)
                results[name]["rel_err"][prec] = e
                if prec == MAIN_PRECISION:
                    results[name]["max_abs_err"] = float((got - want).abs().max())
                print(f"{name} cfg2 {prec}: rel err {e:.3e} (limit {limit:g})")
                check(e <= limit, f"{name} {prec} disagrees with its plain version")
                del got, want
        for name, sspec, args, bound in small_cases(torch, dev):
            fn, ref_fn = kernels[name]
            ext = (bound,) if bound is not None else ()
            for prec, limit in LIMITS.items():
                e = rel_err(fn(*args, sspec, prec, *ext), ref_fn(*args, sspec, prec, *ext))
                check(e <= limit, f"{name} small case {sspec} {prec}: rel err {e:.3e}")
            print(f"{name} small case k={sspec.kernel} s={sspec.stride} d={sspec.dilation} "
                  f"g={sspec.groups} dg={sspec.deformable_groups} bound={bound}: ok")
        # bf16 input through the entry point: upcast, result in bf16.
        xb = x.to(torch.bfloat16)
        yb = mdt.modulated_deform_conv2d(xb, off, mask, w, bias, 1, 1, 1, G, DG,
                                         impl="cuda", offset_bound=BOUND)
        check(yb.dtype == torch.bfloat16, f"bf16 input gave {yb.dtype}")
        e = rel_err(yb, ref)
        print(f"bf16 input through impl='cuda': rel err {e:.3e} vs fp32 reference")
        check(e <= LIMITS["bfloat16"], "bf16 input disagrees")

        # Phase 5: the Pack module at config 2, with and without the bound.
        torch.manual_seed(0)
        for bound, want_kernel in ((BOUND, "shiftblend_fwd"), (None, "gathermm_fwd")):
            mod = mdt.ModulatedDeformConv2dPack(
                C, O, KS, padding=1, groups=G, deformable_groups=DG,
                offset_bound=bound, device="cuda")
            reset()
            y = mod(x)
            torch.cuda.synchronize()
            launched = counts()
            check(launched[want_kernel] >= 1, f"Pack (bound={bound}) did not launch {want_kernel}")
            check(y.shape == (B, O, H, W) and bool(torch.isfinite(y).all()),
                  f"Pack (bound={bound}) output bad")
            p_off, p_mask = mod.conv_offset(x), mod.conv_mask(x)
            fn, ref_fn = kernels[want_kernel]
            ext = (bound,) if bound is not None else ()
            want = ref_fn(x, p_off, p_mask, mod.weight, mod.bias, spec, MAIN_PRECISION, *ext)
            e = rel_err(y, want)
            print(f"Pack bound={bound}: launches {launched}, rel err {e:.3e}, "
                  f"max|offset| {float(p_off.abs().max()):.3f}")
            check(e <= LIMITS[MAIN_PRECISION], f"Pack (bound={bound}) disagrees")

        # Phase 6: times at config 2, in the main path's precision mode.
        K = KS * KS
        n_bytes = 4 * (x.numel() + off.numel() + mask.numel() + w.numel()
                       + bias.numel() + B * O * H * W)
        n_ops = 2 * B * H * W * O * (C // G) * K
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_OPS[MAIN_PRECISION] * 1e3
        bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
        print(f"cfg2 work: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP; bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} (fp32 FMA rate: "
              f"{n_ops / PEAK_OPS['float32'] * 1e6:.1f} us)")
        dense_ms = time_ms(lambda: torch.nn.functional.conv2d(x, w, bias, 1, 1, 1, G))
        for name, (fn, ref_fn) in kernels.items():
            args = (x, off, mask, w, bias, spec, MAIN_PRECISION, *extra[name])
            ms = time_ms(lambda: fn(*args))
            plain_ms = time_ms(lambda: ref_fn(*args))
            results[name].update(ms=ms, plain_ms=plain_ms)
            print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, dense conv anchor "
                  f"{dense_ms:.4f} ms, bound {bound_ms:.4f} ms)")

    # Phase 7: the kernel table.
    replaces = {"shiftblend_fwd": "modulated_deform_conv_tpu/ops/pallas/shiftblend.py:627",
                "gathermm_fwd": "modulated_deform_conv_tpu/ops/pallas/gathermm.py:1162"}
    table = [{"name": n, "route": "cuda",
              "source": f"modulated_deform_conv_tpu_torch/csrc/{n}.cu",
              "replaces": replaces[n], "launches": main_launches[n],
              "max_abs_err": results[n]["max_abs_err"], "ms": results[n]["ms"],
              "plain_ms": results[n]["plain_ms"], "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "dense_conv_anchor_ms": dense_ms,
              "rel_err": results[n]["rel_err"], "precision": MAIN_PRECISION}
             for n in kernels]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
