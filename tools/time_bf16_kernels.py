#!/usr/bin/env python3
"""Time the twelve kernels' wrappers on bf16 activations against the same
call on fp32 copies, on an NVIDIA GPU, at the case chip_smoke.py's bf16
phase times each kernel table row at (chip_smoke.BF16_ROW_CASES), and the
column kernels at config 5 c5 too, whose 7 x 7 planes (49 values) a bf16
block stages 2 bytes a copy.

    python3 tools/time_bf16_kernels.py
    python3 tools/time_bf16_kernels.py --no-split   # CUDA events only

Each call is timed bf16, fp32, bf16 (CUDA events, chip_smoke.time_ms, in
"tensorfloat32"), so that the two bf16 samples show the drift between
samples; then, unless --no-split, torch.profiler's device time per call by
kernel for both types.
"""
import argparse
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-split", action="store_true",
                    help="skip the per-kernel device times from torch.profiler")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_bf16_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm, lib
    from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib.build(lib.KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    prec = cs.MAIN_PRECISION
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(12)
    cases = cs.bf16_cases(torch, gm, sb, dev)
    spec5 = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    c5 = [t.to(bf) if i < 3 else t for i, t in enumerate(cs.cfg5_inputs(torch, dev, "c5"))]
    cases["cfg5 c5"] = (spec5, c5, None, "gathermm_cols", ())
    rows = dict(cs.BF16_ROW_CASES)
    rows.update({"gathermm_cols_fwd c5": "cfg5 c5", "gathermm_cols_bwd c5": "cfg5 c5"})

    def show(split):
        return "; ".join(f"{k[:60]} {v:.4f}" for k, v in split.items())

    for row, label in rows.items():
        spec, ins, _, fam, extra = cases[label]
        name = row.split()[0]
        kind = name.rsplit("_", 1)[1]
        fn = next(f for f in (gm.fused_fwd, gm.fused_bwd, gm.cols_fwd, gm.cols_bwd, sb.fwd, sb.bwd)
                  if cs.entry_of(f, spec.ndim) == name)
        up = [lib.as_f32(t) for t in ins]
        OS = tuple(ins[1].shape[2:])
        with torch.no_grad():
            if fam.endswith("_cols"):
                cshape = (ins[0].shape[1] * spec.tap_count, ins[0].shape[0] * math.prod(OS))
                gc = torch.randn(cshape, generator=g, device=dev).to(gm._cols_dtype(prec))
                calls = ((lambda a: fn(*a[:3], spec, prec)) if kind == "fwd" else
                         (lambda a: fn(*a[:3], gc, spec, prec)))
            else:
                cot = torch.randn((ins[0].shape[0], ins[3].shape[0]) + OS, generator=g,
                                  device=dev).to(bf)
                cots = {bf: cot, torch.float32: cot.float()}
                calls = ((lambda a: fn(*a, spec, prec, *extra)) if kind == "fwd" else
                         (lambda a: fn(*a[:4], cots[a[0].dtype], spec, prec, *extra)))
            ms = [cs.time_ms(lambda: calls(ins)), cs.time_ms(lambda: calls(up)),
                  cs.time_ms(lambda: calls(ins))]
            print(f"{row} at {label} ({prec}): bf16 {ms[0]:.4f} ms, fp32 {ms[1]:.4f} ms, "
                  f"bf16 again {ms[2]:.4f} ms", flush=True)
            for typ, a in (("bf16", ins), ("fp32", up)) if not args.no_split else ():
                print(f"  {typ} device time by kernel: "
                      + show(cs.kernel_split(cs.device_time_by_kernel(lambda: calls(a)))), flush=True)
        del up
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
