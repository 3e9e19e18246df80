#!/usr/bin/env python3
"""Time the column backward kernels (gathermm_cols_bwd, gathermm3d_cols_bwd)
on an NVIDIA GPU, whole and by sub-kernel, at BASELINE config 5's c4 and c5
layers and the 3D columns case (chip_smoke.py's inputs), and the same for
ablations of csrc/deform_cols_bwd.cuh built from edited copies of the
sources.

    python3 tools/time_cols_bwd.py             # the tree's kernels
    python3 tools/time_cols_bwd.py --ablations # and each ablation below

Each ablation replaces text of deform_cols_bwd.cuh in a copy of csrc/ (the
library's name hashes its sources, so each copy builds its own); one that
leaves out work gives wrong gradients and shows only where time goes.
Times are CUDA events in "tensorfloat32" (chip_smoke.time_ms), the split
is torch.profiler's device time per call.
"""
import argparse
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

APPLY = "    if (applier) {\n      // Each owner"
CORR = "    if (corr) {\n      // The owned"
GATHER = "cp_async4(drow + ((((c >> 2) ^ s7) << 2) | (c & 3)), reinterpret_cast<const float*>(ok ? src : gcol), ok);"
ABLATIONS = {
    # Staging only: the tables, x and the gcols values, nothing applied.
    "stage only": [(APPLY, "    if (false) {\n      //"), (CORR, "    if (false) {\n      //")],
    # The work without the gcols reads: a value made from the entry instead.
    "no gather loads": [(GATHER, "drow[(((c >> 2) ^ s7) << 2) | (c & 3)] = ok ? h * 1e-9f : 0.f;")],
    "no correlation": [(CORR, "    if (false) {\n      //")],
    "no apply": [(APPLY, "    if (false) {\n      //")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ablations", action="store_true", help="time each ablation too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_cols_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm, lib
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

    dev = torch.device("cuda")
    spec2 = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    cases = [(f"cfg5 {layer}", spec2, cs.cfg5_inputs(torch, dev, layer)[:3], gm.cols_bwd)
             for layer in ("c4", "c5")]
    spec3, ins3 = cs.cols3d_inputs(torch, dev)
    cases.append(("3D columns", spec3, ins3[:3], gm.cols_bwd))
    gen = torch.Generator(device=dev).manual_seed(2)
    gcols = []
    for _, spec, (x, off, mask), _ in cases:
        shape = (x.shape[1] * spec.tap_count, x.shape[0] * math.prod(spec.out_sizes(x.shape[2:])))
        gcols.append(torch.randn(shape, generator=gen, device=dev))
    variants = [("tree", None)] + (list(ABLATIONS.items()) if args.ablations else [])
    tree = lib.CSRC
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for label, edits in variants:
        if edits is not None:
            lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src = pathlib.Path(tempfile.mkdtemp(dir=lib.BUILD_DIR))
            shutil.copytree(tree, src, dirs_exist_ok=True)
            f = src / "deform_cols_bwd.cuh"
            text = f.read_text()
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"time_cols_bwd: ablation {label!r} no longer matches the source")
                text = text.replace(old, new)
            f.write_text(text)
            lib.CSRC = src
            lib._FUNCS.clear()
        for (name, spec, (x, off, mask), bwd), g in zip(cases, gcols):
            def call():
                return bwd(x, off, mask, g, spec, "tensorfloat32")
            ms = cs.time_ms(call)
            split = cs.kernel_split(cs.device_time_by_kernel(call))
            print(f"[{label}] {name}: {ms:.4f} ms on events; " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
