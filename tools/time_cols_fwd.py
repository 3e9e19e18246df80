#!/usr/bin/env python3
"""Time the column forward kernels (gathermm_cols_fwd, gathermm3d_cols_fwd)
on an NVIDIA GPU, by route, at BASELINE config 5's c3, c4 and c5 layers
(B=32) and the 3D columns case (chip_smoke.py's inputs), beside their
bound; and, given the sources of an earlier tree, that tree's kernels on
the same inputs, with a check that all give the same bits.

    python3 tools/time_cols_fwd.py
    python3 tools/time_cols_fwd.py --ptxas   # and ptxas's register report
    python3 tools/time_cols_fwd.py --parent-csrc build/parent/modulated_deform_conv_tpu_torch/csrc
    python3 tools/time_cols_fwd.py --ablations  # and the plane route's variants, ablations
    python3 tools/time_cols_fwd.py --blocks     # and its split over 2x, 4x the blocks

An earlier tree's C entries take the geometry and the precision code alone
(no plan).  Each variant or ablation replaces text of deform_cols_fwd.cuh
in a copy of csrc/ (the library's name hashes its sources, so each copy
builds its own); a variant is another design with the tree's bits, an
ablation leaves out work, gives wrong columns and shows only where time
goes.  Times are CUDA events in "tensorfloat32" (chip_smoke.time_ms), the
split torch.profiler's device time per call.
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

BLEND = "for (int c = 0; c < 4; ++c) v[c] = col_value(src_of(cl, c), pos[c], g.W, pz);"
STORE = "store4(row + cl * KBP"
# Other designs of the plane route, which give the tree's bits.
VARIANTS = {
    "channel loop unrolled 2": [("#pragma unroll 1\n    for (int cl = clane", "#pragma unroll 2\n    for (int cl = clane")],
    "two blocks an SM": [("__launch_bounds__(kColThreads, kIs3D<G> ? 3 : 4)", "__launch_bounds__(kColThreads, 2)")],
}
ABLATIONS = {
    # The blends and the staging without the stores.
    "no stores": [(STORE, "if (v[0] == 1.25e-30f) store4(row + cl * KBP")],
    # The stores (of a value made from the item) without the blends.
    "no blends": [(BLEND, "for (int c = 0; c < 4; ++c) v[c] = __int_as_float(pos[c].i0 + cl);")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", help="csrc/ of an earlier tree, timed beside this one")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas's report of the build")
    ap.add_argument("--ablations", action="store_true",
                    help="time each variant and ablation of the plane route")
    ap.add_argument("--blocks", action="store_true",
                    help="time the plane route aiming at 2x and 4x as many blocks too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_cols_fwd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm, lib
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    names = ["gathermm_cols_fwd", "gathermm3d_cols_fwd"]
    logs = lib.build(names, verbose=args.ptxas)
    for name in names if args.ptxas else ():
        print(f"--- {name}\n" + "\n".join(line for line in logs.get(name, "").splitlines()
                                          if "registers" in line or "spill" in line or "Compiling" in line))
    parent = {}
    if args.parent_csrc:
        tree = lib.CSRC
        lib.CSRC = pathlib.Path(args.parent_csrc).resolve()
        lib.build(names)
        for name in names:
            parent[name] = lib.kernel(name)
            del lib._FUNCS[name]
        lib.CSRC = tree

    def parent_fwd(name, x, off, mask, spec, precision):
        cols = torch.empty((x.shape[1] * spec.tap_count, x.shape[0] * math.prod(spec.out_sizes(x.shape[2:]))),
                           dtype=gm._cols_dtype(precision), device=x.device)
        saved = lib._FUNCS.get(name)
        lib._FUNCS[name] = parent[name]
        try:
            lib.launch(name, x, (x, off, mask, cols),
                       (*gm._cols_geometry(x, spec), lib.PRECISION_CODES[precision]))
        finally:
            if saved is None:
                del lib._FUNCS[name]
            else:
                lib._FUNCS[name] = saved
        return cols

    dev = torch.device("cuda")
    spec2 = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    cases = [(f"cfg5 {layer}", spec2, cs.cfg5_inputs(torch, dev, layer)[:3])
             for layer in ("c3", "c4", "c5")]
    spec3, ins3 = cs.cols3d_inputs(torch, dev)
    cases.append(("3D columns", spec3, ins3[:3]))
    for label, spec, (x, off, mask) in cases:
        name = "gathermm_cols_fwd" if spec.ndim == 2 else "gathermm3d_cols_fwd"
        plan = gm.cols_fwd_plan(spec, x.shape[2:], spec.out_sizes(x.shape[2:]), x.shape[0], x.shape[1])
        runs = {r: (lambda r=r: gm.cols_fwd(x, off, mask, spec, "tensorfloat32", route=r))
                for r in ("plane", "gather")}
        if parent:
            runs["parent"] = lambda: parent_fwd(name, x, off, mask, spec, "tensorfloat32")
        for scale in (0.5, 2, 4) if args.blocks else ():
            def more_blocks(scale=scale):
                saved = gm._COLF_BLOCKS
                gm._COLF_BLOCKS = int(saved * scale)
                try:
                    return gm.cols_fwd(x, off, mask, spec, "tensorfloat32", route="plane")
                finally:
                    gm._COLF_BLOCKS = saved
            runs[f"plane, {scale}x the blocks"] = more_blocks
        same = {}
        for prec in lib.PRECISIONS:
            want = gm.cols_fwd(x, off, mask, spec, prec, route="gather")
            others = {"plane": gm.cols_fwd(x, off, mask, spec, prec, route="plane")}
            if parent:
                others["parent"] = parent_fwd(name, x, off, mask, spec, prec)
            same[prec] = {k: bool(torch.equal(v, want)) for k, v in others.items()}
            del want, others
        cols_numel = x.shape[1] * spec.tap_count * x.shape[0] * math.prod(spec.out_sizes(x.shape[2:]))
        bound, by = cs.bound_of(*cs.cols_work((x, off, mask), cols_numel, 4)["fwd"], "float32")
        print(f"{label}: plan {plan}; bound {bound:.4f} ms ({by}); same bits as the gather route: {same}",
              flush=True)
        for r, fn in runs.items():
            ms = cs.time_ms(fn)
            split = cs.kernel_split(cs.device_time_by_kernel(fn))
            print(f"  {r}: {ms:.4f} ms on events ({ms / bound:.2f}x bound); device " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()), flush=True)
        torch.cuda.empty_cache()
    tree = lib.CSRC
    want = {name: gm.cols_fwd(x, off, mask, spec, "tensorfloat32", route="plane")
            for name, spec, (x, off, mask) in cases} if args.ablations else {}
    for label, edits in {**VARIANTS, **ABLATIONS}.items() if args.ablations else ():
        src = pathlib.Path(tempfile.mkdtemp(dir=lib.BUILD_DIR))
        shutil.copytree(tree, src, dirs_exist_ok=True)
        f = src / "deform_cols_fwd.cuh"
        text = f.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"time_cols_fwd: ablation {label!r} no longer matches the source")
            text = text.replace(old, new)
        f.write_text(text)
        lib.CSRC = src
        lib._FUNCS.clear()
        for name, spec, (x, off, mask) in cases:
            def call():
                return gm.cols_fwd(x, off, mask, spec, "tensorfloat32", route="plane")
            same = bool(torch.equal(call(), want[name]))
            ms = cs.time_ms(call)
            split = cs.kernel_split(cs.device_time_by_kernel(call))
            print(f"[{label}] {name}: {ms:.4f} ms on events (the tree's bits: {same}); device " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    lib.CSRC = tree
    lib._FUNCS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
