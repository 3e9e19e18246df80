#!/usr/bin/env python3
"""Every kernel of this tree against an earlier tree's, on the card: bits
and times of the unsharded launches.

    python3 tools/compare_parent_kernels.py --parent-csrc build/parent/modulated_deform_conv_tpu_torch/csrc

Builds the twelve kernels from both trees' csrc/ (the earlier tree's
unpacked with `git archive`), runs chip_smoke.unsharded_digests (every
kernel at its table row's config, every mode) under each and requires the
same SHA-256 digests, then times each kernel's forward and backward in the
main mode, earlier, this, this, earlier, with CUDA events.  The earlier
tree's entries take no activation type (`io`, the trees before bf16 ran
natively), and its shift-blend entries no output grid and no gate
arguments (the trees before the lead mode): its launches drop them.  Prints
the earlier tree's digests (chip_smoke.PREV_DIGESTS) and writes everything
to chiprun_out/compare_parent_kernels.json.  Needs one NVIDIA GPU.
"""
import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_parent_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
    from modulated_deform_conv_tpu_torch.ops.cuda import lib
    from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
    from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tree = lib.CSRC
    lib.build(lib.KERNELS)
    lib.CSRC = pathlib.Path(args.parent_csrc).resolve()
    lib.build(lib.KERNELS)
    parent = {n: lib.kernel(n) for n in lib.KERNELS}
    lib._FUNCS.clear()
    lib.CSRC = tree
    mine = {n: lib.kernel(n) for n in lib.KERNELS}
    launch = lib.launch

    def use(which):
        lib._FUNCS.clear()
        if which == "parent":
            lib._FUNCS.update(parent)
            def parent_launch(name, x, tensors, ints, floats=(), **kw):
                ints = ints[:-1]                       # the earlier entries take no io
                if name.startswith("shiftblend"):      # ints: *x.shape, O, *OS, ...
                    at = x.ndim + 1
                    ints, floats = ints[:at] + ints[at + x.ndim - 2:], ()
                return launch(name, x, tensors, ints, floats, **kw)
            lib.launch = parent_launch
        else:
            lib._FUNCS.update(mine)
            lib.launch = launch

    use("parent")
    want = cs.unsharded_digests(torch, gm, sb, dev)
    use("mine")
    got = cs.unsharded_digests(torch, gm, sb, dev)
    same = {n: {m: got[n][m] == want[n][m] for m in want[n]} for n in want}
    print("bits, this tree against the earlier one: " + "; ".join(
        f"{n} " + "/".join("same" if s else "DIFFERENT" for s in by.values())
        for n, by in same.items()))

    # Times of each kernel in the main mode: earlier, this, this, earlier.
    spec2 = DeformConvSpec.make(2, cs.KS, 1, 1, 1, cs.G, cs.DG, modulated=True)
    ins2 = cs.cfg2_inputs(torch, dev)
    spec3, ins3 = cs.cfg3d_inputs(torch, dev, "cfg3")
    spec4, ins4 = cs.cfg3d_inputs(torch, dev, "cfg4")
    ins4 = tuple(None if t is None else t[:1].contiguous() for t in ins4)
    spec5 = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    ins5 = cs.cfg5_inputs(torch, dev, "c4")
    specc, insc = cs.cols3d_inputs(torch, dev)
    p = cs.MAIN_PRECISION
    calls = {}
    for fam, fwd, bwd, spec, (x, off, mask, w, b), ext in (
            ("shiftblend", sb.fwd, sb.bwd, spec2, ins2, (cs.BOUND,)),
            ("gathermm", gm.fused_fwd, gm.fused_bwd, spec2, ins2, ()),
            ("gathermm3d", gm.fused_fwd, gm.fused_bwd, spec3, ins3, ()),
            ("shiftblend3d", sb.fwd, sb.bwd, spec4, ins4, (cs.BOUND3D,))):
        gout = torch.randn((x.shape[0], w.shape[0]) + tuple(off.shape[2:]), device=dev)
        calls[f"{fam}_fwd"] = (lambda f=fwd, a=(x, off, mask, w, b, spec, p) + ext: f(*a))
        calls[f"{fam}_bwd"] = (lambda f=bwd, a=(x, off, mask, w, gout, spec, p) + ext: f(*a))
    for fam, spec, (x, off, mask, _, _) in (("gathermm_cols", spec5, ins5),
                                            ("gathermm3d_cols", specc, insc)):
        fwd, bwd = gm.cols_fwd, gm.cols_bwd
        gcols = torch.randn_like(fwd(x, off, mask, spec, p))
        calls[f"{fam}_fwd"] = (lambda f=fwd, a=(x, off, mask, spec, p): f(*a))
        calls[f"{fam}_bwd"] = (lambda f=bwd, a=(x, off, mask, gcols, spec, p): f(*a))
    times = {n: {"parent": [], "this": []} for n in calls}
    for which in ("parent", "this", "this", "parent"):
        use("parent" if which == "parent" else "mine")
        for n, fn in calls.items():
            times[n][which].append(cs.time_ms(fn))
    ratio = {}
    for n, t in times.items():
        ratio[n] = statistics.mean(t["this"]) / statistics.mean(t["parent"])
        print(f"{n}: earlier {t['parent'][0]:.4f} / {t['parent'][1]:.4f} ms, this "
              f"{t['this'][0]:.4f} / {t['this'][1]:.4f} ms ({ratio[n]:.3f}x)")
    print("earlier tree's digests: " + json.dumps(want))
    out = {"device": smi, "same_bits": same, "parent_digests": want, "digests": got,
           "times_ms": times, "ratio": ratio}
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "compare_parent_kernels.json").write_text(json.dumps(out, indent=1))
    return 0 if all(all(by.values()) for by in same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
