"""The control and the planted faults of a cell, on the card at the cell's
own size, over several seeds: the numbers that decide `correct`, and the
verdict under the cell's limits, of

* the control: the reference computed in bfloat16, put in the program's
  place;
* in a training cell, the faults: each step's loss over the first half
  of its batch (in the reference put in the program's place), and the
  program's captured step with a wrong backward of the deformable op
  planted underneath (`program.BACKWARD_FAULTS`);
* with `--sound`, the program as it is, on those seeds: the first steps
  or the forward the benchmark's runs compare.

Every control and fault has to come out not correct; the command exits 1
where one does not.  Their readings set the limits' upper ends, the
sound ones the lower (PERF.md).  The benchmark's runs do not run this.

    python3 dcnbench/control.py --workload <name> --seeds 11,12,13 \\
        [--sound 21,22,...] [--dump <file>]

prints one JSON line a seed and reading; `--dump` appends each training
reading's per-leaf norms (`compare.leaf_table`) to a file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys


def _train_readings(cell, seed, dev, modes, dump):
    from . import compare, harness, program
    data = harness.cell_data(cell, seed, dev)
    n = int(cell.mix["compare"])
    with harness.full_float32():
        ref = harness.reference_steps(data.forward, data.make(), data.pool_x,
                                      data.pool_y, n, data.args)
    for mode in modes:
        if mode in ("control", "half_batch"):
            kw = ({"precision": "bfloat16"} if mode == "control"
                  else {"half_batch": True})
            with harness.full_float32():
                got = harness.reference_steps(
                    data.forward, data.make(), data.pool_x, data.pool_y, n,
                    data.args, **kw)
        else:
            broken = (program.broken_backward(mode) if mode != "sound"
                      else contextlib.nullcontext())
            with broken:
                got = harness.prepare(cell, seed, dev).prog
            if dev.cuda:
                harness.torch.cuda.empty_cache()
        numbers = compare.train_numbers(got, ref, detail=True)
        if dump is not None:
            dump.write(json.dumps({
                "workload": cell.name, "seed": seed, "mode": mode,
                "losses": got["losses"], "ref_losses": ref["losses"],
                "leaves": compare.leaf_table(got, ref)}) + "\n")
            dump.flush()
        yield mode, numbers


def _serve_readings(cell, seed, dev, modes):
    from . import harness
    data = harness.cell_data(cell, seed, dev)
    params = data.make()
    entries = [int(e) for e in data.order[:int(cell.mix["compare"])]]
    for mode in modes:
        if mode == "control":
            with harness.torch.no_grad():
                kept = [(e, data.forward(params, data.pool_x[e],
                                         precision="bfloat16", **data.args))
                        for e in entries]
        else:   # sound: the program's captured forward
            run = harness.prepare(cell, seed, dev)
            kept = [(e, run.step(data.pool_x[e]).cpu()) for e in entries]
            del run
        with harness.full_float32():
            yield mode, harness.serve_numbers(data.forward, params,
                                              data.pool_x, kept, data.args)


def readings(cell, seed: int, dev, modes, dump=None):
    """[(mode, numbers)] of one seed."""
    if cell.mix["kind"] == "train":
        return list(_train_readings(cell, seed, dev, modes, dump))
    return list(_serve_readings(cell, seed, dev, modes))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    from . import compare, harness, program
    ap = argparse.ArgumentParser(prog="dcnbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers: control and faults")
    ap.add_argument("--sound", default="",
                    help="comma-separated seeds of sound readings")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not harness.torch.cuda.is_available():
        print("dcnbench/control.py: needs a CUDA device", file=sys.stderr)
        return 3
    dev = harness.Device("cuda")
    planted = ["control"]
    if cell.mix["kind"] == "train":
        planted += ["half_batch", *program.BACKWARD_FAULTS]
    dump = open(args.dump, "a") if args.dump else None
    passed = []
    try:
        jobs = ([(s, planted) for s in _seeds(args.seeds)]
                + [(s, ["sound"]) for s in _seeds(args.sound)])
        for seed, modes in jobs:
            for mode, numbers in readings(cell, seed, dev, modes, dump):
                ok, checks = compare.verdict(numbers, cell.limits)
                if ok and mode != "sound":
                    passed.append((seed, mode))
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  "mode": mode, "correct": ok,
                                  "checks": checks, "numbers": numbers}),
                      flush=True)
    finally:
        if dump is not None:
            dump.close()
    for seed, mode in passed:
        print(f"dcnbench/control.py: {mode} on seed {seed} came out "
              "correct", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from dcnbench.control import main as _main
    sys.exit(_main(sys.argv[1:]))
