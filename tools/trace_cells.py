#!/usr/bin/env python3
"""Read a benchmark cell's step from inside: the program's own spans
(`utils/profiling.py`) on the cell's captured step, on an NVIDIA GPU.

    python3 tools/trace_cells.py --workload r50-imagenet-train --seed 7 \
        [--pairs 3] [--pair-seconds 4] [--out FILE]

Sets the cell up as `dcnbench/run.py` does (`harness.prepare`: the seed's
weights and pool, the untraced captured step, its warm replays), captures
the step again under `profiling.tracing(True)` and replays it for a second,
times the untraced step for the traffic's `trace_steps` steps, then runs the
cell's own window loop on the traced step:

  (c) `trace_steps` steps without the profiler: the device spans each
      replay stamped (`CapturedStep.spans()`) and the host's
      "mdc.step.replay" spans (`profiling.host_spans`);
  (d) `trace_steps` steps under torch.profiler: the device's idle time
      while the host is inside "mdc.step.replay", on the profiler's clock,
      and the clock check (`profiling.clock_offsets`: each mark kernel the
      trace holds against the `%globaltimer` it stored, and the rate
      between the two clocks).

Then the cost of the marks: `--pairs` windows of `--pair-seconds` each of
the untraced and the traced step, in turns (off, on, on, off, ...), and
the floor of a mark: empty spans back to back in a captured graph and
eagerly, and `%globaltimer`'s resolution.  Prints a JSON object as the last
line (and writes it to `--out`).  The metrics, per step or request:

  device_step_ms   mean "mdc.step" duration a replay, (c)
  dcn_span_ms      mean summed "mdc.dcn.fwd" + "mdc.dcn.bwd" a replay, (c)
  optimizer_ms     mean "mdc.train.optimizer" a replay, (c) (training)
  launch_ms        mean host "mdc.step.replay" a step, (c)
  replay_idle_ms   device idle inside "mdc.step.replay" a step, (d)

and `stage_ms`: the mean "mdc.model.<stage>" span a replay, by stage, (c),
where the model marks its stages (DCNResNet3d: stem, c2 .. c5).
"""
import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# Warm replays of the traced step before (c): a new graph's first replays
# run slower, as the harness's WARM_S says of a process's.
TRACED_WARM_S = 1.0


def window(cell, step, data, dev, start, steps=None, seconds=math.inf):
    """The cell's own window loop (`harness.train_window` /
    `serve_window`) inside the benchmark's window span."""
    from torch.profiler import record_function

    from dcnbench import harness
    from dcnbench.traces import PREFIX
    mix = cell.mix
    with record_function(PREFIX + "window"):
        if mix["kind"] == "train":
            return harness.train_window(step, data.pool_x, data.pool_y,
                                        start, seconds, mix["in_flight"], dev,
                                        steps)
        return harness.serve_window(step, data.pool_x, data.order, start,
                                    seconds, set(), dev, steps)


def overlap(intervals, windows) -> float:
    """Length of the intervals' parts that lie inside the windows (neither
    list overlapping itself)."""
    total, j = 0.0, 0
    windows = sorted(windows)
    for a, b in sorted(intervals):
        while j < len(windows) and windows[j][1] <= a:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < b:
            total += max(0.0, min(b, windows[k][1]) - max(a, windows[k][0]))
            k += 1
    return total


def per_replay(spans):
    """{replay: {name: summed duration in ms}}."""
    out = defaultdict(lambda: defaultdict(float))
    for s in spans:
        out[s["replay"]][s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e6
    return out


def mean(xs):
    return statistics.fmean(xs) if xs else None


STAGE = "mdc.model."


def stage_ms(reps) -> dict:
    """{stage: mean ms a replay} of the model's stage spans ("mdc.model.*")
    over the replays `reps` ({name: summed ms}, as `per_replay` gives); a
    replay without a stage's span counts 0 for it."""
    names = sorted({k for r in reps for k in r if k.startswith(STAGE)})
    return {k[len(STAGE):]: mean([r.get(k, 0.0) for r in reps])
            for k in names}


def floor_of_a_mark(dev) -> dict:
    """Empty spans back to back: 64 in a captured graph (20 replays), and
    200 eager ones; `%globaltimer`'s steps."""
    import torch

    from modulated_deform_conv_tpu_torch.utils import graphs, profiling
    z = torch.zeros(1, device=dev)

    def empties():
        for _ in range(64):
            with profiling.span("mdc.empty", z):
                pass
        return z

    with profiling.tracing(True):
        step = graphs.capture(empties)
        for _ in range(20):
            step()
        graph_ns = [s["end_ns"] - s["start_ns"] for s in step.spans()
                    if s["name"] == "mdc.empty"]
        for _ in range(200):
            with profiling.span("mdc.empty.eager", z):
                pass
    eager_ns = [s["end_ns"] - s["start_ns"] for s in profiling.spans()
                if s["name"] == "mdc.empty.eager"]
    ticks = profiling.clock_steps(dev, 64)
    steps = [b - a for a, b in zip(ticks, ticks[1:])]
    return {"empty_span_graph_ns": {"median": statistics.median(graph_ns),
                                    "min": min(graph_ns),
                                    "max": max(graph_ns)},
            "empty_span_eager_ns": {"median": statistics.median(eager_ns),
                                    "min": min(eager_ns),
                                    "max": max(eager_ns)},
            "globaltimer_step_ns": {"min": min(steps),
                                    "median": statistics.median(steps),
                                    "max": max(steps)}}


def measure(name: str, seed: int, pairs: int, pair_s: float) -> dict:
    import torch
    from torch.profiler import profile

    from dcnbench import harness, program, traces
    from modulated_deform_conv_tpu_torch.utils import profiling

    cell = harness.load_cell(name)
    mix = cell.mix
    train = mix["kind"] == "train"
    dev = harness.Device("cuda")
    torch.cuda.reset_peak_memory_stats()
    run_ = harness.prepare(cell, seed, dev)
    data, n = run_.data, int(mix["trace_steps"])
    inputs = ((data.pool_x[0], data.pool_y[0]) if train
              else (data.pool_x[0],))
    pos = [int(mix["compare"]) if train else 0]

    def win(step, steps=None, seconds=math.inf):
        w = window(cell, step, data, dev, pos[0], steps, seconds)
        pos[0] += w["steps"]
        return w

    def rate(w):
        return w["steps"] * mix["batch"] / w["window_s"]

    win(run_.step, seconds=harness.WARM_S)
    peak = dev.peak_bytes()
    with profiling.tracing(True):
        traced = program.capture(run_.fn, *inputs)
        done = win(traced, seconds=TRACED_WARM_S)["steps"]
    untraced = win(run_.step, n)
    with profiling.tracing(True):
        h0 = time.perf_counter_ns()
        c = win(traced, n)
        h1 = time.perf_counter_ns()
        with profile(activities=dev.activities()) as prof:
            d = win(traced, n)
    host = defaultdict(list)
    for s in profiling.host_spans():
        if h0 <= s["start_ns"] and s["end_ns"] <= h1:
            host[s["name"]].append((s["end_ns"] - s["start_ns"]) / 1e6)
    c_rows = range(done, done + c["steps"])
    d_rows = range(done + c["steps"], done + c["steps"] + d["steps"])
    spans = traced.spans()
    by = per_replay(s for s in spans if s["replay"] in c_rows)
    reps = [by[r] for r in c_rows]
    step_ms = [r["mdc.step"] for r in reps]
    dcn_ms = [r["mdc.dcn.fwd"] + r["mdc.dcn.bwd"] for r in reps]
    host_step_ms = 1e3 * c["window_s"] / c["steps"]

    evs = traces.events(prof)
    (lo, hi), = traces.spans(evs, traces.PREFIX + "window")
    busy = [(a, b) for _, a, b in traces.device_ops(evs) if lo <= a <= hi]
    idle = traces.gaps(busy, lo, hi)
    replay_spans = traces.spans(evs, "mdc.step.replay")
    clock = profiling.clock_offsets(
        evs, [(r, row) for r, row in traced.record.marks() if r in d_rows])
    del clock["offsets_ns"], clock["ts_ns"]
    tw = traces.window(evs)

    metrics = {
        "device_step_ms": mean(step_ms),
        "dcn_span_ms": mean(dcn_ms),
        "launch_ms": mean(host["mdc.step.replay"]),
        "replay_idle_ms": 1e-3 * overlap(idle, replay_spans) / d["steps"],
    }
    if train:
        metrics["optimizer_ms"] = mean([r["mdc.train.optimizer"]
                                        for r in reps])
    layers = {k: mean([r[k] for r in reps])
              for k in sorted({k for r in reps for k in r})}
    checks = {
        "host_step_ms_c": host_step_ms,
        "copy_in_ms_c": mean(host["mdc.step.copy_in"]),
        "device_step_over_host_step": mean(step_ms) / host_step_ms,
        "untraced_rate": rate(untraced),
        "traced_rate_c": rate(c),
        "device_idle_pct_d": 100 * (1 - tw["busy_s"] / tw["window_s"]),
        "idle_gaps_d": traces.top(tw["idle_by_host"], 6),
        "marks_a_step": traced.record.width,
        "replay_spans_d": len(replay_spans),
    }
    if train:
        checks["train_sum_over_step"] = mean(
            [(r["mdc.train.forward"] + r["mdc.train.backward"]
              + r["mdc.train.optimizer"]) / r["mdc.step"] for r in reps])

    # The marks' cost: the untraced and the traced step in turns.
    cost = {"off": [], "on": []}
    for i in range(pairs):
        order = ("off", "on") if i % 2 == 0 else ("on", "off")
        for label in order:
            with profiling.tracing(label == "on"):
                w = win(traced if label == "on" else run_.step,
                        seconds=pair_s)
            cost[label].append(rate(w))
    if pairs:
        cost["on_over_off"] = (statistics.median(cost["on"])
                               / statistics.median(cost["off"]))
    return {"workload": name, "seed": seed, "steps": [c["steps"], d["steps"]],
            "metrics": metrics, "stage_ms": stage_ms(reps),
            "layers_ms": layers, "checks": checks,
            "clock": clock, "cost": cost, "peak_mem_gib": peak / 2 ** 30,
            "floor": floor_of_a_mark(dev.dev)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--pair-seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_cells: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"card": card, **measure(args.workload, args.seed, args.pairs,
                                   args.pair_seconds)}
    line = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
