"""One run of one cell: set-up, the measured window, the traced window's
reading, and the comparison with the plain reference.

A cell is an entry of BENCHMARK.json's `workloads`.  Its configuration is
the JSON file the entry's config names (the program's class and sizes, the
reference's model, the parameters' init rules), its traffic mix
dcnbench/traffic/<traffic>.json (read by generator.py), its limits
dcnbench/limits/<workload>.json, and each metric it reports is read by
dcnbench/metrics/<metric>.py.  Nothing here names a cell.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from collections import deque
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import compare, generator, traces, weights
from .traces import PREFIX
from .work import MAIN_PRECISION, PEAK_OPS, bound_s

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Seconds of the cell's own steps or requests after the capture, before the
# window opens, counted in set-up: a process's first seconds of replays
# run slower than the rest (PERF.md §6).
WARM_S = 6.0
# Top-level module names that may not be loaded in a run: the JAX stack
# and the JAX package the program was ported from.
BANNED = ("jax", "jaxlib", "flax", "optax", "modulated_deform_conv_tpu")


class BannedModules(RuntimeError):
    pass


def banned_modules(modules=None) -> list:
    """The banned top-level names among the loaded modules, each compared
    whole (the part before the first dot)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


# ---- the cell, found by name -----------------------------------------------

def load_cell(name: str, root: pathlib.Path = ROOT) -> SimpleNamespace:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    here = root / "dcnbench"
    return SimpleNamespace(
        name=name, chips=cell["chips"], root=root,
        config=json.loads((root / entry["file"]).read_text()),
        mix=generator.load(here / "traffic" / f"{cell['traffic']}.json"),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        e2e=e2e, per_layer=layer)


def reader(root: pathlib.Path, metric: str):
    """The metric's reader as a module: dcnbench/metrics/<metric>.py, or,
    where that is missing, the file of the quantity, the name's part
    before its first dot (`dcn_ms.train` and `dcn_ms.infer` read the
    same quantity, and differ only in the end-to-end metric they move).
    `read(ctx)` gives the metric's value, or None where the run has
    nothing to read."""
    here = root / "dcnbench" / "metrics"
    path = here / f"{metric}.py"
    if not path.exists():
        path = here / f"{metric.split('.')[0]}.py"
    mod_name = "dcnbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_model(config: dict):
    """(forward, parameter shapes, args) of the configuration's plain
    reference."""
    ref = config["reference"]
    forward, shapes = importlib.import_module(ref["module"]).MODELS[
        ref["model"]]
    return forward, shapes(**ref["args"]), ref["args"]


@contextlib.contextmanager
def full_float32():
    """float32 products with TF32 off, as the reference computes."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---- the device ------------------------------------------------------------

class Device:
    """The card the run uses (a CPU device runs the same code where the
    tests drive a run without a card: no events, no memory readings)."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(ev):
        if ev is not None:
            ev.synchronize()

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def name(self) -> str:
        return torch.cuda.get_device_name(self.dev) if self.cuda else "cpu"

    def activities(self):
        return ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if self.cuda
                else [ProfilerActivity.CPU])


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power.limit not read"


# ---- the windows -----------------------------------------------------------

def train_window(step, pool_x, pool_y, start, seconds, in_flight, dev,
                 max_steps=None) -> dict:
    """Training steps back to back on the pool's batches from `start`,
    with at most `in_flight` steps dispatched ahead of the device, until
    `seconds` have passed (or `max_steps` were issued); the window ends
    when the device has finished them all."""
    n_pool = pool_x.shape[0]
    issue, pending, n = [], deque(), 0
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < seconds
           and (max_steps is None or n < max_steps)):
        i = (start + n) % n_pool
        with record_function(PREFIX + "issue"):
            t = time.perf_counter()
            step(pool_x[i], pool_y[i])
            issue.append(time.perf_counter() - t)
        pending.append(dev.mark())
        n += 1
        if len(pending) > in_flight:
            with record_function(PREFIX + "wait"):
                dev.wait(pending.popleft())
    with record_function(PREFIX + "drain"):
        dev.sync()
    return {"steps": n, "window_s": time.perf_counter() - t0,
            "issue_s": issue}


def serve_window(step, pool_x, order, start, seconds, keep, dev,
                 max_steps=None) -> dict:
    """One client, closed loop: each request, as soon as the one before it
    is back, has its input copied in, the forward replayed and the logits
    read back to the host, until `seconds` have passed (or `max_steps`
    requests were served).  The requests take the pool's entries in
    `order`, cycled, from its `start`th.  Keeps the logits of the
    requests on the entries in `keep`; counts the requests whose logits
    are not finite."""
    issue, kept, bad = [], [], 0
    t0 = time.perf_counter()
    n = 0
    while (time.perf_counter() - t0 < seconds
           and (max_steps is None or n < max_steps)):
        entry = int(order[(start + n) % len(order)])
        with record_function(PREFIX + "issue"):
            t = time.perf_counter()
            out = step(pool_x[entry])
            issue.append(time.perf_counter() - t)
        with record_function(PREFIX + "readback"):
            logits = out.cpu()
        bad += not bool(torch.isfinite(logits).all())
        if entry in keep:
            kept.append((entry, logits))
        n += 1
    return {"steps": n, "window_s": time.perf_counter() - t0,
            "issue_s": issue, "kept": kept, "bad": bad}


# ---- the traced run's look inside the deformable op ------------------------

def probe(program, fn, inputs, dev) -> dict:
    """One eager call of the cell's step under the profiler with the
    deformable ops fenced: each device operation's share inside the op,
    and each op call's work and sampling statistics."""
    calls = []
    with profile(activities=dev.activities()) as prof:
        with program.fenced_ops(calls):
            fn(*inputs)
        dev.sync()
    return {"share": traces.dcn_share(traces.events(prof)), "calls": calls}


def forward_flops(forward, shapes, args, sample_shape, batch) -> int:
    """The model's forward operations for one batch, counted from shapes
    by the reference run on meta tensors."""
    flops = []
    params = {n: torch.empty(s, device="meta") for n, s in shapes}
    with torch.no_grad():
        forward(params, torch.empty((batch,) + tuple(sample_shape),
                                    device="meta"), flops=flops, **args)
    return sum(flops)


# ---- one run -----------------------------------------------------------------

def cell_data(cell, seed: int, dev: Device) -> SimpleNamespace:
    """What the seed makes for a cell, the same for the program and the
    reference: the parameters (`make()` draws them anew, the same each
    time), the pool of inputs on the device, and the order in which a
    serving cell's requests take the pool's entries."""
    forward, shapes, args = reference_model(cell.config)
    s_w, s_pool, s_order = weights.sub_seeds(seed, 3)
    pool_x, pool_y = generator.make_pool(cell.mix, args["num_classes"],
                                         s_pool, dev.dev)
    return SimpleNamespace(
        forward=forward, shapes=shapes, args=args, pool_x=pool_x,
        pool_y=pool_y, order=generator.order(cell.mix, s_order),
        make=lambda: weights.make_params(shapes, cell.config["init"], s_w,
                                         dev.dev))


def prepare(cell, seed: int, dev: Device, trace: bool = False):
    """The run's set-up, as the window finds it: the seed's data, the
    program's network with the seed's parameters, its optimizer (training),
    the traced eager look inside the deformable ops (`trace`), the
    captured step, and, in a training cell, the captured step's first
    `compare` steps from the seed, which the reference follows.  Returns
    the pieces and the set-up's stages, [(name, time.perf_counter())]."""
    from . import program   # the program under test, imported here
    stages = [("imports", time.perf_counter())]
    if dev.cuda:
        program.build_kernels()
    stages.append(("kernels", time.perf_counter()))
    mix, cfg = cell.mix, cell.config
    train = mix["kind"] == "train"
    data = cell_data(cell, seed, dev)
    net = program.model(cfg["program"], dev.dev)
    program.load(net, data.make())
    opt = program.optimizer(net) if train else None
    fn = program.train_fn(net, opt) if train else program.serve_fn(net)
    inputs = ((data.pool_x[0], data.pool_y[0]) if train
              else (data.pool_x[0],))
    stages.append(("model and inputs", time.perf_counter()))
    looked = probe(program, fn, inputs, dev) if trace else None
    stages.append(("traced eager step", time.perf_counter()))
    step = program.capture(fn, *inputs)
    stages.append(("warm-up and capture", time.perf_counter()))
    prog = None
    if train:
        # The warm-up and the look trained; start the captured step from
        # the seed.
        program.load(net, data.make())
        program.reset_optimizer(opt)
        prog = first_steps(step, net, opt, data.pool_x, data.pool_y,
                           int(mix["compare"]), data.make)
    stages.append(("first steps", time.perf_counter()))
    return SimpleNamespace(data=data, net=net, opt=opt, fn=fn, step=step,
                           looked=looked, prog=prog, stages=stages)


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda") -> dict:
    """Set up the cell from the seed, measure its window (traced or not),
    then hold what the timed path produced against the reference.  Returns
    {"result": the last line's object, "notes": lines for stderr}."""
    dev = Device(device)
    mix, cfg = cell.mix, cell.config
    train = mix["kind"] == "train"
    n_cmp = int(mix["compare"])
    run_ = prepare(cell, seed, dev, trace)
    data, step, stages = run_.data, run_.step, run_.stages
    pool_x, pool_y = data.pool_x, data.pool_y
    keep = set() if train else {int(e) for e in data.order[:n_cmp]}

    def window(max_steps, start, seconds=seconds, kept=keep):
        with record_function(PREFIX + "window"):
            if train:
                return train_window(step, pool_x, pool_y, start, seconds,
                                    mix["in_flight"], dev, max_steps)
            return serve_window(step, pool_x, data.order, start, seconds,
                                kept, dev, max_steps)

    # Training starts past the steps the reference follows; WARM_S of
    # replays come first, in set-up.
    first = n_cmp if train else 0
    first += window(None, first, WARM_S, set())["steps"]
    stages.append(("warm replays", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    notes = ["setup: " + ", ".join(
        f"{name} {b - a:.2f} s" for (_, a), (name, b) in
        zip([("start", t0)] + stages[:-1], stages))]

    # The traced run times `trace_steps` steps on the host clock first,
    # then traces as many: the profiler slows the host's graph launches.
    n_part = mix["trace_steps"] if trace else None
    win = window(n_part, first)
    traced, prof = None, None
    if trace:
        with profile(activities=dev.activities()) as prof:
            traced = window(n_part, first + win["steps"])
    dev.sync()
    peak = dev.peak_bytes()
    found = banned_modules()
    if found:
        raise BannedModules(f"loaded in the run: {', '.join(found)}")
    parts = [win] + ([traced] if traced else [])
    notes.append(f"host: {1e3 * sum(win['issue_s']) / max(1, win['steps']):.4f}"
                 f" ms a step in CapturedStep.__call__ over {win['steps']}")
    # A step whose loss is not finite, a request whose logits are not.
    failed = (int(not math.isfinite(float(step.outputs))) if train
              else sum(p["bad"] for p in parts))
    attempted = sum(p["steps"] for p in parts)

    ctx = SimpleNamespace(
        kind=mix["kind"], batch=mix["batch"], setup_s=setup_s,
        memory_peak_bytes=peak, steps=win["steps"],
        window_s=win["window_s"], issue_s=win["issue_s"], trace=None,
        trace_steps=None, dcn_share={}, dcn_bound_s=None,
        flops_per_step=None, peak_flops=PEAK_OPS[MAIN_PRECISION])
    breakdown = None
    if trace:
        looked = run_.looked
        tw = traces.window(traces.events(prof))
        fwd = forward_flops(data.forward, data.shapes, data.args,
                            mix["sample"], mix["batch"])
        ctx.trace, ctx.dcn_share = tw, looked["share"]
        ctx.trace_steps = traced["steps"]
        ctx.flops_per_step = 3 * fwd if train else fwd
        ctx.dcn_bound_s = sum(
            bound_s(*c["work"][d]) for c in looked["calls"]
            for d in (("fwd", "bwd") if train else ("fwd",)))
        breakdown = {"device_ops": traces.top(tw["by_name"]),
                     "idle_gaps": traces.top(tw["idle_by_host"])}
        notes += offset_notes(looked["calls"], cfg)
    prog = run_.prog
    del run_, step
    if dev.cuda:
        torch.cuda.empty_cache()

    with full_float32():
        if train:
            ref = reference_steps(data.forward, data.make(), pool_x, pool_y,
                                  n_cmp, data.args)
            numbers = compare.train_numbers(prog, ref, detail=True)
        else:
            numbers = serve_numbers(data.forward, data.make(), pool_x,
                                    [k for p in parts for k in p["kept"]],
                                    data.args)
    notes.append("numbers: " + json.dumps(numbers))
    correct, checks = compare.verdict(numbers, cell.limits)
    correct = correct and attempted > 0 and failed == 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.e2e):
        value = reader(cell.root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.cuda else "cpu",
                   "kind": dev.name(), "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=ctx.trace["busy_s"],
                           window_s=ctx.trace["window_s"])
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "notes": notes}


def first_steps(step, net, opt, pool_x, pool_y, n, make) -> dict:
    """The captured step's first n steps, on the pool's first n batches:
    each loss, the first gradient as AdamW holds it after one step (its
    first moment over 1 - beta1), and each leaf's change over the n; the
    tensors copied to the host, where they wait for the reference."""
    names = {p: k for k, p in net.named_parameters()}
    beta1 = opt.param_groups[0]["betas"][0]
    losses, grad = [], None
    for i in range(n):
        losses.append(float(step(pool_x[i], pool_y[i])))
        if i == 0:
            grad = {names[p]: (s["exp_avg"] / (1 - beta1)).cpu()
                    for p, s in opt.state.items() if "exp_avg" in s}
    start = make()
    delta = {k: (p.detach() - start[k]).cpu()
             for k, p in net.named_parameters()}
    return {"losses": losses, "grad": grad, "delta": delta}


def reference_steps(forward, params, pool_x, pool_y, n, args,
                    precision="float32", half_batch=False) -> dict:
    from .reference.backbone import train_steps
    out = train_steps(forward, params,
                      [(pool_x[i], pool_y[i]) for i in range(n)],
                      precision=precision, half_batch=half_batch, **args)
    return {"losses": out["losses"], "grad": out["first_grad"],
            "delta": out["delta"]}


def serve_numbers(forward, params, pool_x, kept, args,
                  precision="float32") -> dict:
    """logit_gap over every kept request, the reference run once per pool
    entry."""
    refs = {}
    with torch.no_grad():
        for entry in sorted({e for e, _ in kept}):
            refs[entry] = forward(params, pool_x[entry], precision=precision,
                                  **args)
    gaps = [compare.logit_gap(l, refs[e]) for e, l in kept]
    worst = (max(gaps) if gaps and all(map(math.isfinite, gaps))
             else math.inf)
    return {"logit_gap": worst, "compared": len(gaps)}


def offset_notes(calls, cfg) -> list:
    """The sampling the seed's predictors give, per deformable layer."""
    if not calls:
        return []
    std = [c["offset_std"] for c in calls]
    big = [c["offset_absmax"] for c in calls]
    mstd = [c["mask_std"] for c in calls if c["mask_std"] is not None]
    return [f"offsets (predictor scale {cfg.get('assumed', {}).get('predictor_scale')}): "
            f"std {min(std):.3f}-{max(std):.3f} px over {len(calls)} layers, "
            f"largest |offset| {max(big):.2f} px; mask std "
            f"{min(mstd, default=0):.3f}-{max(mstd, default=0):.3f}"]


# ---- the command -----------------------------------------------------------

def parse(argv):
    ap = argparse.ArgumentParser(prog="dcnbench/run.py",
                                 description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"dcnbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), t0)
    except BannedModules as e:
        print(f"dcnbench: {e}", file=sys.stderr)
        return 4
    found = banned_modules()
    if found:
        print(f"dcnbench: loaded in the run: {', '.join(found)}",
              file=sys.stderr)
        return 4
    res = out["result"]
    card = power_limit()
    notes = out["notes"] + [f"card: {card}"]
    if args.trace:
        notes += [f"{k} {v['value']} {v['unit']} (peaks: HBM 3.35 TB/s, "
                  f"TF32 495 TFLOP/s; {card})"
                  for k, v in res["metrics"].items() if v["unit"] == "%"]
    notes += [f"check {k} {c['value']} limit {c['limit']}"
              for k, c in res["checks"].items()]
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0
