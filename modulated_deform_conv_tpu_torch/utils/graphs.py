"""The compiled step: a whole step captured once as a CUDA graph, then
replayed.

The port's counterpart of the JAX package's `jax.jit` around its steps
(examples/train_dcn_resnet.py's `train_step`, examples/smoke.py, bench.py,
calibrate.py): where XLA compiles a step into one program that the host
dispatches once, `capture` records every launch of one call of a step
(the hand-written kernels, cuBLAS and cuDNN, the optimizer's update) into
a `torch.cuda.CUDAGraph`, and each call of the returned `CapturedStep`
replays them with one launch from the host.  It follows PyTorch's
whole-network recipe: a few warm-up calls on a side stream, then the
capture into a private memory pool.

A step is captured on the card only.  `capture` raises on CPU tensors or
without a CUDA device (a caller who wants the CPU calls the function
itself), and raises with the failing operation's message where the
capture fails: no path falls back to eager.

Three hazards of capturing the port's kernels:

* The kernels are built by `nvcc` and loaded at first use
  (ops/cuda/lib.py, `kernel`).  That must happen in the warm-up, never
  inside the capture: a build there would run on the host while the
  stream records, and its first launch would load the module.  The
  warm-up calls run every launch of the step first.
* The autotune knobs (`gathermm._COLF_ROUTE_OVERRIDE`,
  `gathermm._COLF_BLOCKS_OVERRIDE`, set by utils/autotune.py) and the
  device profile are process-wide values read when a wrapper is called.
  A graph keeps the route and the plan it was captured with: after a
  change of either, capture the step again.
* The wrappers' workspaces (xt, split parts, gcols, the column tables)
  come from `torch.empty` at call time, sized from the shapes alone, so
  under capture they come from the graph's private pool and keep their
  addresses on every replay.  New shapes need a new capture: a step
  refuses an input whose shape, type or device is not its capture's.

The launch table (ops/cuda/lib.py, `counts`) counts in Python, so it
moves in the warm-up and once at the capture, never on a replay:
`CapturedStep.kernels` holds the launches the capture added, by C entry,
the kernels the graph holds, and `CapturedStep.values` the values of the
launches that count them: the AdamW update's values updated, the column
forward's column values written, the GroupNorm forward's values
normalised.

`debug_check_bounds` cannot read its check on the host inside a capture.
There the op records the check on the device instead (ops/bounds.py, into
the `BoundsRecord` that `capture` opens and the captured step owns), and
`CapturedStep.read` reads the flags with the value the caller reads anyway
(the loss), in one copy, and gives the warning an eager call gives.

With the program's spans on (`utils/profiling.py::tracing`) at the
capture, `capture` wraps the captured call in the span "mdc.step" and
records every span inside it (the trainer's, the deformable ops') into a
`StepRecord`: a ring of RING_ROWS replays on the device, allocated before
the capture, outside the graph's pool, each mark a node of the graph.
`CapturedStep.spans()` reads it.  The warm-up's last call counts the
marks a call makes, which sizes the ring's rows.  With the spans off the
graph holds no mark and no ring is allocated.  A call of the step, with
the spans on, also records the host spans "mdc.step.copy_in",
"mdc.step.replay" and "mdc.step.read" (`profiling.annotate`).

`time_chain` times a step the way the JAX package's calibrate.py
(`_chain` / `_amortized`) and utils/autotune.py (`_time_differenced`)
do: two captured chains of the step, n_lo and n_hi calls back to back,
replayed in turns, the step's time the difference over n_hi - n_lo.  The
host issues one replay per chain, so its dispatch cost, and each replay's
own launch, cancel out; what is left is the device's time for a step.
calibrate.py and utils/autotune.py time with it, and with nothing else.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, List

import torch

from ..ops import bounds as bounds_check
from ..ops.cuda import lib
from . import profiling


# Eager calls of a step before its capture: every kernel is built and
# loaded, and every workspace shape allocated once, outside the capture.
WARMUP = 3

# The chain timer's chain lengths and samples.  The JAX package chains 2
# and 10 steps in calibrate.py and 1 and 7 in autotune to amortise its
# host; a replay has no host in it, so short chains suffice.  A timing
# costs WARMUP * (N_LO + N_HI) eager steps (the two captures) and
# (SAMPLES + 1) * (N_LO + N_HI) replayed ones: `calibrate --repeat 3`
# stays well inside one 900 s call with the build.
N_LO, N_HI, SAMPLES = 1, 4, 7


def _check_outputs(out) -> None:
    """A captured step returns a tensor or a tuple / list of tensors (or
    None)."""
    if isinstance(out, torch.Tensor) or (
            isinstance(out, (tuple, list))
            and all(t is None or isinstance(t, torch.Tensor) for t in out)):
        return
    raise TypeError("a captured step returns a tensor or a tuple / list of "
                    f"tensors (or None), got {type(out).__name__}")


class CapturedStep:
    """A step captured as a CUDA graph.  `step(*inputs)` copies each input
    into the static input of its position (`copy_`), replays the graph and
    returns the static outputs: the next call overwrites them, so copy
    what must outlive it.  `step()` replays on the static inputs as they
    are.

    Attributes: `inputs` (the static inputs), `outputs` (the static
    outputs, in the structure the function returned), `kernels` (launches
    of each hand-written kernel the graph holds), `values` (the values
    each kernel that counts them handles a replay: the AdamW update's, the
    column forward's and the GroupNorm forward's engagement check),
    `bounds` (the `debug_check_bounds` checks captured), `capture_s` (the
    warm-up and the capture, on the host clock), `record` (the spans'
    `StepRecord`, None where the spans were off at the capture)."""

    def __init__(self, graph, inputs, outputs, kernels, bounds, capture_s,
                 record=None, values=None):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.kernels, self.bounds, self.capture_s = kernels, bounds, capture_s
        self.record, self.values = record, values or {}

    def __call__(self, *inputs):
        if not profiling.enabled():
            if inputs:
                self._copy_in(inputs)
            self.graph.replay()
            return self.outputs
        if inputs:
            with profiling.annotate("mdc.step.copy_in"):
                self._copy_in(inputs)
        with profiling.annotate("mdc.step.replay"):
            self.graph.replay()
        return self.outputs

    def _copy_in(self, inputs) -> None:
        """Copy each input into its static input, refusing another shape,
        type or device."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"the step takes {len(self.inputs)} inputs, "
                             f"got {len(inputs)}")
        # copy_ would broadcast a shape and cast a type without a word.
        for i, (static, new) in enumerate(zip(self.inputs, inputs)):
            if not (isinstance(new, torch.Tensor)
                    and new.shape == static.shape
                    and new.dtype == static.dtype
                    and new.device == static.device):
                raise ValueError(
                    f"input {i} is not a {tuple(static.shape)} "
                    f"{static.dtype} tensor on {static.device}, as at the "
                    "capture: a new shape, type or device needs a new "
                    "capture")
        with torch.no_grad():
            for static, new in zip(self.inputs, inputs):
                static.copy_(new)

    def read(self, t: torch.Tensor) -> float:
        """t (a 0-dim output, the loss) on the host, with the captured
        bounds checks in the same copy: a violated check warns as the eager
        op does, and costs no synchronisation beyond t's read."""
        with (profiling.annotate("mdc.step.read") if profiling.enabled()
              else contextlib.nullcontext()):
            return self.bounds.read_with(t, stacklevel=2)

    def spans(self) -> list:
        """The spans of the last min(replays, RING_ROWS) replays
        (`profiling` module docstring), read with one synchronisation and
        one copy; [] where the spans were off at the capture."""
        return [] if self.record is None else self.record.read()


def capture(fn: Callable, *inputs: torch.Tensor) -> CapturedStep:
    """Capture fn(*static_inputs) as a CUDA graph and return the step.

    The static inputs are copies of `inputs` (detached, requires_grad
    kept, so fn may differentiate with respect to them); with no inputs,
    fn reads the tensors it closes over and runs on the current CUDA
    device.  fn returns a tensor or a tuple / list of tensors.  fn runs
    WARMUP times on a side stream first (with every side effect: an
    optimizer's update included; a trainer that wants the captured steps
    alone restores its state after), then once under capture, which
    launches nothing; the graph takes a private memory pool.

    Raises RuntimeError without a CUDA device or where the capture
    fails (the failing operation's message chained), ValueError on an
    input that is not a tensor on a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("capture needs a CUDA device and none is "
                           "visible; on the CPU call the step itself")
    for i, t in enumerate(inputs):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            where = t.device if isinstance(t, torch.Tensor) else type(t)
            raise ValueError(f"capture takes CUDA tensors; input {i} is on "
                             f"{where}")
    device = (inputs[0].device if inputs
              else torch.device("cuda", torch.cuda.current_device()))
    traced = profiling.enabled()
    t0 = time.perf_counter()
    static = [t.detach().clone().requires_grad_(t.requires_grad)
              for t in inputs]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            marks = profiling.marks(device)
            with profiling.span("mdc.step", device):
                fn(*static)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)

    graph = torch.cuda.CUDAGraph()
    before = lib.counts()
    bounds = bounds_check.BoundsRecord()
    record = (profiling.StepRecord(device, profiling.marks(device) - marks)
              if traced else None)
    try:
        with bounds_check.recording(bounds), profiling.recording(record), \
                torch.cuda.graph(graph):
            root = record.begin("mdc.step", device, {}) if traced else None
            out = fn(*static)
            bounds.seal()
            if traced:
                record.end(root, device, last=True)
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture of "
                           f"{getattr(fn, '__name__', fn)!r} failed: {e}"
                           ) from e
    _check_outputs(out)
    if traced and (record.open or record.slots != record.width):
        raise RuntimeError(
            f"the capture made {record.slots} marks against its warm-up's "
            f"{record.width}, or left spans open: "
            f"{[sp.name for sp in record.open]}")
    after = lib.counts()
    torch.cuda.synchronize(device)
    return CapturedStep(graph, static, out,
                        dict(after.launches - before.launches), bounds,
                        time.perf_counter() - t0, record,
                        dict(after.values - before.values))


# ---- the chain timer --------------------------------------------------------


def summary(samples: List[float]) -> dict:
    """{"ms": median, "spread", "samples"}: the spread is the range of the
    samples without the highest and the lowest, over the median."""
    med = statistics.median(samples)
    s = sorted(samples)[1:-1] if len(samples) > 3 else samples
    return {"ms": med, "spread": (max(s) - min(s)) / med,
            "samples": list(samples)}


def chain(fn: Callable, n: int) -> Callable:
    """n back-to-back calls of fn on the same inputs, returning the last
    call's outputs.  Each earlier call's outputs are dropped as it
    returns, so that under capture the next call reuses their memory and
    the workspaces' in the graph's pool: a chain's memory is one step's,
    whatever n."""
    def run(*inputs):
        for _ in range(n - 1):
            fn(*inputs)
        return fn(*inputs)
    run.__name__ = f"{getattr(fn, '__name__', 'step')} x{n}"
    return run


def time_chain(fn: Callable, *inputs: torch.Tensor, n_lo: int = N_LO,
               n_hi: int = N_HI, samples: int = SAMPLES) -> dict:
    """The device's time for one call of fn(*inputs), in ms: the
    counterpart of the JAX package's `_amortized` (calibrate.py) and
    `_time_differenced` (utils/autotune.py).

    Captures `chain(fn, n_lo)` and `chain(fn, n_hi)` (`capture`: the
    warm-up calls, then one graph each), replays each once untimed, then
    `samples` times in turns, lo then hi, each replay between CUDA events
    on the current stream, with no synchronisation until the last.  Each
    (lo, hi) pair gives one sample, (t_hi - t_lo) / (n_hi - n_lo), and
    the result is `summary` of the samples with "n_lo", "n_hi" and
    "kernels" ({"lo": ..., "hi": ...}, each graph's `CapturedStep.kernels`).

    The JAX chain feeds each step `carry * 1e-30` so that XLA cannot hoist
    the loop-invariant step out of its scan; a CUDA graph replays every
    launch it recorded, so the chain calls fn on the same inputs as they
    are.  With no inputs, fn closes over its tensors, as autotune's does.

    Raises as `capture` does (RuntimeError without a card or where a
    capture fails, ValueError on a CPU tensor) and never times eagerly in
    its place; ValueError unless 1 <= n_lo < n_hi and samples >= 1."""
    if not (1 <= n_lo < n_hi and samples >= 1):
        raise ValueError(f"time_chain needs 1 <= n_lo < n_hi and samples "
                         f">= 1, got n_lo={n_lo}, n_hi={n_hi}, "
                         f"samples={samples}")
    lo = capture(chain(fn, n_lo), *inputs)
    hi = capture(chain(fn, n_hi), *inputs)
    lo.graph.replay()
    hi.graph.replay()
    events = []
    for _ in range(samples):
        for step in (lo, hi):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step.graph.replay()
            end.record()
            events.append((start, end))
    events[-1][1].synchronize()
    ms = [start.elapsed_time(end) for start, end in events]
    per_step = [(t_hi - t_lo) / (n_hi - n_lo)
                for t_lo, t_hi in zip(ms[0::2], ms[1::2])]
    return {**summary(per_step), "n_lo": n_lo, "n_hi": n_hi,
            "kernels": {"lo": lo.kernels, "hi": hi.kernels}}
