"""Fixtures of the benchmark's CPU tests: a checkout of the benchmark at a
tiny size, whose cells, configurations, traffic mixes, limits and one
metric are added as files and entries only, and an eager stand-in for the
program's CUDA-graph capture."""
from __future__ import annotations

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "tiny-resnet50": ("dcn-resnet50", {"width": 4, "num_classes": 10}),
    "tiny-resnet50-c16": ("dcn-resnet50", {"width": 8, "num_classes": 16}),
}
TINY_MIXES = {
    "tiny-image-train": {"kind": "train", "batch": 2,
                         "sample": [3, 128, 128], "pool": 4, "in_flight": 2,
                         "trace_steps": 2, "compare": 3},
    "tiny-image-serve": {"kind": "serve", "batch": 1, "sample": [3, 64, 64],
                         "pool": 6, "trace_steps": 3, "compare": 2},
}
# Limits of the tiny cells, set as the cells' limits are (PERF.md), from
# CPU readings on five seeds: above what sound runs read (first loss
# 2.4e-5, head's gradient error 1.5e-4, median leaf's gradient gap 5.8e-3,
# worst leaf's change gap 0.135; logits 2.0e-3 at most) and below the
# bf16 control (head 0.17, logits 0.23 at least), half the batch (first
# loss 6.7e-3) and the wrong backwards (median leaf's gap 0.091 or a leaf
# left unmoved, change gap 1).
TINY_CELLS = {
    "tiny-r50-train": ("tiny-resnet50-c16", "tiny-image-train",
                       {"loss1_gap": 3e-4, "head_grad_err": 5e-3,
                        "grad_median_gap": 0.03, "delta_gap": 0.4}),
    "tiny-r50-serve": ("tiny-resnet50", "tiny-image-serve",
                       {"logit_gap": 2e-2}),
}
# A per-layer metric added as a file: the steps of the traced window.
TINY_METRIC = '''UNIT = "steps"
LAYER = "compiled step"
MOVES = "setup_s"


def read(ctx):
    return None if ctx.trace is None else ctx.trace_steps
'''


def add_tiny_cells(root: pathlib.Path) -> None:
    """Add the tiny cells to the checkout at `root` as new files and new
    entries of its BENCHMARK.json, editing no file the benchmark has."""
    here = root / "dcnbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (base, over) in TINY_CONFIGS.items():
        cfg = json.loads((here / "configs" / f"{base}.json").read_text())
        cfg["name"] = name
        cfg["program"]["args"].update(over)
        cfg["reference"]["args"].update(over)
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"dcnbench/configs/{name}.json",
                                 "reduced": ["width"], "why": "CPU tests"})
    for name, mix in TINY_MIXES.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (cfg, mix, limits) in TINY_CELLS.items():
        (here / "limits" / f"{name}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
    (here / "metrics" / "tiny_steps.py").write_text(TINY_METRIC)
    bench["per_layer"].append({"name": "tiny_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "compiled step", "moves": "setup_s",
                               "workloads": list(TINY_CELLS)})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("tiny-r50-train")
        if m["name"] == "infer_samples_per_s":
            m["workloads"].append("tiny-r50-serve")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(autouse=True)
def two_threads():
    """Each test process computes on two threads, so that several of them
    share the CPU without stalling one another."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def tiny_root(tmp_path) -> pathlib.Path:
    """A checkout of BENCHMARK.json and dcnbench/ with the tiny cells."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "dcnbench", root / "dcnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    add_tiny_cells(root)
    return root


class EagerStep:
    """`graphs.capture`'s stand-in on the CPU: the same warm-up calls, then
    each call runs the function on the inputs given (or the static ones)."""
    WARMUP = 3

    def __init__(self, fn, *inputs):
        self.fn, self.inputs, self.outputs = fn, [t.clone() for t in inputs], None
        for _ in range(self.WARMUP):
            fn(*self.inputs)

    def __call__(self, *inputs):
        self.outputs = self.fn(*(inputs or self.inputs))
        return self.outputs


@pytest.fixture
def eager(monkeypatch):
    """Steps run eagerly: the program's capture needs a card.  The warm
    period before the window is cut to a fifth of a second."""
    from dcnbench import harness, program
    monkeypatch.setattr(program, "capture", EagerStep)
    monkeypatch.setattr(harness, "WARM_S", 0.2)
    return program
