"""The video configuration on the CPU: the 3D reference's operation count
against a hand count, the cell `r3d50-k400-train` as BENCHMARK.json and
its files give it, and a tiny copy of the configuration run through the
harness by added files alone, training and traced."""
import json
import math
import time

import pytest

from dcnbench import harness
from dcnbench.reference.resnet3d import MODELS


CELL = "r3d50-k400-train"
# The training cells' per-layer metrics, which list this cell too.
TRAIN_METRICS = {"issue_ms.train", "mfu.train", "dcn_ms.train",
                 "dcn_roofline.train", "non_dcn_ms.train",
                 "device_idle_pct.train"}


def hand_count(T=16, H=112, width=64, classes=400, blocks=(3, 4, 6, 3)):
    """Forward operations of one clip, 2 a multiply-add, from the layer
    list: the stem at stride (1, 2, 2), the pool at 2, each bottleneck's
    1x1x1, 3x3x3 (with its predictors in c3-c5: 81 offsets and 27 mask
    channels) and 1x1x1 convs, the projections, the head."""
    def vox(t, h):
        return t * h * h
    t, h = T, H // 2                       # stem (pad 3: 112 -> 56)
    total = 2 * vox(t, h) * width * 3 * 343
    t, h = t // 2, h // 2                  # pool 3/2/1: 16x56 -> 8x28
    cin = width
    for i, n in enumerate(blocks):
        mid, cout = width * 2 ** i, width * 4 * 2 ** i
        for j in range(n):
            t_in, h_in = t, h
            if i > 0 and j == 0:           # stride 2, pad 1
                t, h = (t - 1) // 2 + 1, (h - 1) // 2 + 1
            total += 2 * vox(t_in, h_in) * mid * cin           # conv1
            outs = mid + (81 + 27 if i > 0 else 0)             # + predictors
            total += 2 * vox(t, h) * outs * mid * 27           # 3x3x3
            total += 2 * vox(t, h) * cout * mid                # conv3
            if j == 0:
                total += 2 * vox(t, h) * cout * cin            # projection
            cin = cout
    assert (t, h) == (1, 4)
    return total + 2 * classes * cin


def test_reference_counts_the_hand_count():
    fwd, shapes = MODELS["dcn_resnet3d"]
    args = {"depth": 50, "width": 64, "num_classes": 400,
            "deformable_groups": 1}
    flops = harness.forward_flops(fwd, shapes(**args), args,
                                  (3, 16, 112, 112), 2)
    assert flops == 2 * hand_count()
    assert 23.4e9 < hand_count() < 23.6e9


def test_cell_reads_its_files():
    c = harness.load_cell(CELL)
    assert c.chips == 1
    assert c.config["name"] == "dcn-r3d50" and c.config["reduced"] == {}
    assert c.config["program"] == {"class": "DCNResNet3d", "args": {
        "depth": 50, "width": 64, "deformable_groups": 1,
        "num_classes": 400}}
    assert c.config["reference"]["args"] == c.config["program"]["args"]
    mix = {k: v for k, v in c.mix.items() if k != "why"}
    assert mix == {"kind": "train", "batch": 32,
                   "sample": [3, 16, 112, 112], "pool": 8, "in_flight": 2,
                   "trace_steps": 10, "compare": 3}
    assert set(c.limits) == {"loss1_gap", "head_grad_err",
                             "grad_median_gap", "delta_gap"}
    assert {m["name"] for m in c.e2e} == {"train_samples_per_s",
                                          "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in c.per_layer} == TRAIN_METRICS
    forward, shapes, args = harness.reference_model(c.config)
    assert forward is MODELS["dcn_resnet3d"][0] and len(shapes) == 187
    # The pool holds over 12x the card's 50 MB L2 cache.
    assert 4 * mix["pool"] * mix["batch"] * math.prod(mix["sample"]) > 6e8


@pytest.fixture
def video_root(tiny_root):
    """The tiny checkout with a tiny copy of the video configuration, its
    mix and its cell, added as files and entries."""
    here = tiny_root / "dcnbench"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "dcn-r3d50.json").read_text())
    for side in ("program", "reference"):
        cfg[side]["args"].update(width=4, num_classes=12)
    (here / "configs" / "tiny-r3d50.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-r3d50", "source": "a test",
                             "file": "dcnbench/configs/tiny-r3d50.json",
                             "reduced": ["width"], "why": "CPU tests"})
    (here / "traffic" / "tiny-clip-train.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "sample": [3, 8, 64, 64], "pool": 3,
         "in_flight": 2, "trace_steps": 2, "compare": 3}))
    # The tiny 2D cell's limits, which hold here too: CPU readings of this
    # cell on four seeds, sound up to 9.3e-5 (first loss), 2.2e-4 (head),
    # 3.1e-4 (median leaf) and 0.25 (worst change); the control's head
    # 0.27 at least, grad_x_scaled's median leaf 0.13 at least.
    (here / "limits" / "tiny-r3d50-train.json").write_text(json.dumps(
        {"loss1_gap": 3e-4, "head_grad_err": 5e-3, "grad_median_gap": 0.03,
         "delta_gap": 0.4}))
    bench["workloads"].append({"name": "tiny-r3d50-train",
                               "config": "tiny-r3d50",
                               "traffic": "tiny-clip-train", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("tiny-r3d50-train")
    for m in bench["per_layer"]:
        if m["name"] in TRAIN_METRICS:
            m["workloads"].append("tiny-r3d50-train")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_video_cell_runs_and_is_correct(video_root, eager, trace):
    c = harness.load_cell("tiny-r3d50-train", video_root)
    out = harness.run(c, 2 ** 33 + 9, 0.5, bool(trace), time.perf_counter(),
                      device="cpu")
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert {"mfu.train", "issue_ms.train",
                "device_idle_pct.train"} <= set(res["metrics"])
        assert set(res["metrics"]) <= TRAIN_METRICS | {"tiny_steps"}
    else:
        assert set(res["metrics"]) == {"train_samples_per_s",
                                       "peak_mem_gib", "setup_s"} - {
            "peak_mem_gib"}   # no card, no memory reading


def test_tiny_video_cell_control_fails(video_root):
    """The bfloat16 reference in the program's place is not correct."""
    from dcnbench import compare, control
    c = harness.load_cell("tiny-r3d50-train", video_root)
    (mode, numbers), = control.readings(c, 5, harness.Device("cpu"),
                                        ["control"])
    ok, checks = compare.verdict(numbers, c.limits)
    assert mode == "control" and not ok, checks
