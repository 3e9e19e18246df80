"""The harness on the CPU: cells, configurations, traffic mixes and metrics
found by name from files alone; the last line's keys; the command without
a card or without the program; and the check of loaded modules."""
import ast
import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from dcnbench import harness

from .conftest import REPO, TINY_CELLS, TINY_MIXES

HERE = REPO / "dcnbench"
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_files_added_alone_make_a_cell_that_runs(tiny_root, eager, cell,
                                                  trace):
    """The tiny cells exist only as added files and entries; a run finds
    its configuration, mix, limits and metrics by name, and its line has
    the contract's keys, with the comparisons last."""
    c = harness.load_cell(cell, tiny_root)
    out = harness.run(c, 2 ** 33 + 5, 0.5, bool(trace), time.perf_counter(),
                      device="cpu")
    res = out["result"]
    assert list(res)[:5] == LINE_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(TINY_CELLS[cell][2])
    for check in res["checks"].values():
        assert set(check) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    names = {m["name"] for m in (c.per_layer if trace else c.e2e)}
    assert set(res["metrics"]) <= names
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        n = TINY_MIXES[TINY_CELLS[cell][1]]["trace_steps"]
        assert res["metrics"]["tiny_steps"]["value"] == n
        assert res["attempted"] == 2 * n   # timed, then traced
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"]


def test_metric_files_declare_what_benchmark_json_says():
    """Each metric's reader (one file for `dcn_ms.train` and
    `dcn_ms.infer`) declares the metric's unit and layer."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.reader(REPO, m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if m in bench["per_layer"]:
            assert mod.LAYER == m["layer"], m["name"]


def test_a_reader_of_its_own_comes_before_the_quantitys(tmp_path):
    here = tmp_path / "dcnbench" / "metrics"
    here.mkdir(parents=True)
    (here / "q.py").write_text("UNIT = 'ms'\n")
    (here / "q.b.py").write_text("UNIT = 's'\n")
    assert harness.reader(tmp_path, "q.a").UNIT == "ms"
    assert harness.reader(tmp_path, "q.b").UNIT == "s"


def test_benchmark_json_names_existing_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.e2e and cell.per_layer
        reported = {m["name"] for m in cell.e2e}
        assert "setup_s" in reported
        assert {m["moves"] for m in cell.per_layer} <= reported


def test_banned_modules_compare_whole_top_level_names():
    assert harness.banned_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.banned_modules(
        ["modulated_deform_conv_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert harness.banned_modules(
        ["modulated_deform_conv_tpu.ops.api", "optax"]) == [
            "modulated_deform_conv_tpu", "optax"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.BANNED), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "modulated_deform_conv_tpu_torch" not in tops, path
        assert tops <= {"__future__", "itertools", "math", "typing", "torch"}


def test_a_run_loads_no_banned_module():
    """The harness, the program and the reference imported in a fresh
    process leave no banned top-level name in sys.modules."""
    code = ("import sys; import dcnbench.harness, dcnbench.program, "
            "dcnbench.control, dcnbench.reference.backbone; "
            "from dcnbench.harness import banned_modules; "
            "print(banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _command(cwd, workload="r50-imagenet-train"):
    return subprocess.run(
        [sys.executable, "dcnbench/run.py", "--workload", workload, "--seed",
         str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = _command(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_the_command_fails_and_prints_no_result(
        tmp_path):
    shutil.copytree(HERE, tmp_path / "dcnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_the_server_is_a_closed_loop_over_the_pool_in_order():
    """Each request is sent when the one before it is back, on the pool's
    entries in the seed's order from `start`; the kept ones are those on
    the compared entries."""
    import torch
    pool = torch.arange(5.0).reshape(5, 1, 1)
    seen = []

    def step(x):
        seen.append(int(x.item()))
        return x * 2
    order = [3, 1, 4, 0, 2]
    win = harness.serve_window(step, pool, order, 2, 10.0, {4},
                               harness.Device("cpu"), max_steps=7)
    assert win["steps"] == 7 and len(win["issue_s"]) == 7
    assert seen == [4, 0, 2, 3, 1, 4, 0]
    assert [(e, float(v)) for e, v in win["kept"]] == [(4, 8.0), (4, 8.0)]
    assert win["bad"] == 0
