"""The port's process-group start-up and its profiling helpers, on the CPU.

`initialize_distributed` and `pod_mesh` default to the card (NCCL, a
"cuda" mesh) and raise without a CUDA device rather than fall back to the
CPU; gloo and a "cpu" mesh run only when the caller names them.
`profiling.Timer` takes the host clock only for device="cpu", `annotate`
names a range in a `trace`, and `trace` writes its file under the given
directory.  This file imports no JAX.
"""
import json
import os

import pytest
import torch
import torch.distributed as dist

from modulated_deform_conv_tpu_torch.parallel import runtime
from modulated_deform_conv_tpu_torch.utils import profiling

no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the behaviour without a GPU")


@no_cuda
def test_runtime_defaults_raise_without_cuda():
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        runtime.initialize_distributed()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        runtime.pod_mesh()
    assert not dist.is_initialized()


def test_runtime_on_cpu_when_asked(tmp_path):
    """gloo and a "cpu" mesh, named by the caller, on one rank."""
    assert not dist.is_initialized()
    runtime.initialize_distributed(f"file://{tmp_path / 'store'}",
                                   world_size=1, rank=0, backend="gloo")
    try:
        assert dist.get_backend() == "gloo"
        mesh = runtime.pod_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "space")
        assert "1 ranks (gloo)" in runtime.device_summary()
    finally:
        dist.destroy_process_group()


def test_timer_on_the_host_clock_only_when_asked():
    with profiling.Timer("cpu", name="sum") as t:
        torch.arange(10000).sum()
    assert t.elapsed_ms is not None and t.elapsed_ms >= 0.0
    with pytest.raises(ValueError, match="device"):
        profiling.Timer("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.Timer("cuda")


def test_trace_writes_the_annotated_range(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        with profiling.annotate("lead_shard_step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert os.path.dirname(prof.path) == str(logdir)
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "lead_shard_step" for e in events)
    assert any(e.key == "lead_shard_step" for e in prof.key_averages())
