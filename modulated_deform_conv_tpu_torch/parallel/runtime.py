"""Process-group start-up and mesh construction on torch.distributed.

Counterparts of the JAX package's `parallel/runtime.py`
(`initialize_distributed`, `pod_mesh`, `device_summary`).  Nothing here
discovers a cluster: the caller gives the rendezvous (`init_method`, or the
usual MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE environment) and the
rank and world size.  The card is the default: NCCL and a "cuda" mesh;
gloo and a "cpu" mesh only when the caller asks for them, and without a
CUDA device the defaults raise rather than fall back to the CPU.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("modulated_deform_conv_tpu_torch")


def _need_cuda(what: str, cpu_choice: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device and none is visible; "
                           f"pass {cpu_choice} to run on the CPU")


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: str = "nccl") -> None:
    """Initialize the default process group; a no-op where one exists.

    `init_method` is a `file://` or `tcp://` URL, or None to read the
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).  `backend`
    is "nccl" (the default: the process takes device `rank %
    device_count`, and without a CUDA device this raises) or what the
    caller names, e.g. "gloo" for CPU ranks."""
    if dist.is_initialized():
        logger.info("torch.distributed already initialized; skipped")
        return
    if backend == "nccl":
        _need_cuda("initialize_distributed(backend='nccl')",
                   "backend='gloo'")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def pod_mesh(data: Optional[int] = None, space: int = 1,
             axis_names: Tuple[str, str] = ("data", "space"),
             device_type: str = "cuda"):
    """A (data, space) DeviceMesh over the whole world, data inferred.

    The spatial axis is innermost, so the halo exchange's neighbours are
    consecutive ranks (the same host and its fast links), and the batch
    gradient sum crosses hosts only between the data replicas.  A "cuda"
    mesh (the default) raises without a CUDA device; pass
    device_type="cpu" for a mesh of gloo CPU ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda":
        _need_cuda("pod_mesh(device_type='cuda')", "device_type='cpu'")
    n = dist.get_world_size()
    if data is None:
        if n % space:
            raise ValueError(f"{n} ranks not divisible by space={space}")
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} != {n} ranks")
    return init_device_mesh(device_type, (data, space),
                            mesh_dim_names=tuple(axis_names))


def device_summary() -> str:
    """One line: ranks, backend and the first device's kind."""
    if dist.is_initialized():
        ranks, backend = dist.get_world_size(), dist.get_backend()
    else:
        ranks, backend = 1, "none"
    if torch.cuda.is_available():
        kind = f"cuda:{torch.cuda.get_device_name(0)}"
        devices = torch.cuda.device_count()
    else:
        kind, devices = "cpu", 1
    return (f"{ranks} ranks ({backend}), {devices} devices on this host; "
            f"first: {kind}")
