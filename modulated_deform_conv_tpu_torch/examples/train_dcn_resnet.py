"""End-to-end training recipe: DCNResNet, DCNVideoNet or DCNResNet3d on
synthetic data.

Counterpart of the JAX package's examples/train_dcn_resnet.py: the DCN
backbone (DCNv2 Pack blocks in stages c3-c5, whose forward and backward
run the general gather kernels on a CUDA device; with `--arch video` the
3D video network, whose 3D DCN layers run the 3D gather kernels on clips
of `--frames` frames; with `--arch resnet3d` the 3D ResNet-50 of
`DCNResNet3d` on such clips), AdamW with optax's defaults (lr 1e-3, weight decay
1e-4: torch's default decay is 1e-2), softmax cross-entropy on one fixed
batch made from a numpy seed, a check that the loss falls, and a
checkpoint round trip.

On a CUDA device the step is compiled as the JAX trainer jits it: captured
once as a CUDA graph (utils/graphs.py) and replayed each step; `--eager`
runs it op by op instead, the counterpart of `jax.disable_jit`.  Where
torch.distributed is initialised with more than one rank and the batch
divides evenly, each rank trains on its slice of the batch and the
gradients are averaged over the ranks, as the JAX trainer shards the batch
over its devices; that branch runs eagerly.

    python -m modulated_deform_conv_tpu_torch.examples.train_dcn_resnet \\
        [--steps 10] [--batch 8] [--width 8] [--classes 10] [--size 32] \\
        [--arch resnet|video|resnet3d] [--frames 16] [--device cuda] [--eager]

Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import functools
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models import DCNResNet, DCNResNet3d, DCNVideoNet
from ..ops.cuda.adamw import AdamW
from ..utils import graphs, profiling
from ..utils.checkpoint import restore_checkpoint, save_checkpoint


# --arch -> the network it trains.
ARCHS = {"resnet": DCNResNet, "video": DCNVideoNet, "resnet3d": DCNResNet3d}


def make_optimizer(model: nn.Module) -> torch.optim.Optimizer:
    """AdamW at optax.adamw's defaults (lr 1e-3, weight decay 1e-4), whose
    update is one pass of the hand-written kernel over every leaf on a CUDA
    device (ops/cuda/adamw.py); there `capturable`, so that its step count
    lives on the device and the update can be captured."""
    on_cuda = next(model.parameters()).is_cuda
    return AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4,
                 capturable=on_cuda)


def _rank_mean(tensors, world: int) -> None:
    """Replace each tensor by its mean over the ranks, in place: one flat
    buffer gathered from every rank and added in rank order
    (parallel/sharding.py's `_all_sum`), so that every rank gets the same
    bits."""
    from ..parallel.sharding import _all_sum
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = _all_sum(flat, [None]) / world
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def train_step(model: nn.Module, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor,
               world: int = 1) -> torch.Tensor:
    """One AdamW step on softmax cross-entropy; returns the loss.  With
    `world` > 1 (torch.distributed initialised, each rank holding its
    slice of the batch) the loss and the gradients are averaged over the
    ranks before the update.  With the program's spans on
    (`utils/profiling.py::tracing`) the model and loss, the backward and
    the update are the spans "mdc.train.forward", "mdc.train.backward" and
    "mdc.train.optimizer"."""
    opt.zero_grad(set_to_none=True)
    with profiling.span("mdc.train.forward", x):
        loss = F.cross_entropy(model(x), y)
    with profiling.span("mdc.train.backward", x):
        loss.backward()
    loss = loss.detach()
    if world > 1:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        _rank_mean([loss.reshape(1)] + grads, world)
    with profiling.span("mdc.train.optimizer", x):
        opt.step()
    return loss


def _world() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _fresh_state(model: nn.Module, opt: torch.optim.Optimizer,
                 init: dict) -> None:
    """Put back the state of before the capture's warm-up steps: the
    parameters and buffers from `init`, and AdamW's state as a fresh
    optimizer's (step 0, zero moments), in place, so the graph keeps its
    addresses."""
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(init[k])
        for state in opt.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    v.zero_()


def train(steps: int = 10, batch: int = 8, width: int = 8,
          classes: int = 10, size: int = 32, device: str = "cuda",
          ckpt_dir: Optional[str] = None,
          log: Callable[[str], None] = print,
          on_step: Optional[Callable[[int, nn.Module], None]] = None,
          arch: str = "resnet", frames: int = 16,
          eager: bool = False, dtype: torch.dtype = torch.float32) -> dict:
    """Take `steps` AdamW steps of DCNResNet-50 on one synthetic batch of
    `batch` size x size images (arch "resnet"), or of DCNVideoNet at its
    default blocks (arch "video") or DCNResNet3d-50 (arch "resnet3d") on
    `batch` clips of `frames` x size x size, parameters and batch in `dtype`; the checkpoint goes under
    `ckpt_dir`, or a temporary directory.

    On a CUDA device the step is captured once (its warm-up steps undone
    afterwards) and each of the `steps` is a replay; `eager=True` runs
    every step op by op.  CPU runs are eager.  `on_step(step, model)`, if
    given, is called before each step (to attach hooks, say): it runs
    Python every step, so on a CUDA device it needs `eager=True`.  With
    torch.distributed initialised on more than one rank, each rank takes
    its slice of the batch where the batch divides evenly (the
    parameters broadcast from rank 0, the gradients averaged in rank
    order), eagerly, and a capture of that step raises; where it does not
    divide, every rank trains on the whole batch, as the JAX trainer does
    then.  Only rank 0 writes the checkpoint.

    Raises ValueError for on_step, or the data-parallel branch, on a
    captured run; RuntimeError if the loss did not fall or the checkpoint does not
    round-trip.  Returns the losses, the wall time of each step (each ends
    in a synchronise on a CUDA device), the capture's time (None when
    eager), the kernels the graph holds, the checkpoint directory, and the
    trained model, its optimizer and the batch (x, y)."""
    if arch not in ARCHS:
        raise ValueError(f"arch must be one of {sorted(ARCHS)}, got {arch!r}")
    dev = torch.device(device)
    world = _world()
    rank = dist.get_rank() if world > 1 else 0
    dp = world > 1 and batch % world == 0
    captured = dev.type == "cuda" and not eager
    if captured and on_step is not None:
        raise ValueError("on_step runs Python on every step, which a "
                         "captured step does not: pass eager=True")
    if captured and dp:
        raise ValueError(f"a captured data-parallel step on {world} ranks "
                         "is not supported: pass eager=True")
    net = ARCHS[arch]
    clip = (size, size) if arch == "resnet" else (frames, size, size)
    torch.manual_seed(0)
    model = net(num_classes=classes, width=width, device=dev, dtype=dtype)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, 3) + clip)
                         .astype(np.float32)).to(dev, dtype)
    y = torch.from_numpy(rng.integers(0, classes, (batch,))).to(dev)
    if dp:
        local = batch // world
        x, y = (t[rank * local:(rank + 1) * local].contiguous()
                for t in (x, y))
        with torch.no_grad():
            for t in model.state_dict().values():
                dist.broadcast(t, 0)
        log(f"data-parallel over {world} ranks: {local} samples a rank")
    elif world > 1:
        log(f"batch {batch} does not divide over {world} ranks: every "
            "rank trains on the whole batch")
    opt = make_optimizer(model)

    step_fn, capture_s, kernels = None, None, None
    if captured:
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step_fn = graphs.capture(functools.partial(train_step, model, opt),
                                 x, y)
        _fresh_state(model, opt, init)
        del init
        capture_s, kernels = step_fn.capture_s, step_fn.kernels
        log(f"captured the step in {capture_s:.2f} s (warm-up included); "
            f"kernels in the graph: {kernels}; values a step (the update's, "
            f"the 3D columns'): "
            f"{step_fn.values}")

    losses, step_s = [], []
    for step in range(steps):
        if on_step is not None:
            on_step(step, model)
        t0 = time.perf_counter()
        if step_fn is not None:
            losses.append(step_fn.read(step_fn()))   # waits for the step
        else:
            losses.append(float(train_step(model, opt, x, y,
                                           world if dp else 1)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        log(f"step {step:3d}  loss {losses[-1]:.4f}  "
            f"{step_s[-1] * 1e3:.1f} ms")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")

    path = None
    if rank == 0:
        with tempfile.TemporaryDirectory() as tmp:
            path = save_checkpoint(ckpt_dir or tmp,
                                   {"model": model.state_dict(),
                                    "optimizer": opt.state_dict()},
                                   step=steps)
            state = restore_checkpoint(ckpt_dir or tmp, step=steps)
            fresh = net(num_classes=classes, width=width, device=dev,
                        dtype=dtype)
            fresh.load_state_dict(state["model"])
            make_optimizer(fresh).load_state_dict(state["optimizer"])
            own = model.state_dict()
            for k, v in fresh.state_dict().items():
                if not torch.equal(v, own[k]):
                    raise RuntimeError(f"checkpoint round trip changed {k}")
        log(f"checkpoint round-trip OK ({path})")
    log(f"train OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "capture_s": capture_s,
            "kernels": kernels, "checkpoint": path, "model": model,
            "optimizer": opt, "batch": (x, y), "step": step_fn}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--arch", choices=tuple(ARCHS), default="resnet")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run each step op by op (no CUDA graph)")
    args = ap.parse_args(argv)
    train(args.steps, args.batch, args.width, args.classes, args.size,
          args.device, arch=args.arch, frames=args.frames, eager=args.eager)


if __name__ == "__main__":
    main()
