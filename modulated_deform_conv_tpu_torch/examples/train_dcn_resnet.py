"""End-to-end training recipe: DCNResNet or DCNVideoNet on synthetic data.

Counterpart of the JAX package's examples/train_dcn_resnet.py: the DCN
backbone (DCNv2 Pack blocks in stages c3-c5, whose forward and backward
run the general gather kernels on a CUDA device; with `--arch video` the
3D video network, whose 3D DCN layers run the 3D gather kernels on clips
of `--frames` frames), AdamW with optax's defaults (lr 1e-3, weight decay
1e-4: torch's default decay is 1e-2), softmax cross-entropy on one fixed
batch made from a numpy seed, a check that the loss falls, and a
checkpoint round trip.

    python -m modulated_deform_conv_tpu_torch.examples.train_dcn_resnet \\
        [--steps 10] [--batch 8] [--width 8] [--classes 10] [--size 32] \\
        [--arch resnet|video] [--frames 16] [--device cuda]

Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import DCNResNet, DCNVideoNet
from ..utils.checkpoint import restore_checkpoint, save_checkpoint


def train_step(model: nn.Module, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One AdamW step on softmax cross-entropy; returns the loss."""
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    opt.step()
    return loss.detach()


def train(steps: int = 10, batch: int = 8, width: int = 8,
          classes: int = 10, size: int = 32, device: str = "cuda",
          ckpt_dir: Optional[str] = None,
          log: Callable[[str], None] = print,
          on_step: Optional[Callable[[int, nn.Module], None]] = None,
          arch: str = "resnet", frames: int = 16) -> dict:
    """Take `steps` AdamW steps of DCNResNet-50 on one synthetic batch of
    `batch` size x size images (arch "resnet"), or of DCNVideoNet at its
    default blocks on `batch` clips of `frames` x size x size (arch
    "video"); the checkpoint goes under `ckpt_dir`, or a temporary
    directory.  `on_step(step, model)`, if given, is called before each
    step (to attach hooks, say).

    Raises if the loss did not fall or the checkpoint does not round-trip.
    Returns the losses, the wall time of each step (each ends in a
    synchronise on a CUDA device), the checkpoint directory, and the
    trained model, its optimizer and the batch (x, y)."""
    if arch not in ("resnet", "video"):
        raise ValueError(f"arch must be 'resnet' or 'video', got {arch!r}")
    dev = torch.device(device)
    net, clip = ((DCNResNet, (size, size)) if arch == "resnet"
                 else (DCNVideoNet, (frames, size, size)))
    torch.manual_seed(0)
    model = net(num_classes=classes, width=width, device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, 3) + clip)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, classes, (batch,))).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)

    losses, step_s = [], []
    for step in range(steps):
        if on_step is not None:
            on_step(step, model)
        t0 = time.perf_counter()
        loss = train_step(model, opt, x, y)
        losses.append(float(loss))   # waits for the step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        log(f"step {step:3d}  loss {losses[-1]:.4f}  "
            f"{step_s[-1] * 1e3:.1f} ms")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")

    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(ckpt_dir or tmp,
                               {"model": model.state_dict(),
                                "optimizer": opt.state_dict()}, step=steps)
        state = restore_checkpoint(ckpt_dir or tmp, step=steps)
        fresh = net(num_classes=classes, width=width, device=dev)
        fresh.load_state_dict(state["model"])
        torch.optim.AdamW(fresh.parameters()).load_state_dict(
            state["optimizer"])
        own = model.state_dict()
        for k, v in fresh.state_dict().items():
            if not torch.equal(v, own[k]):
                raise RuntimeError(f"checkpoint round trip changed {k}")
    log(f"checkpoint round-trip OK ({path})")
    log(f"train OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "checkpoint": path,
            "model": model, "optimizer": opt, "batch": (x, y)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--arch", choices=("resnet", "video"), default="resnet")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.steps, args.batch, args.width, args.classes, args.size,
          args.device, arch=args.arch, frames=args.frames)


if __name__ == "__main__":
    main()
