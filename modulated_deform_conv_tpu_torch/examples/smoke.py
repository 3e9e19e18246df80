"""Smoke example: the JAX package's examples/smoke.py through the port.

All-ones 5x5 input, zero offsets, all-ones mask and 3x3 weight, stride 1,
pad 1: this reduces to an ordinary 3x3 same-padded convolution over ones,
whose outputs and input gradients are known (interior 9, edges 6, corners
4).  Both 2D ops run through the kernel path (impl="cuda": the kernels on
the card, their plain versions on the CPU), and the values are asserted.
On the card each op's forward and gradient run as one captured step
(utils/graphs.py), as the JAX smoke jits them; on the CPU the step is
called directly.

    python -m modulated_deform_conv_tpu_torch.examples.smoke [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import ops
from ..utils import graphs


def expected() -> np.ndarray:
    """The 5x5 map of interior 9, edges 6, corners 4."""
    e = np.full((5, 5), 9.0)
    e[0] = e[-1] = e[:, 0] = e[:, -1] = 6.0
    for i in (0, -1):
        for j in (0, -1):
            e[i, j] = 4.0
    return e


def run(device="cuda") -> dict:
    """Both ops' outputs and grad_x on `device`, checked; returns them as
    numpy arrays.  On a CUDA device each op's forward and grad_x are one
    captured step, replayed once."""
    dev = torch.device(device)
    K = 9
    x = torch.ones((1, 1, 5, 5), device=dev, requires_grad=True)
    offset = torch.zeros((1, 2 * K, 5, 5), device=dev)
    mask = torch.ones((1, K, 5, 5), device=dev)
    weight = torch.ones((1, 1, 3, 3), device=dev)
    bias = torch.zeros((1,), device=dev)
    want = expected()
    got = {}
    for name, fn in (("deform_conv2d", lambda t: ops.deform_conv2d(
            t, offset, weight, bias, 1, 1, impl="cuda")),
                     ("modulated_deform_conv2d",
                      lambda t: ops.modulated_deform_conv2d(
                          t, offset, mask, weight, bias, 1, 1, impl="cuda"))):

        def step(t, fn=fn):
            out = fn(t)
            return out.detach(), torch.autograd.grad(out.sum(), t)[0]

        if dev.type == "cuda":
            out, gx = graphs.capture(step, x)()
        else:
            out, gx = step(x)
        got[name] = (out.cpu().numpy()[0, 0],
                     gx.cpu().numpy()[0, 0])
        for label, arr in zip(("output", "grad_x"), got[name]):
            np.testing.assert_allclose(arr, want, rtol=1e-6, err_msg=(
                f"{name} {label} on {device}"))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device)
    print(f"smoke OK on {args.device}: out and grad_x interior/edge/corner "
          "= 9/6/4 for deform_conv2d and modulated_deform_conv2d")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
