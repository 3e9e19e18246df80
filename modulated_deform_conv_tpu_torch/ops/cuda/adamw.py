"""The trainer's AdamW update in one pass: the wrapper `adamw`
(csrc/adamw.cu), its plain version `adamw_reference`, and `AdamW`, the
torch.optim.AdamW whose `step` calls them.

No port of a TPU kernel: the JAX trainer updates with optax's adamw, which
XLA fuses into its step.  torch.optim.AdamW makes about a dozen passes over
the leaves instead; the update is bound by memory, so the kernel reads each
value's p, g, m and v once and writes p, m and v once, every leaf of one
type in one launch (a few where the leaves outnumber a launch's table).

The arithmetic, torch.optim.AdamW's, in float32 for float32 and bfloat16
leaves (float64 in the plain version for float64 leaves), each value
rounded to its type once:

    t = step + 1, c1 = 1 - beta1^t, c2 = 1 - beta2^t (as -expm1(t log beta))
    p = p (1 - lr wd) - lr / c1 * m / (sqrt(v) / sqrt(c2) + eps)
    with m = beta1 m + (1 - beta1) g and v = beta2 v + (1 - beta2) g^2
    step = t

The wrapper launches the kernel on CUDA tensors and runs the plain version
on CPU tensors only.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from . import lib


def _scalars(lr, beta1, beta2, eps, weight_decay):
    """The kernel's floats, each worked out in double first: lr, beta1,
    1 - beta1, beta2, 1 - beta2, log(beta1), log(beta2), eps and the decay
    factor 1 - lr * wd.  The bias corrections are -expm1(t log(beta)): 1 -
    beta^t from a float32 beta loses 1 - beta's low digits (1.3e-5 of 1 -
    0.999), while log(beta) rounds to within a unit in its last place."""
    logs = [math.log(b) if b > 0 else -math.inf for b in (beta1, beta2)]
    return (float(lr), float(beta1), 1.0 - beta1, float(beta2), 1.0 - beta2,
            *logs, float(eps), 1.0 - lr * weight_decay)


@torch.no_grad()
def adamw_reference(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    exp_avgs: Sequence[torch.Tensor],
                    exp_avg_sqs: Sequence[torch.Tensor],
                    steps: Sequence[torch.Tensor], *, lr: float,
                    beta1: float, beta2: float, eps: float,
                    weight_decay: float) -> None:
    """The kernel's arithmetic in plain PyTorch, one leaf at a time, in
    place: in float32 (float64 for float64 leaves), each of p, m and v
    rounded to its type once, then each step count raised by one."""
    lr, b1, omb1, b2, omb2, log_b1, log_b2, eps, decay = _scalars(
        lr, beta1, beta2, eps, weight_decay)
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        acc = torch.promote_types(p.dtype, torch.float32)
        t = s.to(acc) + 1
        c1, c2 = -torch.expm1(t * log_b1), -torch.expm1(t * log_b2)
        gf = g.to(acc)
        mf = b1 * m.to(acc) + omb1 * gf
        vf = b2 * v.to(acc) + omb2 * gf * gf
        denom = vf.sqrt() / c2.sqrt() + eps
        p.copy_(p.to(acc) * decay - lr / c1 * mf / denom)
        m.copy_(mf)
        v.copy_(vf)
        s.add_(1)


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, done) -> None:
    """Raise unless the kernel can take these leaves as they are: p, g, m
    and v of one shape, of one type in lib.IO_CODES, contiguous; each step
    count a float32 scalar; every tensor and `done` (one int32) on the first
    leaf's CUDA device."""
    dev = params[0].device
    if (done is None or done.device != dev or done.dtype != torch.int32
            or done.numel() != 1):
        raise ValueError(f"adamw: done must be one int32 on {dev}")
    lengths = {len(grads), len(exp_avgs), len(exp_avg_sqs), len(steps)}
    if lengths != {len(params)}:
        raise ValueError("adamw: needs as many grads, moments and step "
                         "counts as leaves")
    for i, (p, g, m, v, s) in enumerate(zip(params, grads, exp_avgs,
                                            exp_avg_sqs, steps)):
        for label, t in (("param", p), ("grad", g), ("exp_avg", m),
                         ("exp_avg_sq", v), ("step", s)):
            if t.device != dev:
                raise ValueError(f"adamw: leaf {i}'s {label} on {t.device}, "
                                 f"the first leaf on {dev}")
        if p.dtype not in lib.IO_CODES:
            raise TypeError(f"adamw: leaf {i} is {p.dtype}; the kernel takes "
                            "float32 or bfloat16")
        for label, t in (("grad", g), ("exp_avg", m), ("exp_avg_sq", v)):
            if t.dtype != p.dtype or t.shape != p.shape:
                raise TypeError(f"adamw: leaf {i}'s {label} must be "
                                f"{p.dtype} {tuple(p.shape)}, got {t.dtype} "
                                f"{tuple(t.shape)}")
        if not all(t.is_contiguous() for t in (p, g, m, v)):
            raise ValueError(f"adamw: leaf {i}'s tensors must be contiguous")
        if s.dtype != torch.float32 or s.numel() != 1:
            raise TypeError(f"adamw: leaf {i}'s step must be one float32, "
                            f"got {s.dtype} {tuple(s.shape)}")


@torch.no_grad()
def adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
          exp_avgs: Sequence[torch.Tensor],
          exp_avg_sqs: Sequence[torch.Tensor],
          steps: Sequence[torch.Tensor], *, lr: float, beta1: float,
          beta2: float, eps: float, weight_decay: float,
          done: torch.Tensor = None) -> None:
    """One AdamW step of every leaf, in place: p, its first and second
    moments and its step count.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise: one launch for the leaves of each type, a few where they
    outnumber the kernel's table.  `done` is the launches' arrival counter,
    one int32 that is 0 between launches, owned by the caller (`AdamW`
    keeps one a device) and required on CUDA.  Each launch counts the
    values it updates in the launch table (`lib.counts`)."""
    if not params:
        return
    if params[0].device.type == "cpu":
        adamw_reference(params, grads, exp_avgs, exp_avg_sqs, steps, lr=lr,
                        beta1=beta1, beta2=beta2, eps=eps,
                        weight_decay=weight_decay)
        return
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, done)
    floats = _scalars(lr, beta1, beta2, eps, weight_decay)
    most = lib.kernel("adamw", "adamw_max_leaves")()
    leaves = list(zip(params, grads, exp_avgs, exp_avg_sqs, steps))
    for dtype in sorted({p.dtype for p in params}, key=str):
        of_type = [leaf for leaf in leaves if leaf[0].dtype == dtype]
        for at in range(0, len(of_type), most):
            part = of_type[at:at + most]
            table = torch.tensor(
                [[t.data_ptr() for t in leaf] + [leaf[0].numel()]
                 for leaf in part], dtype=torch.int64)
            lib.launch("adamw", done, [table, done],
                       [len(part), lib.IO_CODES[dtype]], floats,
                       values=sum(leaf[0].numel() for leaf in part))


def _scalar_dtype() -> torch.dtype:
    """The type torch.optim makes a step count in: float64 under a float64
    default type, else float32."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


class AdamW(torch.optim.AdamW):
    """torch.optim.AdamW whose update is `adamw`: the kernel on a CUDA
    device, one pass over each leaf's bytes, capturable in a CUDA graph;
    the plain version on the CPU.

    Everything else is torch's: `param_groups`, `state[p]` with "step",
    "exp_avg" and "exp_avg_sq" made as torch makes them, `state_dict` /
    `load_state_dict` in its layout, `zero_grad`, the step hooks.  A state
    zeroed in place is a fresh optimizer's.

    Raises ValueError on construction or at a step for what the kernel does
    not take: amsgrad, maximize, differentiable, fused, a tensor lr or
    beta, and on a CUDA device capturable=False (the kernel reads the step
    count on the device); RuntimeError on a sparse gradient."""

    def __init__(self, params, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, amsgrad: bool = False, *,
                 maximize: bool = False, capturable: bool = False,
                 differentiable: bool = False) -> None:
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, amsgrad=amsgrad,
                         maximize=maximize, capturable=capturable,
                         differentiable=differentiable)
        for group in self.param_groups:
            _check_group(group)
        self._done = {}

    def _counter(self, device: torch.device) -> torch.Tensor:
        """This optimizer's arrival counter on `device` (csrc/adamw.cu)."""
        if device not in self._done:
            self._done[device] = torch.zeros((), dtype=torch.int32,
                                             device=device)
        return self._done[device]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            _check_group(group)
            by_device = {}   # device -> [params, grads, m, v, steps]
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise RuntimeError("AdamW does not take sparse gradients")
                state = self.state[p]
                if not state:
                    state["step"] = (
                        torch.zeros((), dtype=_scalar_dtype(), device=p.device)
                        if group["capturable"]
                        else torch.tensor(0.0, dtype=_scalar_dtype()))
                    for key in ("exp_avg", "exp_avg_sq"):
                        state[key] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                lists = by_device.setdefault(p.device, ([], [], [], [], []))
                for out, t in zip(lists, (p, p.grad, state["exp_avg"],
                                          state["exp_avg_sq"],
                                          state["step"])):
                    out.append(t)
            beta1, beta2 = group["betas"]
            for dev, lists in by_device.items():
                adamw(*lists, lr=group["lr"], beta1=beta1, beta2=beta2,
                      eps=group["eps"], weight_decay=group["weight_decay"],
                      done=self._counter(dev) if dev.type == "cuda" else None)
        return loss


def _check_group(group: dict) -> None:
    """Raise for a parameter group's options the kernel does not take."""
    for key in ("amsgrad", "maximize", "differentiable", "fused"):
        if group.get(key):
            raise ValueError(f"AdamW: {key}=True is not supported; the "
                             "update kernel implements plain AdamW")
    if any(torch.is_tensor(x) for x in (group["lr"], *group["betas"])):
        raise ValueError("AdamW: lr and betas must be numbers")
    if not group["capturable"] and any(p.is_cuda for p in group["params"]):
        raise ValueError("AdamW: on a CUDA device the update kernel reads "
                         "the step count there: pass capturable=True")
