"""Plain backbones with DCNv2, their loss and AdamW, in float32: the
reference every cell is held against.

`dcn_resnet` is ResNet (He et al. 2016, arXiv:1512.03385) with a
modulated deformable 3x3 conv in every bottleneck of stages c3-c5 (Zhu et
al. 2019, arXiv:1811.11168 §4), GroupNorm(32) in place of BatchNorm (Wu &
He 2018, arXiv:1803.08494), the stride on the 3x3 conv, and a pooled
linear head.  The bottleneck and the deformable conv take 2D and 3D
inputs alike.  The parameters come in a dict keyed by the names the program's modules give
them, which the benchmark makes from the seed and hands to both sides;
nothing here imports the program.

Every function takes `precision`: "float32" (the reference; the caller
turns TF32 off) or "bfloat16" (the control: every product's operands and
output rounded to bfloat16, the rest in float32), and an optional
`flops` list that each conv, deformable conv and linear appends its
forward operations to (2 per multiply-add), counted from shapes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .deform import deform_conv

GN_EPS = 1e-6   # the program's GroupNorm epsilon (flax's default)


def _count(flops, out: torch.Tensor, fan_in: int) -> None:
    if flops is not None:
        flops.append(2 * out.numel() * fan_in)


def conv(x, w, b=None, stride=1, padding=0, precision="float32",
         flops=None):
    """A dense 2D or 3D convolution."""
    fn = F.conv2d if w.dim() == 4 else F.conv3d
    if precision == "bfloat16":
        bf = torch.bfloat16
        y = fn(x.to(bf), w.to(bf), None if b is None else b.to(bf), stride,
               padding).float()
    else:
        y = fn(x, w, b, stride, padding)
    _count(flops, y, w[0].numel())
    return y


def linear(x, w, b, precision="float32", flops=None):
    if precision == "bfloat16":
        y = F.linear(x.to(torch.bfloat16), w.to(torch.bfloat16),
                     b.to(torch.bfloat16)).float()
    else:
        y = F.linear(x, w, b)
    _count(flops, y, w.shape[1])
    return y


def conv_norm(p, name, x, k, stride=1, relu=True, precision="float32",
              flops=None):
    """conv (k x k, no bias, pad k // 2) -> GroupNorm(min(32, C)) -> ReLU."""
    w = p[f"{name}.conv.weight"]
    y = conv(x, w, None, stride, k // 2, precision, flops)
    y = F.group_norm(y, min(32, y.shape[1]), p[f"{name}.norm.weight"],
                     p[f"{name}.norm.bias"], GN_EPS)
    return F.relu(y) if relu else y


def dcn_pack(p, name, x, stride, precision="float32", flops=None):
    """A DCNv2 layer with its predictors: offsets and a sigmoid mask from
    plain convs of x on the output grid, then the deformable conv."""
    w = p[f"{name}.weight"]
    k = w.shape[2]
    off = conv(x, p[f"{name}.conv_offset.weight"],
               p[f"{name}.conv_offset.bias"], stride, k // 2, precision,
               flops)
    mask = torch.sigmoid(conv(x, p[f"{name}.conv_mask.weight"],
                              p[f"{name}.conv_mask.bias"], stride, k // 2,
                              precision, flops))
    y = deform_conv(x, off, mask, w, None, stride, k // 2, 1, 1,
                    mask.shape[1] // math.prod(w.shape[2:]), precision)
    _count(flops, y, w[0].numel())
    return y


def bottleneck(p, name, x, stride, deformable, precision, flops):
    y = conv_norm(p, f"{name}.conv1", x, 1, precision=precision, flops=flops)
    if deformable:
        y = dcn_pack(p, f"{name}.dcn", y, stride, precision, flops)
    else:
        y = conv_norm(p, f"{name}.conv2", y, 3, stride, precision=precision,
                      flops=flops)
    y = conv_norm(p, f"{name}.conv3", F.relu(y), 1, relu=False,
                  precision=precision, flops=flops)
    if f"{name}.proj.conv.weight" in p:
        x = conv_norm(p, f"{name}.proj", x, 1, stride, relu=False,
                      precision=precision, flops=flops)
    return F.relu(y + x)


RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def dcn_resnet(p: Dict[str, torch.Tensor], x: torch.Tensor, depth: int = 50,
               precision: str = "float32",
               flops: Optional[List[int]] = None, **_) -> torch.Tensor:
    """Logits of images x (B, 3, H, W): a 7x7/2 stem and a 3x3/2 max
    pool, stages c2-c5 (DCN in c3-c5, the first block of c3-c5 at stride
    2), the spatial mean and `fc`."""
    y = conv_norm(p, "stem", x, 7, 2, precision=precision, flops=flops)
    y = F.max_pool2d(y, 3, 2, 1)
    for i, n in enumerate(RESNET_BLOCKS[depth]):
        for j in range(n):
            y = bottleneck(p, f"c{i + 2}.block{j}", y,
                           2 if i > 0 and j == 0 else 1, i > 0, precision,
                           flops)
    return linear(y.mean((2, 3)), p["fc.weight"], p["fc.bias"], precision,
                  flops)


def _conv_norm_shapes(name, cout, cin, k, nd):
    return [(f"{name}.conv.weight", (cout, cin) + (k,) * nd),
            (f"{name}.norm.weight", (cout,)), (f"{name}.norm.bias", (cout,))]


def _bottleneck_shapes(name, cin, mid, cout, stride, deformable, dg, nd):
    k = 3 ** nd
    out = _conv_norm_shapes(f"{name}.conv1", mid, cin, 1, nd)
    if deformable:
        out += [(f"{name}.dcn.weight", (mid, mid) + (3,) * nd),
                (f"{name}.dcn.conv_offset.weight", (dg * nd * k, mid)
                 + (3,) * nd),
                (f"{name}.dcn.conv_offset.bias", (dg * nd * k,)),
                (f"{name}.dcn.conv_mask.weight", (dg * k, mid) + (3,) * nd),
                (f"{name}.dcn.conv_mask.bias", (dg * k,))]
    else:
        out += _conv_norm_shapes(f"{name}.conv2", mid, mid, 3, nd)
    out += _conv_norm_shapes(f"{name}.conv3", cout, mid, 1, nd)
    if cin != cout or stride != 1:
        out += _conv_norm_shapes(f"{name}.proj", cout, cin, 1, nd)
    return out


def dcn_resnet_shapes(depth: int = 50, width: int = 64,
                      num_classes: int = 1000, deformable_groups: int = 1,
                      **_):
    """(name, shape) of every parameter of `dcn_resnet`."""
    out = _conv_norm_shapes("stem", width, 3, 7, 2)
    cin = width
    for i, n in enumerate(RESNET_BLOCKS[depth]):
        mid, cout = width * 2 ** i, width * 4 * 2 ** i
        for j in range(n):
            out += _bottleneck_shapes(f"c{i + 2}.block{j}", cin, mid, cout,
                                      2 if i > 0 and j == 0 else 1, i > 0,
                                      deformable_groups, 2)
            cin = cout
    return out + [("fc.weight", (num_classes, cin)),
                  ("fc.bias", (num_classes,))]


# forward, parameter shapes
MODELS = {"dcn_resnet": (dcn_resnet, dcn_resnet_shapes)}


class AdamW:
    """AdamW (Loshchilov & Hutter 2019) as torch.optim.AdamW computes it:
    decoupled decay, then the bias-corrected moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr=1e-3,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(forward, params: Dict[str, torch.Tensor], batches,
                precision: str = "float32", half_batch: bool = False,
                **model_kw) -> dict:
    """AdamW steps of softmax cross-entropy on `batches` [(x, y), ...],
    from `params` (copied, not changed).  Returns each step's loss, the
    first step's gradient by leaf and the change of every leaf over all
    the steps.  `half_batch` takes each step's loss over the first half
    of its batch alone: a fault the comparison has to catch."""
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(p)
    losses, first_grad = [], None
    for x, y in batches:
        if half_batch:
            x, y = x[:max(1, len(x) // 2)], y[:max(1, len(y) // 2)]
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = F.cross_entropy(forward(leaves, x, precision=precision,
                                       **model_kw), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        for v in p.values():
            v.requires_grad_(False)
        if first_grad is None:
            first_grad = grads
        opt.step(p, grads)
        losses.append(float(loss.detach()))
        del loss, grads
    delta = {k: p[k] - params[k] for k in p}
    return {"losses": losses, "first_grad": first_grad, "delta": delta}
