"""The frozen reference: its deformable conv against explicit loops, and
its backbones against the program's plain path (impl="torch") at a tiny
width on the CPU.  Only this test imports the program beside the
reference; the reference itself imports nothing of it."""
import itertools
import math

import pytest
import torch

from dcnbench import weights
from dcnbench.reference import backbone
from dcnbench.reference.deform import deform_conv, out_size

def deform_conv_loop(x, offset, mask, weight, bias=None, stride=1,
                     padding=0, dilation=1, groups=1, deformable_groups=1):
    """The same convolution as explicit loops over every output point, tap
    and corner, in float64."""
    nd = x.dim() - 2
    tup = lambda v: tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd
    stride, padding, dilation = tup(stride), tup(padding), tup(dilation)
    x, offset, weight = x.double(), offset.double(), weight.double()
    B, C = x.shape[:2]
    S, ks = tuple(x.shape[2:]), tuple(weight.shape[2:])
    O = weight.shape[0]
    OS = tuple(out_size(S[d], ks[d], stride[d], padding[d], dilation[d])
               for d in range(nd))
    Cg, Og, Cdg = C // groups, O // groups, C // deformable_groups
    taps = list(itertools.product(*[range(k) for k in ks]))
    out = torch.zeros((B, O) + OS, dtype=torch.float64)
    for b in range(B):
        for o in itertools.product(*[range(s) for s in OS]):
            for c in range(C):
                g = c // Cdg
                for f, tap in enumerate(taps):
                    pos = [o[d] * stride[d] - padding[d] + tap[d] * dilation[d]
                           + float(offset[(b, g * nd * len(taps) + nd * f + d)
                                          + o]) for d in range(nd)]
                    if any(p <= -1 or p >= S[d] for d, p in enumerate(pos)):
                        continue
                    val = 0.0
                    for corner in itertools.product((0, 1), repeat=nd):
                        idx, w = [], 1.0
                        for d in range(nd):
                            lo = math.floor(pos[d])
                            fr = pos[d] - lo
                            idx.append(lo + corner[d])
                            w *= fr if corner[d] else 1 - fr
                        if all(0 <= i < S[d] for d, i in enumerate(idx)):
                            val += w * float(x[(b, c) + tuple(idx)])
                    if mask is not None:
                        val *= float(mask[(b, g * len(taps) + f) + o])
                    gi = c // Cg
                    for oc in range(gi * Og, (gi + 1) * Og):
                        out[(b, oc) + o] += (
                            float(weight[(oc, c - gi * Cg) + tap]) * val)
    if bias is not None:
        out += bias.double().reshape((1, O) + (1,) * nd)
    return out


CASES = [
    # nd, B, C, O, S, stride, pad, dil, groups, dg, modulated, bias
    (2, 2, 4, 6, (5, 6), 1, 1, 1, 1, 1, True, False),
    (2, 1, 4, 4, (6, 5), 2, 1, 1, 2, 2, True, True),
    (2, 1, 4, 2, (5, 5), 1, 2, 2, 1, 2, False, False),
    (3, 1, 2, 3, (3, 4, 4), 1, 1, 1, 1, 1, True, False),
    (3, 1, 4, 2, (4, 3, 4), (1, 2, 1), 1, 1, 2, 2, False, True),
]


@pytest.mark.parametrize("case", CASES)
def test_deform_conv_matches_loops(case):
    nd, B, C, O, S, stride, pad, dil, g, dg, modulated, with_bias = case
    gen = torch.Generator().manual_seed(len(S) + C + O)
    st = stride if isinstance(stride, tuple) else (stride,) * nd
    OS = tuple((S[d] + 2 * pad - dil * 2 - 1) // st[d] + 1 for d in range(nd))
    K = 3 ** nd
    x = torch.randn((B, C) + S, generator=gen, dtype=torch.float64)
    # Offsets up to 3 px: taps cross the border and the open-interval gate.
    off = 3 * (2 * torch.rand((B, dg * nd * K) + OS, generator=gen,
                              dtype=torch.float64) - 1)
    mask = (torch.rand((B, dg * K) + OS, generator=gen, dtype=torch.float64)
            if modulated else None)
    w = torch.randn((O, C // g) + (3,) * nd, generator=gen,
                    dtype=torch.float64)
    b = torch.randn(O, generator=gen, dtype=torch.float64) if with_bias else None
    got = deform_conv(x, off, mask, w, b, stride, pad, dil, g, dg)
    want = deform_conv_loop(x, off, mask, w, b, stride, pad, dil, g, dg)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_deform_conv_blocks_and_gradients_agree():
    """Running in blocks of samples (under checkpointing) changes nothing,
    forward or backward."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((3, 4, 6, 6), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    off = torch.randn((3, 18, 6, 6), generator=gen, dtype=torch.float64,
                      requires_grad=True)
    mask = torch.rand((3, 9, 6, 6), generator=gen, dtype=torch.float64,
                      requires_grad=True)
    w = torch.randn((4, 4, 3, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    outs = []
    for col_bytes in (1 << 30, 1):   # all samples at once; one at a time
        y = deform_conv(x, off, mask, w, None, 1, 1, col_bytes=col_bytes)
        grads = torch.autograd.grad((y ** 2).sum(), (x, off, mask, w))
        outs.append((y.detach(),) + grads)
    for a, b in zip(*outs):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


RULES = [["norm.weight", "const", 1.0], ["norm.bias", "const", 0.0],
         ["conv_offset.weight", "fan_in_uniform", 2.0],
         ["conv_mask.weight", "fan_in_uniform", 2.0],
         ["bias", "const", 0.0], ["weight", "fan_in_uniform", 1.0]]


@pytest.mark.parametrize("model, cls, args, shape", [
    ("dcn_resnet", "DCNResNet",
     {"depth": 50, "width": 4, "num_classes": 10, "deformable_groups": 1},
     (2, 3, 40, 48)),
    ("dcn_resnet", "DCNResNet",
     {"depth": 50, "width": 4, "num_classes": 10, "deformable_groups": 2},
     (2, 3, 56, 36)),
])
def test_reference_backbone_matches_the_program(model, cls, args, shape):
    """The reference's parameter list loads into the program's network
    (strict), and both give the same logits and gradients in float64."""
    import modulated_deform_conv_tpu_torch as port
    forward, shapes = backbone.MODELS[model]
    params = weights.make_params(shapes(**args), RULES, 7, "cpu",
                                 dtype=torch.float64)
    net = getattr(port, cls)(**args, impl="torch", device="cpu",
                             dtype=torch.float64)
    net.load_state_dict(params, strict=True)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    y = torch.tensor([1, 7])
    loss = torch.nn.functional.cross_entropy(net(x), y)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ref = torch.nn.functional.cross_entropy(forward(leaves, x, **args), y)
    grads = torch.autograd.grad(ref, list(leaves.values()))
    assert math.isclose(float(loss.detach()), float(ref.detach()), rel_tol=1e-12)
    named = dict(net.named_parameters())
    for (k, v), g in zip(leaves.items(), grads):
        assert torch.allclose(named[k].grad, g, rtol=1e-8, atol=1e-10), k
