"""GroupNorm with its epilogue (ops/cuda/groupnorm.py) on the CPU: the
kernels' plain version, their plan, and the backbone's call sites.  The
kernels themselves run on the card (tests/test_torch_port_groupnorm_cuda.py).

* the kernels' plain version against `F.group_norm` (+ identity) +
  `F.relu` in float64, forward and backward (x, weight, bias and
  identity), at 2D and 3D shapes with 2 channels a group, spatial sizes
  that are no multiple of any tile, and a batch of one; off the card
  `group_norm_act` is torch's ops;
* `plan` on the H100's limits at every GroupNorm layer shape of the
  benchmark's cells: a
  cluster past one block where a group alone would not fill the card or
  would overflow shared memory, one pass where the slice fits, the
  re-reading route past MAX_CLUSTER slices that fit;
* DCNResNet-50's and DCNResNet3d-50's 40 norms each through the op, the
  16 residual adds and 36 ReLUs folded in, over the values a sample the
  card's counters expect;
* on CPU tensors the kernel wrappers raise and the op counts no launch.
"""
import functools
import math

import pytest
import torch
import torch.nn.functional as F

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch.models import backbone
from modulated_deform_conv_tpu_torch.ops.cuda import groupnorm as gn
from modulated_deform_conv_tpu_torch.ops.cuda import lib

EPS = 1e-6
# (x's shape, groups): 2D with 2 channels a group and a 5 x 7 plane, B=1
# with 64 channels a group at 7 x 7 (DCNResNet-50's c5), 3D with 2
# channels a group at 3 x 5 x 3, and one value a channel.
SHAPES = [((2, 8, 5, 7), 4), ((1, 2048, 7, 7), 32), ((2, 6, 3, 5, 3), 3),
          ((3, 8, 1), 4)]
# (relu, identity): ConvBN, a projection, a bottleneck's conv3, an add
# without ReLU.
EPILOGUES = [(True, False), (False, False), (True, True), (False, True)]


def _torch_op(x, G, w, b, identity, relu):
    y = F.group_norm(x, G, w, b, EPS)
    if identity is not None:
        y = y + identity
    return F.relu(y) if relu else y


@pytest.mark.parametrize("relu,with_identity", EPILOGUES)
@pytest.mark.parametrize("shape,G", SHAPES)
def test_plain_version_matches_torch(shape, G, relu, with_identity):
    g = torch.Generator().manual_seed(sum(shape) + G)
    leaves = [torch.randn(shape, generator=g, dtype=torch.float64) * 3 + 1,
              torch.randn(shape[1], generator=g, dtype=torch.float64),
              torch.randn(shape[1], generator=g, dtype=torch.float64),
              torch.randn(shape, generator=g, dtype=torch.float64)]
    leaves = [t.requires_grad_(True) for t in leaves]
    x, w, b, identity = leaves
    identity = identity if with_identity else None
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    want = _torch_op(x, G, w, b, identity, relu)
    ins = leaves[:3] + ([identity] if with_identity else [])
    grads = torch.autograd.grad(want, ins, dy)
    y, mean, rstd = gn.group_norm_reference(
        x.detach(), G, w.detach(), b.detach(), EPS,
        None if identity is None else identity.detach(), relu)
    assert y.dtype == torch.float64 and mean.shape == (shape[0], G)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    got = gn.group_norm_backward_reference(dy, x.detach(), y, w.detach(), G,
                                           EPS, relu, with_identity)
    assert (got[3] is None) == (not with_identity)
    for a, e in zip([t for t in got if t is not None], grads):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10)
    # Off the card the op is torch's, op by op.
    assert torch.equal(gn.group_norm_act(x, G, w, b, EPS, identity, relu),
                       want)


def test_plain_version_keeps_types_and_statistics():
    """bfloat16 activations with float32 parameters: y in bfloat16, the
    statistics in float64, mean and rstd those of the group."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 8, 6, 6, generator=g) * 2 + 5).to(torch.bfloat16)
    w, b = torch.randn(8, generator=g), torch.randn(8, generator=g)
    y, mean, rstd = gn.group_norm_reference(x, 4, w, b, EPS, relu=True)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float64
    xg = x.double().reshape(2, 4, -1)
    torch.testing.assert_close(mean, xg.mean(-1))
    torch.testing.assert_close(rstd, (xg.var(-1, unbiased=False) + EPS)
                               .rsqrt())
    assert bool((y >= 0).all())


NETS = {"DCNResNet-50": (lambda: mdt.DCNResNet(device="meta"),
                         (8, 3, 224, 224), 82_690_048),
        "DCNResNet3d-50": (lambda: mdt.DCNResNet3d(device="meta"),
                           (32, 3, 16, 112, 112), 524_140_544)}


@functools.lru_cache(maxsize=None)
def _net_layers(name, batch):
    make, shape, _ = NETS[name]
    return gn.norm_calls(make(), (batch,) + shape[1:])


@pytest.mark.parametrize("name", sorted(NETS))
def test_every_norm_of_the_networks_runs_the_op(name):
    make, shape, values = NETS[name]
    assert {m.eps for m in make().modules()
            if isinstance(m, torch.nn.GroupNorm)} == {EPS}
    calls = _net_layers(name, shape[0])
    assert len(calls) == 40
    assert sum(math.prod(s) for s, *_ in calls) == values
    assert sum(ident for *_, ident, _ in calls) == 16
    assert sum(relu for *_, relu in calls) == 36
    # Every residual add comes with the block's ReLU.
    assert all(relu for *_, ident, relu in calls if ident)


def _cell_layers():
    """{(N, G, L)} of the three cells' norms."""
    out = set()
    for name, batch in (("DCNResNet-50", 8), ("DCNResNet-50", 1),
                        ("DCNResNet3d-50", 32)):
        for s, G, *_ in _net_layers(name, batch):
            out.add((batch, G, s[1] // G * math.prod(s[2:])))
    return out


# The H100 SXM's limits: 132 SMs, 228 KiB of shared memory an SM, and the
# kernels' four blocks an SM.
H100 = gn.Card(sms=132, blocks_per_sm=4, sm_shared=228 * 1024)


def test_plan_at_the_cells_layers():
    for N, G, L in sorted(_cell_layers()):
        for itemsize in (4, 2):
            for arrays in (1, 2):
                k, sl, chunk = gn.plan(N, G, L, itemsize, arrays, H100)
                assert k in (1, 2, 4, 8) and sl % gn.VEC == 0
                assert sl - gn.VEC < -(-L // k) <= sl
                # One pass everywhere: the slice stays in shared memory.
                assert chunk == sl
                assert sl * itemsize * arrays <= gn.SHARED_BYTES
                # A group splits past what shared memory asks for only
                # into blocks that all run at once, MAX_SPLIT at most.
                if k > 1 and (gn._slice(L, k // 2) * itemsize * arrays
                              <= gn.SHARED_PREFERRED):
                    assert k <= gn.MAX_SPLIT
                    assert N * G * k <= H100.sms * H100.blocks_per_sm
    # The 3D stem's 100,352-value groups: 8 blocks each way.
    assert gn.plan(32, 32, 100_352, 4, 1, H100)[0] == 8
    assert gn.plan(32, 32, 100_352, 4, 2, H100)[0] == 8
    # Serving's c5 groups at B=1 (32 groups): split for the card.
    assert gn.plan(1, 32, 3136, 4, 1, H100)[0] > 1
    # Training's 256 groups of DCNResNet-50's c5 stay one block each.
    assert gn.plan(8, 32, 784, 4, 1, H100)[0] == 1


def test_plan_rereads_past_the_largest_cluster():
    L = 8 * gn.SHARED_BYTES // 4 + 1000
    k, sl, chunk = gn.plan(2, 32, L, 4, 1, H100)
    assert k == gn.MAX_CLUSTER and k * sl >= L
    assert chunk < sl and chunk % gn.VEC == 0
    assert chunk * 4 <= gn.SHARED_BYTES < (chunk + gn.VEC) * 4


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    x = torch.randn(2, 8, 4, 4)
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_fwd(x, 4, w, b, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_bwd(x, x, x, torch.zeros(2, 4), torch.ones(2, 4), w, 4,
                         True, False)
    before = lib.counts()
    y = gn.group_norm_act(x.requires_grad_(True), 4, w, b, EPS, relu=True)
    y.sum().backward()
    assert lib.counts() == before
    with pytest.raises(ValueError, match="affine"):
        gn.group_norm_act(x, 4, None, None, EPS)
