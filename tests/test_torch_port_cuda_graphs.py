"""The captured step (utils/graphs.py) on the card: the port's kernels
inside CUDA graphs.

Marked `cuda`: each test skips without an NVIDIA GPU.  Imports no JAX:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_cuda_graphs.py -q

* one kernel wrapper (`shiftblend_fwd`) captured and replayed on new inputs
  copied into the static ones: the replay equals an eager call on those
  inputs bit for bit;
* the public ops' training step (out and the gradients of sum(out^2) in
  all five inputs) on each kernel pair, 2D and 3D, and the columns path:
  every replay on new inputs bit-equal to eager, and the twelve kernels
  inside the graphs between them;
* `debug_check_bounds` inside a capture: no host read while capturing, the
  warning when the step's loss is read, none within the bound;
* the trainer, captured against eager from the same initial parameters:
  the same losses and parameters, bit for bit;
* the chain timer's chains (`graphs.chain`, `graphs.time_chain`): a
  captured chain of config-2 training steps on the bounded pair ends in
  the outputs of one eager step, SHA-256 equal, at N_LO and N_HI calls;
  its peak memory at N_HI is within 5% of N_LO's (each call's workspaces
  and outputs reused in the graph's pool); shift-blend's lead mode on
  cfg2-H4's interior shard (calibrate's lead sweep step) captures and
  replays bit-equal to eager, and times.
"""
import hashlib
import warnings

import numpy as np
import pytest
import torch

import modulated_deform_conv_tpu_torch as mdt
from modulated_deform_conv_tpu_torch import calibrate
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import train
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.ops.cuda import lib
from modulated_deform_conv_tpu_torch.ops.cuda import shiftblend as sb
from modulated_deform_conv_tpu_torch.parallel import sharding as sh
from modulated_deform_conv_tpu_torch.utils import graphs
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module "
                    "docstring)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.fixture
def deterministic():
    """cuDNN deterministic for one test, put back after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _inputs(dev, seed, B, C, O, S, nd, offscale, k=3):
    """x, offset, mask, weight, bias of a stride-1, size-preserving config
    (one deformable group per 8 channels), from a numpy seed."""
    rng = np.random.default_rng(seed)
    K = k ** nd
    dg = C // 8
    arrs = [rng.standard_normal((B, C) + S),
            rng.uniform(-offscale, offscale, (B, dg * nd * K) + S),
            rng.uniform(0, 1, (B, dg * K) + S),
            rng.standard_normal((O, C) + (k,) * nd) * 0.1,
            rng.standard_normal((O,))]
    return dg, [torch.tensor(a, dtype=torch.float32, device=dev)
                for a in arrs]


def _columns(nd):
    """The columns path's entry (column kernels and cuBLAS) whatever the
    fuse rule says."""
    def op(x, off, mask, w, b, dg):
        spec = DeformConvSpec.make(nd, 3, 1, 1, 1, 1, dg, modulated=True)
        return gm.deform_conv_cols(x, off, mask, w, b, spec)
    return op


def _public(nd, **kw):
    fn = (mdt.modulated_deform_conv2d if nd == 2
          else mdt.modulated_deform_conv3d)
    return lambda x, off, mask, w, b, dg: fn(x, off, mask, w, b, 1, 1, 1, 1,
                                             dg, **kw)


# name -> (rank, op, its kernels, B, C, O, S)
CASES = {
    "2d shiftblend": (2, _public(2, impl="shiftblend", offset_bound=1.0),
                      ("shiftblend_fwd", "shiftblend_bwd"), 2, 16, 24,
                      (12, 10)),
    "2d gather": (2, _public(2, impl="cuda"),
                  ("gathermm_fwd", "gathermm_bwd"), 2, 16, 24, (12, 10)),
    "2d columns": (2, _columns(2), ("gathermm_cols_fwd", "gathermm_cols_bwd"),
                   2, 16, 24, (12, 10)),
    "3d shiftblend": (3, _public(3, impl="shiftblend", offset_bound=1.0),
                      ("shiftblend3d_fwd", "shiftblend3d_bwd"), 1, 16, 8,
                      (4, 8, 16)),
    "3d gather": (3, _public(3, impl="cuda"),
                  ("gathermm3d_fwd", "gathermm3d_bwd"), 1, 16, 8, (4, 6, 5)),
    "3d columns": (3, _columns(3),
                   ("gathermm3d_cols_fwd", "gathermm3d_cols_bwd"), 1, 16, 8,
                   (4, 6, 5)),
}


def _step(op, dg):
    def step(x, off, mask, w, b):
        out = op(x, off, mask, w, b, dg)
        return (out.detach(),) + torch.autograd.grad(
            (out * out).sum(), (x, off, mask, w, b))
    return step


def _leaves(ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def test_one_kernel_captured_replays_new_inputs(dev):
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 2, modulated=True)
    _, ins = _inputs(dev, 0, 2, 16, 24, (12, 10), 2, 1.0)
    _, new = _inputs(dev, 1, 2, 16, 24, (12, 10), 2, 1.0)

    def fwd(x, off, mask, w, b):
        return sb.fwd(x, off, mask, w, b, spec, "tensorfloat32", 1.0)

    step = graphs.capture(fwd, *ins)
    assert step.kernels == {"shiftblend_fwd": 1}
    first = step().clone()
    assert torch.equal(first, fwd(*ins))
    launches = lib.counts().launches
    got = step(*new)
    assert lib.counts().launches == launches   # a replay counts nothing
    want = fwd(*new)
    assert not torch.equal(want, first)
    assert torch.equal(got, want)
    # An input that copy_ would broadcast or cast is refused.
    for bad in (new[0][:1], new[0].bfloat16()):
        with pytest.raises(ValueError, match="needs a new capture"):
            step(bad, *new[1:])


def test_op_steps_replay_bitwise_and_hold_all_twelve(dev):
    held = set()
    for name, (nd, op, kernels, B, C, O, S) in CASES.items():
        dg, ins = _inputs(dev, 2, B, C, O, S, nd, 1.0)
        _, new = _inputs(dev, 3, B, C, O, S, nd, 1.0)
        step = graphs.capture(_step(op, dg), *_leaves(ins))
        assert set(kernels) <= set(step.kernels), (name, step.kernels)
        held |= set(step.kernels)
        got = [t.clone() for t in step(*new)]
        want = _step(op, dg)(*_leaves(new))
        for label, g, w in zip(("out", "x", "offset", "mask", "weight",
                                "bias"), got, want):
            assert torch.equal(g, w), f"{name}: {label} differs from eager"
    assert held == set(lib.KERNELS)


def test_debug_check_bounds_inside_capture(dev):
    _, ins = _inputs(dev, 4, 1, 16, 8, (10, 10), 2, 3.0)
    inside = ins[1].clamp(-0.5, 0.5)

    def loss(x, off, mask, w, b):
        out = mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, 1, 2,
                                          offset_bound=1.0,
                                          debug_check_bounds=True)
        return (out * out).sum()

    # Captured on offsets within the bound: the warm-up's eager checks
    # pass, and the capture reads nothing on the host.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = graphs.capture(loss, ins[0], inside, *ins[2:])
        step.read(step())
    assert step.bounds.flags is not None and len(step.bounds.bounds) == 1
    with pytest.warns(UserWarning, match="exceeds the declared offset_bound"):
        value = step.read(step(*ins))
    assert value == pytest.approx(float(loss(*ins)), rel=1e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step.read(step(ins[0], inside, *ins[2:]))


def test_trainer_captured_matches_eager(dev, deterministic):
    kw = dict(steps=3, batch=2, width=8, classes=10, size=32, device="cuda",
              log=lambda s: None)
    cap = train(**kw)
    ref = train(eager=True, **kw)
    assert {"gathermm_fwd", "gathermm_bwd"} <= set(cap["kernels"])
    # The same launches in the same order, cuDNN deterministic and AdamW
    # capturable both ways: the same bits.
    assert cap["losses"] == ref["losses"]
    own = ref["model"].state_dict()
    for k, v in cap["model"].state_dict().items():
        assert torch.equal(v, own[k]), k


def _sha(ts):
    return [hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                           .numpy().tobytes()).hexdigest() for t in ts]


def _cfg2_bounded(dev):
    """Config 2 (B=8, 256 -> 256, 56x56, g = dg = 4, bias, offsets
    U[-2, 2]) and its training step on the shift-blend pair."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal((8, 256, 56, 56)),
            rng.uniform(-2, 2, (8, 72, 56, 56)),
            rng.uniform(0, 1, (8, 36, 56, 56)),
            rng.standard_normal((256, 64, 3, 3)) * 0.05,
            rng.standard_normal((256,)) * 0.1]
    ins = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]

    def op(x, off, mask, w, b, dg):
        return mdt.modulated_deform_conv2d(x, off, mask, w, b, 1, 1, 1, 4,
                                           dg, offset_bound=2.0,
                                           impl="shiftblend")
    return _step(op, 4), ins


def test_chain_ends_in_one_eager_step(dev):
    step, ins = _cfg2_bounded(dev)
    want = _sha(step(*_leaves(ins)))
    for n in (graphs.N_LO, graphs.N_HI):
        chained = graphs.capture(graphs.chain(step, n), *_leaves(ins))
        assert chained.kernels == {"shiftblend_fwd": n, "shiftblend_bwd": n}
        assert _sha(chained()) == want, n
        del chained


def test_chain_memory_does_not_grow_with_n(dev):
    step, ins = _cfg2_bounded(dev)
    leaves = _leaves(ins)
    peak = {}
    for n in (graphs.N_LO, graphs.N_HI):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        chained = graphs.capture(graphs.chain(step, n), *leaves)
        chained()
        torch.cuda.synchronize()
        peak[n] = torch.cuda.max_memory_allocated() - base
        del chained
    assert peak[graphs.N_HI] <= 1.05 * peak[graphs.N_LO], peak


def test_lead_shard_step_captures_and_times(dev):
    spec, shards, coords, leaves = calibrate.lead_case(dev, "cfg2-H4", 64)

    def lead(x, off, mask, w, b):
        return sh.shard_conv(x, off, mask, w, b, spec, shards, coords,
                             calibrate.LEAD_MAX_OFFSET, "auto",
                             "tensorfloat32", lead=True)
    step = _step(lambda x, off, mask, w, b, dg: lead(x, off, mask, w, b),
                 None)
    want = _sha(step(*_leaves(leaves)))
    captured = graphs.capture(step, *_leaves(leaves))
    assert set(captured.kernels) == {"shiftblend_fwd", "shiftblend_bwd"}
    assert _sha(captured()) == want
    del captured
    timed = graphs.time_chain(step, *_leaves(leaves))
    lo, hi = timed["kernels"]["lo"], timed["kernels"]["hi"]
    assert set(lo) == set(hi) == {"shiftblend_fwd", "shiftblend_bwd"}
    assert all(hi[k] * graphs.N_LO == lo[k] * graphs.N_HI for k in lo)
    assert 0 < timed["ms"] and timed["spread"] < 0.5
