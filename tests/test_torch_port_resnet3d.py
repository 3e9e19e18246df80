"""DCNResNet3d (models/backbone.py) against the benchmark's plain reference
(dcnbench/reference/resnet3d.py) on the CPU, in float64, where "auto" takes
the port's plain path:

* the parameters' names and shapes are the reference's, at the published
  size (57,463,756 values, 10,452,348 of them predictors) and a tiny one;
* a tiny network (width 4, 10 classes, two clips of 8 x 64 x 64) on the
  benchmark's draw of weights (predictors at its scale, so that offsets are
  fractional): the logits, every leaf's gradient of the cross-entropy loss
  and the parameters after one AdamW step of the trainer's `train_step`;
* a stride-2 ModulatedDeformConv3dPack alone: output and every gradient;
* the in-package trainer's `--arch resnet3d` on the tiny network;
* the model's stage spans: none with tracing off, and with it on
  "mdc.model.stem", "mdc.model.c2" .. "mdc.model.c5", each holding its
  stage's deformable ops;
* the column forward's values, counted in the launch table that a
  captured step reads, in 3D and 2D (the C side stubbed:
  tests/torch_launch_stub.py);
  tools/trace_cells.py's `stage_ms` arithmetic.

The clips are 8 x 64 x 64 rather than 4 x 16 x 16: at 16 x 16, c4 and c5
are one voxel, where GroupNorm of one value a group zeroes every
deformable layer's input after c4's first and leaves its gradients 0.
This file imports no JAX; the card's side is
tests/test_torch_port_resnet3d_cuda.py.
"""
import importlib.util
import json
import math
import pathlib
import statistics

import pytest
import torch
import torch.nn.functional as F

import modulated_deform_conv_tpu_torch as mdt
from dcnbench import weights
from dcnbench.reference import backbone as ref_backbone
from dcnbench.reference.resnet3d import MODELS
from modulated_deform_conv_tpu_torch.examples.train_dcn_resnet import (
    make_optimizer, train, train_step)
from modulated_deform_conv_tpu_torch.models.backbone import DCNStage
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm, lib
from modulated_deform_conv_tpu_torch.utils import profiling

from torch_launch_stub import stub_c_side

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "dcnbench" / "configs" / "dcn-r3d50.json")
                    .read_text())
FORWARD, SHAPES = MODELS["dcn_resnet3d"]
TINY = {"depth": 50, "width": 4, "num_classes": 10, "deformable_groups": 1}
CLIP = (3, 8, 64, 64)
# float64 on both sides; the sums run in other orders (the port's columns
# and products against the reference's per-corner gathers and einsum).
RTOL = 1e-9


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _net(args, device="cpu", dtype=torch.float64):
    return mdt.DCNResNet3d(num_classes=args["num_classes"],
                           depth=args["depth"], width=args["width"],
                           deformable_groups=args["deformable_groups"],
                           device=device, dtype=dtype)


def _close(got, want, scale, what):
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("args", [CONFIG["program"]["args"], TINY],
                         ids=["published", "tiny"])
def test_parameters_are_the_references(args):
    net = _net(args, "meta", torch.float32)
    got = [(n, tuple(p.shape)) for n, p in net.named_parameters()]
    assert got == [(n, tuple(s)) for n, s in SHAPES(**args)]
    assert not list(net.buffers())
    if args is TINY:
        return
    assert CONFIG["reference"]["args"] == args
    sizes = dict(got)
    assert sum(map(math.prod, sizes.values())) == 57_463_756
    assert sum(math.prod(s) for n, s in sizes.items()
               if ".conv_offset." in n or ".conv_mask." in n) == 10_452_348
    assert sum(n.endswith(".dcn.weight") for n in sizes) == 13
    assert sizes["stem.conv.weight"] == (64, 3, 7, 7, 7)
    assert sizes["c3.block0.dcn.conv_offset.weight"] == (81, 128, 3, 3, 3)
    assert sizes["fc.weight"] == (400, 2048)


def _tiny_case():
    params = weights.make_params(SHAPES(**TINY), CONFIG["init"], 2 ** 33 + 3,
                                 "cpu", torch.float64)
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2,) + CLIP, generator=g, dtype=torch.float64)
    y = torch.tensor([3, 7])
    return params, x, y


def test_logits_gradients_and_adamw_step_match_reference():
    params, x, y = _tiny_case()
    net = _net(TINY)
    net.load_state_dict(params, strict=True)
    with torch.no_grad():
        logits = net(x)
    ref = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = FORWARD(ref, x, **TINY)
    _close(logits, want.detach(), float(want.detach().abs().max()), "logits")

    opt = make_optimizer(net)
    loss = train_step(net, opt, x, y)
    ref_loss = F.cross_entropy(want, y)
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=RTOL)
    grads = dict(zip(ref, torch.autograd.grad(ref_loss, list(ref.values()))))
    # A leaf's gradient against its own largest value, or, for a leaf
    # whose gradient is nearly 0 (a GroupNorm's bias followed by another
    # GroupNorm), the median leaf's.
    floor = statistics.median(float(g.abs().max()) for g in grads.values())
    moved = dict(net.named_parameters())
    for k, g in grads.items():
        _close(moved[k].grad, g, max(float(g.abs().max()), floor), k)
    # Every deformable layer samples and is differentiated at this size.
    assert all(float(g.abs().max()) > 1e-3 * floor
               for k, g in grads.items() if k.endswith(".dcn.weight"))

    with torch.no_grad():
        p = {k: v.detach().clone() for k, v in params.items()}
        ref_backbone.AdamW(p).step(p, grads)
    # A first step moves a value by lr g / (|g| + eps): where a leaf's
    # gradient is round-off (below 1e-3 of the median leaf's, as
    # dcnbench/compare.py's MOVED), only by at most lr on both sides.
    lr = opt.param_groups[0]["lr"]
    norm = {k: float(g.norm()) for k, g in grads.items()}
    median = statistics.median(norm.values())
    for k, v in p.items():
        step = moved[k].detach() - params[k]
        if norm[k] < 1e-3 * median:
            assert float(step.abs().max()) <= 1.001 * lr, k
            assert float((v - params[k]).abs().max()) <= 1.001 * lr, k
            continue
        assert not torch.equal(moved[k].detach(), params[k]), k
        _close(moved[k].detach(), v, float(v.abs().max()), k)


def test_strided_pack_matches_reference():
    C, O = 8, 12
    shapes = [("l.weight", (O, C, 3, 3, 3)),
              ("l.conv_offset.weight", (81, C, 3, 3, 3)),
              ("l.conv_offset.bias", (81,)),
              ("l.conv_mask.weight", (27, C, 3, 3, 3)),
              ("l.conv_mask.bias", (27,))]
    params = weights.make_params(shapes, CONFIG["init"], 17, "cpu",
                                 torch.float64)
    pack = mdt.ModulatedDeformConv3dPack(
        C, O, 3, stride=2, padding=1, zero_init_offset=True,
        sigmoid_mask=True, device="cpu", dtype=torch.float64)
    pack.load_state_dict({k[2:]: v for k, v in params.items()}, strict=True)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, C, 5, 9, 8), generator=g, dtype=torch.float64)
    xp, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = pack(xp)
    want = ref_backbone.dcn_pack(leaves, "l", xr, 2)
    assert out.shape == want.shape == (2, O, 3, 5, 4)
    _close(out.detach(), want.detach(), float(want.detach().abs().max()),
           "out")
    gout = torch.randn(out.shape, generator=g, dtype=torch.float64)
    out.backward(gout)
    wanted = torch.autograd.grad(want, [xr] + list(leaves.values()), gout)
    got = [xp.grad] + [dict(pack.named_parameters())[k[2:]].grad
                       for k in leaves]
    for name, a, b in zip(["x"] + list(leaves), got, wanted):
        _close(a, b, float(b.abs().max()), name)


def test_model_spans_off_and_on(monkeypatch):
    params, x, _ = _tiny_case()
    net = _net(TINY)
    net.load_state_dict(params, strict=True)

    def refuse(*a, **k):
        raise AssertionError("a span with the spans off")
    with monkeypatch.context() as m:
        m.setattr(profiling, "begin", refuse)
        with torch.no_grad():
            want = net(x)
    assert not profiling.enabled()

    with profiling.tracing(True), torch.no_grad():
        got = net(x)
    assert torch.equal(got, want)
    units = {}
    for s in profiling.spans()[-(5 + 13):]:
        units.setdefault(s["replay"], []).append(s)
    stages = [u[0] for u in units.values()]
    assert [s["name"] for s in stages] == [
        "mdc.model.stem", "mdc.model.c2", "mdc.model.c3", "mdc.model.c4",
        "mdc.model.c5"]
    # c3-c5 hold their 4, 6 and 3 deformable ops; stem and c2 hold none.
    assert [len(u) - 1 for u in units.values()] == [0, 0, 4, 6, 3]
    for u in units.values():
        assert all(s["name"] == "mdc.dcn.fwd" and s["parent"] == 0
                   and s["attrs"]["op"] == "modulated_deform_conv3d"
                   for s in u[1:])
        assert u[0]["self_ns"] >= 0


def test_trainer_takes_the_3d_resnet(tmp_path):
    res = train(steps=2, batch=2, width=TINY["width"],
                classes=TINY["num_classes"], size=CLIP[2], frames=CLIP[1],
                device="cpu", ckpt_dir=str(tmp_path), log=lambda s: None,
                arch="resnet3d")
    assert type(res["model"]) is mdt.DCNResNet3d
    assert res["batch"][0].shape == (2,) + CLIP
    assert res["losses"][1] < res["losses"][0]


def test_stage_needs_2d_or_no_mesh():
    stage = DCNStage(2, 8, 4, 16, stride=2, ndim=3, device="meta")
    assert stage.block0.dcn.stride == (2, 2, 2)
    assert stage.block0.proj.conv.stride == (2, 2, 2)
    assert stage.block1.proj is None and stage.block1.dcn.stride == (1,) * 3
    with pytest.raises(ValueError):
        DCNStage(1, 8, 4, 16, ndim=3, mesh=object(), device="meta")


def test_column_wrappers_count_values_for_the_captured_step(monkeypatch):
    # CPU tensors take the plain version, which launches and counts
    # nothing.
    before = lib.counts()
    spec = mdt.ModulatedDeformConv3dPack(4, 4, 3, padding=1,
                                         device="cpu")._spec()
    x = torch.randn(1, 4, 3, 4, 4)
    cols = gathermm.cols_fwd(x, torch.zeros(1, 81, 3, 4, 4),
                             torch.ones(1, 27, 3, 4, 4), spec)
    assert cols.shape == (4 * 27, 48)
    assert lib.counts() == before
    # The kernel path, on meta tensors: each launch counts the column
    # values it writes under its rank's C entry.
    stub_c_side(monkeypatch)
    monkeypatch.setattr(lib, "check_inputs", lambda *a, **k: None)
    spec2 = mdt.ModulatedDeformConv2dPack(4, 4, 3, padding=1,
                                          device="cpu")._spec()
    for sp, S, entry in ((spec, (3, 4, 4), "gathermm3d_cols_fwd"),
                         (spec2, (5, 6), "gathermm_cols_fwd")):
        nd, K = len(S), sp.tap_count
        meta = [torch.empty((2, c) + S, device="meta")
                for c in (4, nd * K, K)]
        cols = gathermm.cols_fwd(*meta, sp)
        after = lib.counts()
        assert cols.shape == (4 * K, 2 * math.prod(S))
        assert after.launches - before.launches == {entry: 1}
        assert after.values - before.values == {entry: cols.numel()}
        before = after


def _trace_cells():
    spec = importlib.util.spec_from_file_location(
        "trace_cells", REPO / "tools" / "trace_cells.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_cells_stage_ms():
    tc = _trace_cells()
    ms = 1_000_000
    spans = [{"replay": r, "name": n, "start_ns": a * ms, "end_ns": b * ms}
             for r, n, a, b in [
                 (0, "mdc.step", 0, 10), (0, "mdc.model.stem", 1, 2),
                 (0, "mdc.model.c3", 2, 5), (0, "mdc.dcn.fwd", 3, 4),
                 (0, "mdc.dcn.fwd", 4, 4.5),
                 (1, "mdc.step", 10, 21), (1, "mdc.model.stem", 11, 13),
                 (1, "mdc.dcn.fwd", 14, 15)]]
    reps = [tc.per_replay(spans)[r] for r in (0, 1)]
    assert reps[0]["mdc.dcn.fwd"] == pytest.approx(1.5)
    got = tc.stage_ms(reps)
    # c3 is missing from the second replay: it counts 0 there.
    assert got == pytest.approx({"stem": 1.5, "c3": 1.5})
    assert tc.stage_ms([{"mdc.step": 1.0}]) == {}
    assert tc.overlap([(0, 4), (6, 9)], [(3, 7)]) == pytest.approx(2.0)
