"""The port's small utilities against the JAX package's counterparts.

* `utils/autotune.py` with an injected timer (no card): the fastest
  variant wins and stays applied, variants that raise are skipped, the
  winner is cached per (device name, key) on disk, and the two faults of
  the JAX package's autotune are not copied (nothing to time raises;
  every variant failing caches no winner).  Its knobs move the column
  forward's plan and nothing else.
* `utils/checkpoint.py::latest_step` against JAX's on the same directory.
* The torch -> flax direction of models/torch_compat.py: a flax
  `ModulatedDeformConv2dPack` and a small `DCNResNet` (width 8),
  initialised by JAX, go through `flax_to_state_dict` and
  `state_dict_to_flax` and come back equal leaf by leaf; a port module's
  state_dict, converted, drives the flax module to the port module's
  output within rtol = atol = 2e-5 (the Pack, float32, CPU) or 1e-8 (the
  backbone, float64); `validate_against_module` raises on a missing,
  unexpected or mis-shaped entry.
* examples/smoke.py on --device cpu.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulated_deform_conv_tpu.models import DCNResNet as JDCNResNet
from modulated_deform_conv_tpu.models import \
    ModulatedDeformConv2dPack as JPack
from modulated_deform_conv_tpu.utils import checkpoint as jckpt

from modulated_deform_conv_tpu_torch import (DCNResNet,
                                             ModulatedDeformConv2dPack,
                                             flax_to_state_dict,
                                             state_dict_to_flax,
                                             validate_against_module)
from modulated_deform_conv_tpu_torch.examples import smoke
from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.utils import autotune, checkpoint
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def clean_autotune(monkeypatch):
    monkeypatch.delenv("MDC_AUTOTUNE_CACHE", raising=False)
    autotune.reset()
    yield
    autotune.reset()


def _timer(times, calls):
    """A timer that reads the applied knobs and returns their time."""
    def time_fn(fn):
        fn()
        key = json.dumps({k: v for k, v in autotune.current().items() if v},
                         sort_keys=True)
        calls.append(key)
        t = times[key]
        if isinstance(t, Exception):
            raise t
        return t
    return time_fn


# ---- autotune ---------------------------------------------------------------


def test_autotune_picks_and_pins_the_fastest(tmp_path, monkeypatch):
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("MDC_AUTOTUNE_CACHE", str(cache))
    times = {"{}": 1.0, '{"COLF_BLOCKS": 528}': 0.8,
             '{"COLF_BLOCKS": 2112}': 0.9,
             '{"COLF_BLOCKS": 4224}': RuntimeError("launch refused"),
             '{"COLF_ROUTE": "gather"}': 1.2}
    calls = []
    best = autotune.autotune(lambda: None, "c4", device=CARD,
                             timer=_timer(times, calls))
    assert best == {"COLF_BLOCKS": 528}
    assert len(calls) == 5                       # the failing one skipped
    assert autotune.current() == {"COLF_ROUTE": None, "COLF_BLOCKS": 528}
    assert json.loads(cache.read_text()) == {f"{CARD}::c4": best}
    # Cached: applied again without timing, in memory and from disk.
    autotune.reset()
    assert autotune.current()["COLF_BLOCKS"] == 0
    assert autotune.autotune(lambda: None, "c4", device=CARD,
                             timer=_timer({}, calls)) == best
    assert len(calls) == 5 and autotune.current()["COLF_BLOCKS"] == 528
    # Another card's name is another entry.
    other = autotune.autotune(lambda: None, "c4", device="Other GPU",
                              variants=({"COLF_ROUTE": "gather"},),
                              timer=_timer(times, calls))
    assert other == {"COLF_ROUTE": "gather"}
    assert set(json.loads(cache.read_text())) == {f"{CARD}::c4",
                                                  "Other GPU::c4"}


def test_autotune_faults_not_copied(tmp_path, monkeypatch):
    """Nothing to time raises; every variant failing raises and caches no
    winner; unknown knobs raise before anything is timed."""
    monkeypatch.setenv("MDC_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    with pytest.raises(ValueError, match="no variants"):
        autotune.autotune(lambda: None, "k", variants=(), device=CARD,
                          timer=lambda fn: 1.0)
    fail = {"{}": RuntimeError("x"), '{"COLF_BLOCKS": 528}': ValueError("y")}
    with pytest.raises(RuntimeError, match="every variant failed"):
        autotune.autotune(lambda: None, "k", variants=({}, {"COLF_BLOCKS":
                                                            528}),
                          device=CARD, timer=_timer(fail, []))
    assert not (tmp_path / "t.json").exists()
    assert autotune.current() == {"COLF_ROUTE": None, "COLF_BLOCKS": 0}
    with pytest.raises(ValueError, match="unknown autotune knobs"):
        autotune.autotune(lambda: None, "k", variants=({"SCH": 2},),
                          device=CARD, timer=lambda fn: 1.0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        autotune.autotune(lambda: None, "k", device="cpu")


def test_knobs_move_only_the_column_forward_plan():
    """COLF_BLOCKS changes the channel split and COLF_ROUTE the route
    where the shapes admit it; the tiling stays the same."""
    spec = DeformConvSpec.make(2, 3, 1, 1, 1, 1, 1, modulated=True)
    args = (spec, (14, 14), (14, 14), 32, 1024)
    base = gm.cols_fwd_plan(*args)
    assert base.route == "plane"
    autotune.apply({"COLF_BLOCKS": 4 * gm._COLF_BLOCKS})
    more = gm.cols_fwd_plan(*args)
    assert more.splits > base.splits and more[:4] == base[:4]
    autotune.apply({"COLF_ROUTE": "gather"})
    assert gm.cols_fwd_plan(*args).route == "gather"
    assert gm.cols_fwd_plan(*args, route="plane") == base
    big = (spec, (256, 256), (256, 256), 1, 8)       # past the plane route
    autotune.apply({"COLF_ROUTE": "plane"})
    assert gm.cols_fwd_plan(*big).route == "gather"
    autotune.reset()
    assert gm.cols_fwd_plan(*args) == base


# ---- latest_step ------------------------------------------------------------


def test_latest_step_matches_jax(tmp_path):
    root = tmp_path / "ckpt"
    assert checkpoint.latest_step(str(root)) is None
    assert jckpt.latest_step(str(root)) is None
    root.mkdir()
    assert checkpoint.latest_step(str(root)) is None
    for name in ("step_3", "step_12", "step_x", "other", "step_7"):
        (root / name).mkdir()
    (root / "step_40.tmp").mkdir()
    assert checkpoint.latest_step(str(root)) == jckpt.latest_step(
        str(root)) == 12
    checkpoint.save_checkpoint(str(root), {"w": torch.ones(2)}, step=15)
    assert checkpoint.latest_step(str(root)) == jckpt.latest_step(
        str(root)) == 15


# ---- torch -> flax ----------------------------------------------------------


def _same_tree(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape and x.dtype == y.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(x, y, err_msg=f"{path}/{k}")


def test_pack_round_trip_and_output():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 9, 9)).astype(np.float32)
    fm = JPack(8, 8, (3, 3), padding=1, deformable_groups=2, use_bias=True)
    variables = jax.tree_util.tree_map(
        np.asarray, fm.init(jax.random.key(1), jnp.asarray(x)))
    back = state_dict_to_flax(flax_to_state_dict(variables))
    _same_tree(back, variables)
    # A port module's weights, converted, drive the flax module.
    torch.manual_seed(0)
    mod = ModulatedDeformConv2dPack(8, 8, 3, padding=1, deformable_groups=2,
                                    bias=True, device="cpu")
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0, 0.1)
        want = mod(torch.from_numpy(x)).numpy()
    tree = state_dict_to_flax(mod.state_dict())
    got = np.asarray(fm.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                              jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_backbone_round_trip_and_output():
    """The backbone's tree round trip, and a port DCNResNet's weights
    driving the flax one, in float64 on both sides: in float32 the two
    frameworks' GroupNorms (flax takes the variance as E[x^2] - E[x]^2)
    put depth-50 logits 1e-4 apart (tests/test_torch_port_backbone.py)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 3, 32, 32))
    fm = JDCNResNet(num_classes=10, depth=50, width=8)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(fm.init)(jax.random.key(0),
                                     jnp.asarray(x, jnp.float32)))
    _same_tree(state_dict_to_flax(flax_to_state_dict(variables)), variables)
    torch.manual_seed(1)
    net = DCNResNet(num_classes=10, depth=50, width=8, device="cpu",
                    dtype=torch.float64).eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset" in name or "conv_mask" in name:
                p.normal_(0, 0.02)
        want = net(torch.from_numpy(x)).numpy()
    sd = net.state_dict()
    validate_against_module(net, sd)
    tree = state_dict_to_flax(sd)
    assert flax_to_state_dict(tree).keys() == sd.keys()
    with jax.enable_x64(True):
        got = np.asarray(jax.jit(fm.apply)(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


def test_validate_against_module():
    sd = ModulatedDeformConv2dPack(8, 8, 3, padding=1, deformable_groups=2,
                                   device="cpu").state_dict()
    kw = dict(in_channels=8, out_channels=8, kernel_size=3, padding=1,
              deformable_groups=2)
    validate_against_module(ModulatedDeformConv2dPack, sd, **kw)
    validate_against_module(ModulatedDeformConv2dPack,
                            state_dict_to_flax(sd), **kw)
    bad = dict(sd, weight=torch.zeros(8, 8, 5, 5))
    with pytest.raises(ValueError, match="shape mismatch.*weight"):
        validate_against_module(ModulatedDeformConv2dPack, bad, **kw)
    with pytest.raises(ValueError, match="missing.*conv_mask.bias"):
        validate_against_module(ModulatedDeformConv2dPack, {
            k: v for k, v in sd.items() if k != "conv_mask.bias"}, **kw)
    with pytest.raises(ValueError, match="unexpected.*extra"):
        validate_against_module(ModulatedDeformConv2dPack,
                                dict(sd, extra=torch.zeros(1)), **kw)


# ---- the smoke example ------------------------------------------------------


def test_smoke_example_on_cpu(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    assert "smoke OK on cpu" in capsys.readouterr().out
    out, gx = smoke.run("cpu")["modulated_deform_conv2d"]
    assert out[2, 2] == 9 and out[0, 2] == 6 and out[0, 0] == 4
    assert gx[2, 2] == 9 and gx[4, 0] == 4
