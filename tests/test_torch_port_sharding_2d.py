"""The port's sharded 2D ops on 8 gloo CPU ranks against the JAX package's.

The cases of tests/test_sharding.py: the mesh shapes (2, 4), (4, 2),
(2, 2) and (1, 8); the plain op; gradients on (1, 8); the out-of-halo
contract (held against the JAX package's sharded result on the same mesh,
since there sharded and unsharded differ on purpose); the W axis with
gradients; the (H, W) 2-axis mesh with gradients; the batch-sharded
offset bound (impl="shiftblend"); zero offsets on the gate's edge;
shift-blend's lead mode forced on a (1, 4) mesh with gradients (the
counterpart of `test_spatial_shiftblend_lead_matches`, held as it is
against the unsharded op; on these CPU ranks the lead mode's plain
version); and the forced shift-blend layouts the lead mode does not take,
which raise.

The ranks are spawned once for the file (torch_sharding_ranks.spawn) and
run every case; each case is its own test.  Tolerances
(sharding_jax_refs): forward rtol = atol = 2e-5 in "float32"; every
gradient within 1e-5 of max|JAX gradient|.
"""
import numpy as np
import pytest

import sharding_jax_refs as refs
import torch_sharding_ranks as ranks


def _case(B=4, C=4, O=4, H=16, W=8, k=3, dg=2, g=2, max_off=1.5, seed=0):
    """tests/test_sharding.py's inputs, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, H, W))
    off = rng.uniform(-max_off, max_off, (B, dg * 2 * k * k, H, W))
    mask = rng.uniform(0, 1, (B, dg * k * k, H, W))
    w = rng.standard_normal((O, C // g, k, k)) * 0.3
    b = rng.standard_normal((O,))
    return [a.astype(np.float32) for a in (x, off, mask, w, b)]


def _cot(shape, seed):
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(
        np.float32)


KW = dict(stride=1, padding=1, groups=2, deformable_groups=2,
          precision="float32")
DS = ("data", "space")
MOD = "sharded_modulated_deform_conv2d"


def _op(inputs, mesh, cot=None, fn=MOD, **kw):
    return dict(kind="op", fn=fn, mesh=mesh, inputs=inputs,
                kw={**KW, **kw}, cot=cot)


def _cases():
    cases = {}
    for shape in ((2, 4), (4, 2), (2, 2), (1, 8)):
        cases[f"modulated_{shape[0]}x{shape[1]}"] = _op(
            _case(), (shape, DS), max_offset=1.5)
    x, off, _, w, _ = _case(seed=2)
    cases["plain_2x4"] = _op([x, off, None, w, None], ((2, 4), DS),
                             fn="sharded_deform_conv2d", max_offset=1.5)
    cases["grads_1x8"] = _op(_case(B=2, H=8, W=8, seed=3), ((1, 8), DS),
                             _cot((2, 4, 8, 8), 3), max_offset=1.5)
    # Offsets past the halo: an h-offset of +5 at output row 0 sends every
    # tap of shard 0 past its halo (tests/test_sharding.py:104-150).
    x, off, mask, w, b = _case(max_off=1.0, seed=7)
    off[:, 0::2, 0, :] = 5.0
    cases["out_of_halo_1x8"] = _op([x, off, mask, w, b], ((1, 8), DS),
                                   _cot((4, 4, 16, 8), 7), max_offset=1.0)
    cases["w_axis_grads_2x4"] = _op(
        _case(H=8, W=16, seed=21), ((2, 4), DS), _cot((4, 4, 8, 16), 21),
        max_offset=1.5, spatial_axis=(None, "space"))
    cases["hw_2axis_grads_2x2x2"] = _op(
        _case(H=16, W=8, seed=22), ((2, 2, 2), ("data", "sh", "sw")),
        _cot((4, 4, 16, 8), 22), max_offset=1.5, spatial_axis=("sh", "sw"))
    cases["batch_offset_bound_4x1"] = _op(
        _case(C=16, O=16, g=2, dg=2), ((4, 1), DS), max_offset=1.5,
        impl="shiftblend")
    x, off, mask, w, b = _case(H=8, W=8, seed=31)
    cases["zero_offset_edge_grads_1x8"] = _op(
        [x, np.zeros_like(off), mask, w, b], ((1, 8), DS),
        np.full((4, 4, 8, 8), 1.0 / (4 * 4 * 8 * 8), np.float32),
        max_offset=1.0)
    cases["forced_shiftblend_lead_mode"] = _op(
        _case(C=16, O=16, g=2, dg=2), ((1, 4), DS), _cot((4, 16, 16, 8), 41),
        max_offset=1.5, impl="shiftblend")
    return cases


CASES = _cases()
# Compared with the JAX package's sharded result (the out-of-halo
# contract makes it differ from the unsharded op).
SHARDED_REF = {"out_of_halo_1x8"}
RAISES = {
    "forced_shiftblend_w_axis": _op(
        _case(C=16, O=16, W=16, dg=2), ((1, 8), DS), max_offset=1.0,
        spatial_axis=(None, "space"), impl="shiftblend"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.spawn(list(CASES.items()) + list(RAISES.items()), 8,
                       tmp_path_factory.mktemp("gloo_2d"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_2d_matches_jax(results, name):
    case = CASES[name]
    refs.assert_matches(results, name, case,
                        refs.jax_result(case, name in SHARDED_REF))


def test_out_of_halo_taps_are_dropped(results):
    """The contract is a real boundary: the port's sharded result differs
    from the unsharded op there, and the dropped taps' offset gradient is
    exactly zero."""
    case = CASES["out_of_halo_1x8"]
    got = ranks.stitch(results, "out_of_halo_1x8", "out", (4, 4, 16, 8),
                       lambda r: r["out"])
    naive, _ = refs.jax_result({**case, "cot": None})
    assert float(np.abs(naive - got).max()) > 1e-3
    goff = ranks.stitch(results, "out_of_halo_1x8", "x",
                        case["inputs"][1].shape, lambda r: r["grads"][1])
    assert float(np.abs(goff[:, 0::2, 0, :]).max()) == 0.0


@pytest.mark.parametrize("name", list(RAISES))
def test_forced_shiftblend_layouts_raise(results, name):
    """impl="shiftblend" with a spatial split the lead mode does not take
    raises NotImplementedError naming the lead mode (on every rank, before
    any exchange)."""
    kind, msg = refs.errors(results, name)
    assert kind == "NotImplementedError"
    assert "lead mode" in msg
