"""The port's modules and DCNStage with a mesh against their unsharded
selves, and the port's dryrun_multichip(8), on 8 gloo CPU ranks.

Each module case builds the module twice from one seed (with `mesh` and
without), runs the rank's shard through the first and the whole input
through the second, and compares the rank's shard of the output and of the
inputs' gradients and every parameter's gradient (which the mesh path
sums over the split axes, so every rank holds the global one).  The
explicit-offset modules on (data, space) and within-group tensor
parallelism, the Pack modules on (data, space) and group-aligned on
(data, space, group), DCNStage (Pack, zero-init offsets, sigmoid mask,
GroupNorm over the whole sample) on (data, space), and the four sub-runs
of `parallel.dryrun.dryrun_rank`, each held there against its unsharded
step.  Tolerances: forward rtol = atol = 2e-5; every gradient within
1e-5 of max|unsharded gradient|.
"""
import numpy as np
import pytest

import torch_sharding_ranks as ranks

DS = ("data", "space")
XL = {0: "data", 2: "space"}


def _arrs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for kind, shape in shapes:
        a = {"n": lambda: rng.standard_normal(shape),
             "u": lambda: rng.uniform(-scale, scale, shape),
             "m": lambda: rng.uniform(0, 1, shape)}[kind]()
        out.append(a.astype(np.float32))
    return out


def _module(cls, args, mesh, inputs, layouts, out_layout, cot, kwargs=None,
            **shard):
    return dict(kind="module", cls=cls, args=args, mesh=mesh, inputs=inputs,
                layouts=layouts, out_layout=out_layout, cot=cot,
                kwargs=kwargs or {}, shard=shard)


K9 = 9
CASES = {
    "modulated2d_2x4": _module(
        "ModulatedDeformConv2d", (4, 4, 3), (((2, 4), DS)),
        _arrs(1, ("n", (4, 4, 16, 8)), ("u", (4, 2 * 2 * K9, 16, 8)),
              ("m", (4, 2 * K9, 16, 8)), scale=1.5),
        [XL] * 3, XL, _arrs(2, ("n", (4, 4, 16, 8)))[0],
        dict(padding=1, groups=2, deformable_groups=2, bias=True),
        max_offset=1.5),
    "deform3d_1x8": _module(
        "DeformConv3d", (2, 2, 3), ((1, 8), DS),
        _arrs(3, ("n", (2, 2, 8, 6, 6)), ("u", (2, 81, 8, 6, 6))),
        [XL] * 2, XL, _arrs(4, ("n", (2, 2, 8, 6, 6)))[0],
        dict(padding=1), max_offset=1.0),
    "modulated2d_within_group_tp_2x2x2": _module(
        "ModulatedDeformConv2d", (4, 8, 3),
        ((2, 2, 2), ("data", "space", "group")),
        _arrs(5, ("n", (4, 4, 16, 8)), ("u", (4, 2 * 2 * K9, 16, 8)),
              ("m", (4, 2 * K9, 16, 8))),
        [XL] * 3, {0: "data", 1: "group", 2: "space"},
        _arrs(6, ("n", (4, 8, 16, 8)))[0],
        dict(padding=1, deformable_groups=2, bias=True), max_offset=1.0,
        group_axis="group"),
    "pack2d_2x4": _module(
        "ModulatedDeformConv2dPack", (4, 8, 3), ((2, 4), DS),
        _arrs(7, ("n", (4, 4, 32, 8))), [XL], XL,
        _arrs(8, ("n", (4, 8, 32, 8)))[0],
        dict(padding=1, deformable_groups=2), max_offset=3.0),
    "pack2d_group_aligned_2x2x2": _module(
        "ModulatedDeformConv2dPack", (8, 8, 3),
        ((2, 2, 2), ("data", "space", "group")),
        _arrs(9, ("n", (4, 8, 32, 8))), [XL],
        {0: "data", 1: "group", 2: "space"},
        _arrs(10, ("n", (4, 8, 32, 8)))[0],
        dict(padding=1, groups=2, deformable_groups=2, bias=True),
        max_offset=3.0, group_axis="group"),
    "dcn_stage_2x4": _module(
        "DCNStage", (1, 16, 16, 32), ((2, 4), DS),
        _arrs(11, ("n", (4, 16, 16, 8))), [XL], XL,
        _arrs(12, ("n", (4, 32, 16, 8)))[0],
        dict(deformable_groups=2), max_offset=1.0),
}
DRYRUN = {"dryrun_multichip_8": dict(kind="dryrun")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.spawn(list(CASES.items()) + list(DRYRUN.items()), 8,
                       tmp_path_factory.mktemp("gloo_modules"))


def _close(pairs, what):
    """(sharded, unsharded) per rank: within 1e-5 of the largest unsharded
    magnitude over the ranks."""
    scale = max(float(w.abs().max()) for _, w in pairs)
    assert scale > 0, what
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale,
                                   rtol=0, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_module_with_mesh_matches_unsharded(results, name):
    res = [results[r][name] for r in sorted(results)]
    for r in res:
        assert "error" not in r, r.get("error")
    for got, want in (r["out"] for r in res):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5)
    for i in range(len(res[0]["inputs"])):
        _close([r["inputs"][i] for r in res], f"input {i}")
    for i in range(len(res[0]["params"])):
        pairs = [r["params"][i] for r in res]
        _close(pairs, f"param {i}")
        # Every rank holds the same, global, gradient.
        assert all(np.array_equal(p[0].numpy(), pairs[0][0].numpy())
                   for p in pairs)


def test_dryrun_multichip_8(results):
    """The port's dryrun_multichip(8): the four sub-runs each match their
    unsharded step in loss and every gradient (checked on every rank)."""
    for r in sorted(results):
        assert results[r]["dryrun_multichip_8"] == {"ok": True}, \
            results[r]["dryrun_multichip_8"]
