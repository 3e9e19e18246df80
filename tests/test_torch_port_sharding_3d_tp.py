"""The port's sharded 3D ops and its group tensor parallelism on 8 gloo CPU
ranks, against the JAX package's.

The cases of tests/test_sharding.py: a 3D op sharded on its leading and on
its last spatial axis; group-aligned tensor parallelism on (2, 2) and
(1, 2) (data, group) meshes; data x space x group; within-group tensor
parallelism (groups = 1, O split) with gradients, the `slow` case there;
and a halo wider than a shard (the multi-hop ring), with gradients.
Every case runs forward and backward.  The ranks are spawned once for the
file; each case is its own test.  Tolerances (sharding_jax_refs): forward
rtol = atol = 2e-5 in "float32"; every gradient within 1e-5 of max|JAX
gradient|.
"""
import numpy as np
import pytest

import sharding_jax_refs as refs
import torch_sharding_ranks as ranks

from test_torch_port_sharding_2d import _case, _cot, _op


def _case3d(seed, S, B=2, C=2, O=2, k=3, scale=1.0):
    """tests/test_sharding.py's 3D inputs (no mask, no bias)."""
    rng = np.random.default_rng(seed)
    K = k ** 3
    x = rng.standard_normal((B, C) + S)
    off = rng.uniform(-scale, scale, (B, 3 * K) + S)
    w = rng.standard_normal((O, C, k, k, k)) * 0.3
    return [a.astype(np.float32) for a in (x, off)] + [
        None, w.astype(np.float32), None]


D3 = dict(groups=1, deformable_groups=1, max_offset=1.0)
DG = ("data", "group")
CASES = {
    "3d_lead_2x4": _op(_case3d(5, (8, 6, 6)), ((2, 4), ("data", "space")),
                       _cot((2, 2, 8, 6, 6), 5), fn="sharded_deform_conv3d",
                       **D3),
    "3d_last_1x8": _op(_case3d(23, (6, 6, 8)), ((1, 8), ("data", "space")),
                       _cot((2, 2, 6, 6, 8), 23),
                       fn="sharded_deform_conv3d",
                       spatial_axis=(None, None, "space"), **D3),
    "group_aligned_2x2": _op(_case(C=8, O=8, g=2, dg=2, seed=11),
                             ((2, 2), DG), _cot((4, 8, 16, 8), 11),
                             group_axis="group", spatial_axis=None),
    "group_aligned_1x2": _op(_case(C=8, O=8, g=2, dg=2, seed=11),
                             ((1, 2), DG), _cot((4, 8, 16, 8), 11),
                             group_axis="group", spatial_axis=None),
    "within_group_tp_2x4": _op(_case(C=4, O=8, g=1, dg=2, seed=12),
                               ((2, 4), DG), _cot((4, 8, 16, 8), 12),
                               groups=1, group_axis="group",
                               spatial_axis=None),
    "data_space_group_2x2x2": _op(
        _case(C=8, O=8, g=2, dg=2, max_off=1.0, seed=13),
        ((2, 2, 2), ("data", "space", "group")), _cot((4, 8, 16, 8), 13),
        group_axis="group", max_offset=1.0),
    # 2 rows a shard and a halo of 1 + 3 = 4 rows: two hops each way.
    "multihop_halo_1x8": _op(_case(B=2, H=16, W=8, max_off=3.0, seed=14),
                             ((1, 8), ("data", "space")),
                             _cot((2, 4, 16, 8), 14), max_offset=3.0),
    # A halo given wider than the whole ring reaches past the image: the
    # remaining rows are zeros.
    "halo_past_the_ring_1x4": _op(_case(B=2, H=8, W=8, max_off=1.0, seed=15),
                                  ((1, 4), ("data", "space")),
                                  _cot((2, 4, 8, 8), 15), max_offset=1.0,
                                  halo=9),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.spawn(list(CASES.items()), 8,
                       tmp_path_factory.mktemp("gloo_3d_tp"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_3d_and_tp_match_jax(results, name):
    case = CASES[name]
    refs.assert_matches(results, name, case, refs.jax_result(case))
