"""The column forward's plan (ops/cuda/gathermm.py::cols_fwd_plan) on the
CPU: which route the shapes take, how large a block's shared memory is,
that the plane route's blocks write every column value once (a numpy
mirror of csrc/deform_cols_fwd.cuh::cols_plane_kernel's work split), and
that a tile's corner box (the same kernel's box, mirrored on the corner
rules of the reference) fits its slot for offsets within the plan's reach
and passes it for far ones."""
import math

import numpy as np
import pytest

from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec

THREADS = gm._COLF_THREADS


def _spec(nd, k=3, stride=1, pad=1, dil=1, g=1, dg=1):
    return DeformConvSpec.make(nd, k, stride, pad, dil, g, dg, modulated=True)


@pytest.mark.parametrize("nd, B, C, S, g", [
    (2, 32, 512, (28, 28), 1),          # config 5 c3
    (2, 32, 1024, (14, 14), 1),         # config 5 c4
    (2, 32, 2048, (7, 7), 1),           # config 5 c5
    (3, 2, 64, (16, 32, 32), 2),        # the 3D columns case
])
def test_plane_route_at_the_measured_cases(nd, B, C, S, g):
    """Every measured columns case takes the plane route, its tiles hold
    at most 256 (tap, column group) items, one a thread, and cover the
    sample, and its channel splits cover the group in whole stages."""
    spec = _spec(nd, g=g)
    plan = gm.cols_fwd_plan(spec, S, S, B, C)
    assert plan.route == "plane"
    assert spec.tap_count * plan.gt <= THREADS
    assert plan.tiles * plan.gt >= -(-math.prod(S) // 4) + 1
    assert plan.cps % plan.cc == 0 and plan.splits * plan.cps >= C
    assert (plan.splits - 1) * plan.cps < C
    assert plan.smem <= gm._COLF_SMEM[nd] and plan.slot % 4 == 0


def test_3d_case_tiles_are_whole_rows_of_one_plane():
    """In the 3D columns case a tile is one whole output row of one plane
    (8 groups of 4 of a 32-wide row, 216 items), so its box spans 7 planes
    of 7 rows for offsets below 2 (7 x (7 x 32 + 6) floats at most),
    within the slot's cap of 72 KB / 32; four channels a stage."""
    plan = gm.cols_fwd_plan(_spec(3, g=2), (16, 32, 32), (16, 32, 32), 2, 64)
    assert plan.gt == 8 and plan.tiles == 2 * 16 * 32 and plan.nbm == 1
    assert plan.slot == 72 * 1024 // 32 >= 7 * (7 * 32 + 6)
    assert plan.cc == 4 and plan.smem == 72 * 1024


@pytest.mark.parametrize("nd, S, route", [
    (3, (32, 64, 64), "gather"),        # config 4's volume, 512 KB
    (3, (16, 32, 32), "plane"),
    (2, (200, 256), "plane"),           # 51,200 pixels: the largest plane
    (2, (200, 257), "gather"),          # one row of 257 past it
    (2, (56, 56), "plane"),
])
def test_route_follows_the_plane_size(nd, S, route):
    spec = _spec(nd)
    plan = gm.cols_fwd_plan(spec, S, S, 4, 128)
    assert plan.route == route
    if route == "gather":
        with pytest.raises(ValueError):
            gm.cols_fwd_plan(spec, S, S, 4, 128, "plane")
        assert plan.ints() == (0,) * 9
    assert gm.cols_fwd_plan(spec, S, S, 4, 128, "gather").route == "gather"


def test_route_rules_on_the_grid():
    """More than 256 taps take the gather route (a tile holds every tap,
    one a thread); the plane route's grid (tiles, splits, groups) stays
    within what a launch takes."""
    assert gm.cols_fwd_plan(_spec(2, k=17, pad=8), (30, 30), (30, 30), 1,
                            8).route == "gather"
    plan = gm.cols_fwd_plan(_spec(2, k=1, pad=0), (200, 256), (200, 256),
                            2 ** 12, 70000)
    assert plan.route == "plane" and plan.tiles < 2 ** 31
    assert plan.splits <= 65535


SWEEP = [
    # (nd, k, stride, pad, dil, B, C, dg, S)
    (2, 3, 1, 1, 1, 32, 512, 1, (28, 28)),
    (2, 3, 1, 1, 1, 32, 2048, 1, (7, 7)),
    (2, 5, 2, 2, 2, 2, 40, 2, (23, 19)),
    (2, 3, 1, 1, 1, 1, 3, 1, (200, 256)),
    (2, 3, 1, 1, 1, 1, 3, 1, (4, 12800)),
    (2, 7, 1, 3, 1, 8, 64, 4, (100, 100)),
    (2, 1, 1, 0, 1, 3, 5, 1, (1, 1)),
    (3, 3, 1, 1, 1, 2, 64, 1, (16, 32, 32)),
    (3, 5, 1, 2, 1, 1, 8, 1, (6, 7, 9)),
    (3, 3, 2, 2, 2, 2, 12, 2, (9, 10, 11)),
    (3, 3, 1, 1, 1, 1, 16, 1, (8, 80, 80)),
    (3, 3, 1, 1, 1, 4, 128, 1, (2, 2, 12800)),
]


@pytest.mark.parametrize("nd, k, stride, pad, dil, B, C, dg, S", SWEEP)
def test_block_shared_memory_fits(nd, k, stride, pad, dil, B, C, dg, S):
    """A plane-route block's shared memory (two stages of cc channels x
    nbm samples of the slot) fits what one H100 block may take, and the
    plan's sizes are consistent: the slot holds at least 4 floats and at
    most the plane, a stage at least one channel."""
    spec = _spec(nd, k, stride, pad, dil, 1, dg)
    OS = spec.out_sizes(S)
    plan = gm.cols_fwd_plan(spec, S, OS, B, C)
    if plan.route == "gather":
        assert math.prod(S) > gm._COLF_PLANE_MAX
        return
    assert plan.smem <= gm._SMEM_MAX and plan.smem <= gm._COLF_SMEM[nd]
    assert 4 <= plan.slot <= -(-math.prod(S) // 4) * 4
    assert 1 <= plan.cc <= min(32, C // dg)
    stages = 2 if plan.cps > plan.cc else 1
    assert plan.smem == stages * plan.cc * plan.nbm * plan.slot * 4
    assert 1 <= plan.nbm <= B
    assert plan.splits <= 65535 and B * dg <= 65535


def _tiles(plan, B, P):
    """Per tile of the B * P columns: (its first group, its groups, its
    first sample, its samples), as the kernel derives them."""
    groups = -(-B * P // 4)
    for tile in range(plan.tiles):
        j0 = tile * plan.gt
        GT = min(plan.gt, groups - j0)
        if GT <= 0:
            continue
        b0 = 4 * j0 // P
        yield tile, j0, GT, b0, (min(B * P, 4 * (j0 + GT)) - 1) // P - b0 + 1


def _coverage(spec, S, B, C):
    """How many times the plane route's blocks write each value of the
    columns (C * K, B * P): the kernel's split of blocks (tile of the B * P
    columns, channel split, group), items (tap, 4 consecutive columns) one
    a thread, threads sharing an item over channel lanes, and stages, in
    numpy."""
    OS = spec.out_sizes(S)
    plan = gm.cols_fwd_plan(spec, S, OS, B, C)
    assert plan.route == "plane"
    K, P, dg = spec.tap_count, math.prod(OS), spec.deformable_groups
    Cdg, BP = C // dg, B * P
    count = np.zeros((C * K, BP), np.int64)
    t = np.arange(THREADS)
    for d in range(dg):
        for tile, j0, GT, b0, nb in _tiles(plan, B, P):
            assert nb <= plan.nbm
            I = K * GT
            assert I <= THREADS
            nlane, clane, i = THREADS // I, t // I, t % I
            live = clane < nlane
            k, q0, cl0 = i[live] // GT, 4 * (j0 + i[live] % GT), clane[live]
            for split in range(plan.splits):
                c0 = d * Cdg + split * plan.cps
                c1 = min((d + 1) * Cdg, c0 + plan.cps)
                for cb in range(c0, c1, plan.cc):
                    cn = min(plan.cc, c1 - cb)
                    for base in range(0, cn, nlane):
                        cl = base + cl0
                        on = cl < cn
                        for u in range(4):
                            q = q0[on] + u
                            ok = q < BP
                            np.add.at(count, ((cb + cl[on][ok]) * K
                                              + k[on][ok], q[ok]), 1)
    return count


@pytest.mark.parametrize("nd, k, stride, pad, dil, B, C, dg, S", [
    (2, 3, 1, 1, 1, 3, 18, 1, (7, 9)),      # B * P odd: groups straddle samples
    (2, 3, 1, 1, 1, 2, 30, 5, (9, 11)),     # 6 channels a group: nlane > 1
    (2, 3, 1, 1, 1, 4, 70, 1, (7, 7)),      # config 5 c5's plane, 3 splits
    (2, 5, 2, 2, 2, 2, 40, 2, (23, 19)),
    (2, 3, 1, 1, 1, 2, 8, 1, (30, 29)),     # several tiles a sample, straddling
    (2, 1, 1, 0, 1, 3, 5, 1, (1, 1)),       # one position a sample
    (2, 3, 1, 1, 1, 9, 12, 3, (3, 5)),      # tiles of several samples
    (3, 3, 1, 1, 1, 2, 7, 1, (4, 8, 8)),
    (3, 3, 2, 2, 2, 2, 12, 2, (9, 10, 11)),
    (3, 5, 1, 2, 1, 1, 8, 1, (6, 7, 9)),
])
def test_every_value_written_once(nd, k, stride, pad, dil, B, C, dg, S):
    spec = _spec(nd, k, stride, pad, dil, 1, dg)
    count = _coverage(spec, S, B, C)
    assert count.min() == 1 and count.max() == 1


def _boxes(spec, S, offset, plan):
    """Floats of each plane-route block's staged corner box, per (group,
    tile): the planes (3D) x rows its items' kept corners reach over its
    samples, at full width (each plane's run padded to whole 16-byte copies
    where x's planes keep that alignment), from the corner rules of the
    reference (core.py) in numpy."""
    nd, K, dg = spec.ndim, spec.tap_count, spec.deformable_groups
    OS = spec.out_sizes(S)
    HW = math.prod(S[-2:])
    wide = math.prod(S) % 4 == 0 and HW % 4 == 0
    B, P = offset.shape[0], math.prod(OS)
    grids = [g.reshape(-1) for g in np.meshgrid(*[np.arange(o) for o in OS],
                                                indexing="ij")]
    taps = [g.reshape(-1) for g in np.meshgrid(*[np.arange(n) for n in spec.kernel],
                                               indexing="ij")]
    off = offset.reshape(B, dg, K, nd, P)
    lo = np.full((B, dg, K, P, 2), np.iinfo(np.int64).max)   # (z, y) minima
    hi = np.full((B, dg, K, P, 2), np.iinfo(np.int64).min)
    for kk in range(K):
        pos = [grids[a] * spec.stride[a] - spec.padding[a]
               + taps[a][kk] * spec.dilation[a] + off[:, :, kk, a]
               for a in range(nd)]
        gate = np.ones(pos[0].shape, bool)
        for a in range(nd):
            gate &= (pos[a] > -1) & (pos[a] < S[a])
        fl = [np.floor(p).astype(np.int64) for p in pos]
        for corner in range(2 ** nd):
            bits = [(corner >> (nd - 1 - a)) & 1 for a in range(nd)]
            c = [fl[a] + bits[a] for a in range(nd)]
            kept = gate.copy()
            for a in range(nd):
                kept &= (c[a] >= 0) & (c[a] < S[a])
            zy = [c[0] if nd == 3 else np.zeros_like(c[0]), c[nd - 2]]
            for j in range(2):
                lo[:, :, kk, :, j] = np.where(kept, np.minimum(lo[:, :, kk, :, j], zy[j]),
                                              lo[:, :, kk, :, j])
                hi[:, :, kk, :, j] = np.where(kept, np.maximum(hi[:, :, kk, :, j], zy[j]),
                                              hi[:, :, kk, :, j])
    floats = {}
    for tile, j0, GT, b0, nb in _tiles(plan, B, P):
        q = np.arange(4 * j0, min(B * P, 4 * (j0 + GT)))
        b, p = q // P, q % P
        for d in range(dg):
            zl, yl = lo[b, d, :, p].reshape(-1, 2).min(0)
            zh, yh = hi[b, d, :, p].reshape(-1, 2).max(0)
            if zl > zh:
                floats[(d, tile)] = 0
                continue
            run = (yh - yl + 1) * S[-1]
            if wide:   # each plane's run from the aligned value below it
                run = -(-((zl * HW + yl * S[-1]) % 4 + run) // 4) * 4
            floats[(d, tile)] = (zh - zl + 1) * run if nb <= plan.nbm else math.inf
    return floats


@pytest.mark.parametrize("nd, k, stride, B, C, dg, S, reach", [
    (3, 3, 1, 2, 64, 1, (16, 32, 32), 2.0),   # the 3D columns case's offsets
    (3, 3, 1, 1, 8, 1, (9, 20, 20), 2.99),    # a volume whose slot is the box
    (2, 3, 1, 2, 512, 1, (28, 28), 2.99),     # config 5 c3's plane
    (2, 3, 1, 1, 4, 1, (120, 90), 2.99),
    (2, 5, 2, 1, 4, 2, (60, 70), 2.99),
])
def test_offsets_within_reach_stay_in_the_slot(nd, k, stride, B, C, dg, S,
                                               reach):
    """Offsets below the plan's reach (3) keep every block's corner box in
    its slot, so no block reads its corners from x; in the 3D columns case
    the slot's cap (a 32nd of 72 KB) holds the boxes of offsets below 2."""
    spec = _spec(nd, k, stride, k // 2, 1, 1, dg)
    OS = spec.out_sizes(S)
    plan = gm.cols_fwd_plan(spec, S, OS, B, C)
    rng = np.random.default_rng(0)
    offset = rng.uniform(-reach, reach, (B, dg * nd * spec.tap_count) + OS)
    boxes = _boxes(spec, S, offset, plan)
    assert max(boxes.values()) <= plan.slot


def test_far_offsets_pass_one_blocks_slot():
    """The card tests' far-box case (tests/test_torch_port_cuda.py,
    FAR_BOX_3D): offsets of (-7, 14, 10) at eight positions of output row
    (9, 4) push the box of the one block that holds them past its slot,
    and no other block's."""
    spec = _spec(3)
    S = (16, 32, 32)
    rng = np.random.default_rng(0)
    rng.standard_normal((1, 4) + S)                       # x, as _case draws it
    offset = rng.uniform(-1.5, 1.5, (1, 81) + S)
    off = offset.reshape(1, 27, 3, *S)
    off[:, :, :, 9, 4, 8:16] = np.array([-7.0, 14.0, 10.0]).reshape(1, 1, 3, 1)
    plan = gm.cols_fwd_plan(spec, S, S, 1, 4)
    boxes = _boxes(spec, S, offset, plan)
    over = [key for key, n in boxes.items() if n > plan.slot]
    assert over == [(0, (9 * 32 + 4) * 32 // (4 * plan.gt))]
