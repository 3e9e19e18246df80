"""The column backward's plan (ops/cuda/gathermm.py::cols_bwd_plan) on the
CPU: how it tiles the plane or volume, how large its scratch and shared
memory are, and that its table pool holds every (candidate, tile) entry
the kernels write (csrc/deform_cols_bwd.cuh::cand_tiles, mirrored here in
numpy on the same corner rules)."""
import math

import numpy as np
import pytest

from modulated_deform_conv_tpu_torch.ops.cuda import gathermm as gm
from modulated_deform_conv_tpu_torch.utils.config import DeformConvSpec


def _spec(nd, k=3, stride=1, pad=1, dil=1, dg=1):
    return DeformConvSpec.make(nd, k, stride, pad, dil, 1, dg, modulated=True)


@pytest.mark.parametrize("C, S, chunks", [(1024, 14, 32), (2048, 7, 64)])
def test_config5_planes_are_one_tile(C, S, chunks):
    """BASELINE config 5's c4 and c5 planes fit one tile: every candidate's
    table is the whole plane's, and the correlation runs in the pull."""
    spec = _spec(2)
    plan = gm.cols_bwd_plan(spec, (S, S), (S, S), C)
    assert plan.tile == (1, S, S) and plan.tiles == 1
    assert plan.chunks == chunks
    assert plan.runs == -(-9 * S * S // 256)
    assert plan.corners == 4 and plan.entry_ints == 8
    assert plan.pool_per_bd == -(-4 * 9 * S * S // 128) * 128 + 128
    assert plan.rec == -(-(S * S + 1) // 8) * 8 + 128 * 4


@pytest.mark.parametrize("S, tile, tiles", [
    ((40, 36), (1, 8, 16), 15),       # several tiles, ragged on both axes
    ((16, 16), (1, 16, 16), 1),       # 256 pixels: still one tile
    ((17, 16), (1, 8, 16), 3),
    ((3, 300), (1, 3, 16), 19),       # a short plane: tiles cut to it
])
def test_2d_tiling(S, tile, tiles):
    plan = gm.cols_bwd_plan(_spec(2), S, S, 12)
    assert plan.tile == tile and plan.tiles == tiles
    assert plan.chunks == 1


@pytest.mark.parametrize("S, tile, tiles", [
    ((16, 32, 32), (4, 4, 8), 128),   # the 3D columns case
    ((5, 7, 6), (5, 7, 6), 1),        # 210 voxels: one tile
    ((7, 9, 8), (4, 4, 8), 6),
    ((2, 3, 100), (2, 3, 8), 13),
])
def test_3d_tiling(S, tile, tiles):
    plan = gm.cols_bwd_plan(_spec(3), S, S, 64)
    assert plan.tile == tile and plan.tiles == tiles
    assert plan.corners == 8 and plan.entry_ints == 12
    assert plan.chunks == 2


@pytest.mark.parametrize("nd, S", [
    (2, (1, 256)), (2, (256, 1)), (2, (16, 16)), (2, (8, 32)), (2, (100, 100)),
    (3, (1, 1, 256)), (3, (1, 2, 128)), (3, (4, 8, 8)), (3, (32, 64, 64))])
def test_pull_block_fits_shared_memory(nd, S):
    """Every tile the plan makes holds at most 256 pixels, and the pull
    block's shared memory (x with one more row, column and plane, two
    pieces of staged gcols, three of entries and of pixel lists) fits what
    one H100 block may take; a piece's list holds every hit its entries
    can make."""
    plan = gm.cols_bwd_plan(_spec(nd), S, S, 64)
    assert math.prod(plan.tile) <= 256
    assert plan.smem <= gm._SMEM_MAX
    assert plan.rec >= math.prod(plan.tile) + 1 + 128 * plan.corners
    assert plan.rec % 8 == 0 and plan.pool_per_bd % 128 == 0


def _items(spec, S, offset, mask, plan):
    """Per candidate (b, d, k, p): how many tiles it goes to (its owner
    tile, and the tiles of its kept corners with a nonzero weight), from
    the corner rules of the reference (core.py) in numpy."""
    nd, K = spec.ndim, spec.tap_count
    OS = spec.out_sizes(S)
    B = offset.shape[0]
    grids = np.meshgrid(*[np.arange(o) for o in OS], indexing="ij")
    taps = np.meshgrid(*[np.arange(k) for k in spec.kernel], indexing="ij")
    full = (1,) * (3 - nd) + tuple(S)
    tile = plan.tile
    counts = []
    off = offset.reshape((B, spec.deformable_groups, K, nd) + OS)
    m = mask.reshape((B, spec.deformable_groups, K) + OS)
    for k in range(K):
        kidx = [t.reshape(-1)[k] for t in taps]
        pos = [grids[a] * spec.stride[a] - spec.padding[a]
               + kidx[a] * spec.dilation[a] + off[:, :, k, a]
               for a in range(nd)]
        gate = np.ones(pos[0].shape, bool)
        for a in range(nd):
            gate &= (pos[a] > -1) & (pos[a] < S[a])
        lo = [np.floor(p).astype(np.int64) for p in pos]
        fr = [p - np.floor(p) for p in pos]
        tiles_of = []
        owner = sum(
            (np.maximum(lo[a], 0) // tile[3 - nd + a])
            * math.prod(-(-full[j] // tile[j]) for j in range(3 - nd + a + 1, 3))
            for a in range(nd))
        tiles_of.append(owner)
        for corner in range(2 ** nd):
            bits = [(corner >> (nd - 1 - a)) & 1 for a in range(nd)]
            c = [lo[a] + bits[a] for a in range(nd)]
            kept = np.ones(gate.shape, bool)
            w = m[:, :, k].astype(np.float64)
            for a in range(nd):
                kept &= (c[a] >= 0) & (c[a] < S[a])
                w = w * (fr[a] if bits[a] else 1 - fr[a])
            t = sum((np.clip(c[a], 0, S[a] - 1) // tile[3 - nd + a])
                    * math.prod(-(-full[j] // tile[j])
                                for j in range(3 - nd + a + 1, 3))
                    for a in range(nd))
            tiles_of.append(np.where(kept & (w != 0), t, -1))
        stack = np.stack(tiles_of, -1)
        n = np.array([len(set(r[r >= 0])) for r in stack.reshape(-1, stack.shape[-1])])
        counts.append(np.where(gate.reshape(-1), n, 0).reshape(gate.shape))
    return np.stack(counts, 2)          # (B, dg, K, *OS)


@pytest.mark.parametrize("nd, S, k, stride, scale, dg", [
    (2, (40, 36), 3, 1, 3.0, 1),
    (2, (23, 19), 5, 2, 40.0, 2),
    (2, (14, 14), 3, 1, 2.0, 1),
    (3, (9, 10, 11), 3, 2, 2.0, 2),
    (3, (6, 7, 9), 3, 1, 8.0, 1),
])
def test_table_pool_holds_every_entry(nd, S, k, stride, scale, dg):
    """The pool the plan sizes per (sample, deformable group), corners x K
    x P entries, holds every entry the fill writes: a candidate goes to at
    most `corners` tiles, whatever the offsets (far ones included), and
    every candidate with an open gate to at least one (its owner, which
    sums its correlation); each tile's entries, rounded up to whole pieces,
    fit too."""
    spec = _spec(nd, k, stride, k // 2, 1, dg)
    OS = spec.out_sizes(S)
    rng = np.random.default_rng(0)
    offset = rng.uniform(-scale, scale, (2, dg * nd * spec.tap_count) + OS)
    mask = rng.uniform(0, 1, (2, dg * spec.tap_count) + OS)
    mask[..., 0] = 0.0
    plan = gm.cols_bwd_plan(spec, S, OS, 16)
    items = _items(spec, S, offset, mask, plan)
    assert items.max() <= plan.corners
    per_bd = items.reshape(2, dg, -1).sum(-1)
    assert per_bd.max() + 127 * plan.tiles <= plan.pool_per_bd
    assert items.sum() > 0
