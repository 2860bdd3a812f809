"""Port parity: the dense value-mip mirror and its distance field
(octree_slam_tpu_torch/map/mips.py) against the JAX package, fed by the
eager insert of both packages over a three-frame stream of one moving
cloud.

Tolerances: everything here is integer data and must be bit-identical:
the index helpers, `update` (values, occ, dist), `refresh_dist`,
`rebuild_from_pool`, `rebuild_dist` and the distance transform itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_mirror_equal, random_cloud, to_t,
                          words)

from octree_slam_tpu.map import mips as jmips
from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu_torch.map import mips, svo

DEPTH, CAP, LVL, SKIP = 6, 1 << 14, 4, 5


@pytest.fixture(scope="module")
def stream():
    """Three eager inserts through both packages; per frame the stats and
    the pools after it (the port's tensors are cloned: it writes in
    place)."""
    jpool = jsvo.create(CAP, jnp.zeros(3), 1.0)
    tpool = svo.create(CAP, torch.zeros(3), 1.0, device=DEVICE)
    pts0, cols = random_cloud(400, seed=21, lo=-0.7, hi=0.7)
    frames = []
    for fr in range(3):
        pts = pts0 + np.float32(0.01 * fr)
        jpool, jst = jsvo.insert(jpool, jnp.asarray(pts), jnp.asarray(cols),
                                 depth=DEPTH, unique_cap=1 << 12,
                                 emit_mips=True, shallow_level=LVL)
        tpool, tst = svo.insert(tpool, to_t(pts), to_t(cols), depth=DEPTH,
                                unique_cap=1 << 12, emit_mips=True,
                                shallow_level=LVL)
        frames.append((jst, tst))
    assert not bool(tpool.overflowed)
    return frames, jpool, tpool


def test_index_helpers_match():
    for lvl in range(1, 8):
        assert mips.level_offset(lvl) == jmips.level_offset(lvl)
        assert mips.total_cells(lvl) == jmips.total_cells(lvl)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << (3 * DEPTH), 500).astype(np.int32)
    lv = rng.integers(1, DEPTH + 1, 500).astype(np.int32)
    np.testing.assert_array_equal(
        mips.flat_index(to_t(keys), DEPTH, 3).numpy(),
        np.asarray(jmips.flat_index(jnp.asarray(keys), DEPTH, 3)))
    np.testing.assert_array_equal(
        mips.flat_index(to_t(keys), DEPTH, to_t(lv)).numpy(),
        np.asarray(jmips.flat_index(jnp.asarray(keys), DEPTH,
                                    jnp.asarray(lv))))
    x, y, z = (to_t(c) for c in mips.deinterleave3(to_t(keys), DEPTH))
    jx, jy, jz = jmips.deinterleave3(jnp.asarray(keys), DEPTH)
    for a, b in ((x, jx), (y, jy), (z, jz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        mips.interleave3(x, y, z, DEPTH).numpy(), keys)
    np.testing.assert_array_equal(mips._morton_to_xyz_perm(LVL),
                                  jmips._morton_to_xyz_perm(LVL))


def test_create_matches():
    assert_mirror_equal(
        mips.create(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP,
                    device=DEVICE),
        jmips.create(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP))


def test_update_bit_exact(stream):
    """Per frame: the mirror after `update`, with the distance field
    refreshed by the update on odd frames and by `refresh_dist` after a
    with_dist=False update on even ones."""
    frames, _, _ = stream
    jc = jmips.create(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP)
    tc = mips.create(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP,
                     device=DEVICE)
    kw = dict(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP)
    for i, (jst, tst) in enumerate(frames):
        with_dist = bool(i % 2)
        jc = jmips.update(jc, jst.mip_idx, jst.mip_val, with_dist=with_dist,
                          **kw)
        tc = mips.update(tc, tst.mip_idx, tst.mip_val, with_dist=with_dist,
                         **kw)
        assert_mirror_equal(tc, jc, f"frame {i}")
        if not with_dist:
            jc = jmips.refresh_dist(jc, dist_level=LVL, max_skip=SKIP)
            tc = mips.refresh_dist(tc, dist_level=LVL, max_skip=SKIP)
            assert_mirror_equal(tc, jc, f"frame {i} refreshed")
    assert int(tc.occ.sum()) > 50 and int((tc.dist == 0).sum()) > 50


def test_rebuild_from_pool_bit_exact(stream):
    _, jpool, tpool = stream
    kw = dict(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP)
    jr = jmips.rebuild_from_pool(jpool, **kw)
    tr = mips.rebuild_from_pool(tpool, **kw)
    assert_mirror_equal(tr, jr, "rebuild")
    np.testing.assert_array_equal(
        mips.rebuild_dist(tr.values, max_depth=DEPTH, dist_level=LVL,
                          max_skip=7).numpy(),
        np.asarray(jmips.rebuild_dist(jr.values, max_depth=DEPTH,
                                      dist_level=LVL, max_skip=7)))


def test_rebuild_equals_incremental(stream):
    """The reference's own invariant: the mirror kept by per-frame updates
    equals the one rebuilt from the pool."""
    frames, _, tpool = stream
    kw = dict(max_depth=DEPTH, dist_level=LVL, max_skip=SKIP)
    tc = mips.create(device=DEVICE, **kw)
    for _, tst in frames:
        tc = mips.update(tc, tst.mip_idx, tst.mip_val, **kw)
    tr = mips.rebuild_from_pool(tpool, **kw)
    for name in ("values", "occ", "dist"):
        assert torch.equal(getattr(tc, name), getattr(tr, name)), name


@pytest.mark.parametrize("max_skip", [1, 5, 7, 15])
def test_dist_from_occ_bit_exact(max_skip):
    rng = np.random.default_rng(max_skip)
    occ = rng.random((16, 16, 16)) < 0.01
    occ[0, 0, 0] = occ[15, 7, 3] = True      # the grid's faces
    got = mips._dist_from_occ(torch.from_numpy(occ), max_skip).numpy()
    want = np.asarray(jmips._dist_from_occ(jnp.asarray(occ), max_skip))
    np.testing.assert_array_equal(got, want)
    # against the definition, the Chebyshev distance to the nearest
    # occupied cell: exact up to 1 and never below it (the log rounds only
    # look along the window's 26 directions, so e.g. a cell at offset
    # (2, 1, 0) reads 3: the reference's transform, reproduced as it is)
    idx = np.argwhere(occ)
    grid = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1)
    cheb = np.minimum(
        np.abs(grid[:, :, :, None, :] - idx).max(-1).min(-1), max_skip)
    assert (got >= cheb).all()
    np.testing.assert_array_equal(got[cheb <= 1], cheb[cheb <= 1])


def test_mip_pairs_set_equal(stream):
    """The insert's (mip_idx, mip_val) pairs as a set (the port does not
    compact its rows, so their order and count of pad rows differ)."""
    frames, _, _ = stream
    total = mips.total_cells(DEPTH)
    for jst, tst in frames:
        ji, jv = np.asarray(jst.mip_idx), np.asarray(jst.mip_val)
        ti, tv = tst.mip_idx.numpy(), words(tst.mip_val)
        assert ti.max() <= total and ti.min() >= 0
        jp = sorted(zip(ji[ji < total].tolist(), jv[ji < total].tolist()))
        tp = sorted(zip(ti[ti < total].tolist(), tv[ti < total].tolist()))
        assert jp == tp and len(tp) > 400
        assert len({i for i, _ in tp}) == len(tp)   # a cell written once
