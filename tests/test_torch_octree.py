"""Port parity for the volume doubling and the Octree facade:
svo.reroot_double against the JAX package's on one pool (and its refusal
when the bridge does not fit), Octree.expand_by_size, Octree.grow_capacity
across a prealloc boundary, extraction through the facade, and save / load
with the refusal of an unstamped file.

Tolerance: bit-exact (child, value, n_nodes, half_size, max_depth, query
values and reached depths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, random_cloud, to_t, words

from octree_slam_tpu.map import morton as jmorton
from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu.map.octree import Octree as JOctree
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.map.octree import Octree


def _port_pool(pool):
    return svo.SVONodePool(*(to_t(np.asarray(x)) for x in pool))


def _assert_pool_equal(tpool, jpool):
    np.testing.assert_array_equal(tpool.child.numpy(), np.asarray(jpool.child))
    np.testing.assert_array_equal(words(tpool.value), np.asarray(jpool.value))
    assert int(tpool.n_nodes) == int(jpool.n_nodes)
    assert float(tpool.half_size) == float(jpool.half_size)
    assert bool(tpool.overflowed) == bool(jpool.overflowed)


def _filled(capacity, depth=6, n=3000):
    pool = jsvo.create(capacity, jnp.zeros(3), 1.0)
    pts, cols = random_cloud(n, 0, lo=-0.95, hi=0.95)
    for i in range(3):
        pool, _ = jsvo.insert(pool, jnp.asarray(pts[: n >> i]),
                              jnp.asarray(cols[: n >> i]), depth=depth)
    return pool, pts


@pytest.mark.parametrize("capacity", [1 << 16, 1 << 19])
def test_reroot_double_bit_identical(capacity):
    """4 and 5 dense levels: the permuted dense values, the bridge block,
    the level-1 mipmap and the new level-`pre` pointers."""
    jpool, pts = _filled(capacity)
    tpool = _port_pool(jpool)
    jg = jsvo.reroot_double(jpool)
    tg = svo.reroot_double(tpool)
    assert not bool(jg.overflowed)
    _assert_pool_equal(tg, jg)
    keys, _ = jmorton.encode(jnp.asarray(pts), jg.center, 1.0, 6)
    centers = np.asarray(jmorton.decode_centers(keys, jg.center, 1.0, 6))
    jv, jd = jsvo.query_points(jg, jnp.asarray(centers), depth=7)
    tv, td = svo.query_points(tg, torch.from_numpy(centers), depth=7)
    np.testing.assert_array_equal(words(tv), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_reroot_double_refuses_without_headroom():
    jpool, _ = _filled(9368, n=300)
    tpool = _port_pool(jpool)
    assert int(jpool.n_nodes) + 4096 > 9368
    jg = jsvo.reroot_double(jpool)
    tg = svo.reroot_double(tpool)
    assert bool(jg.overflowed) and bool(tg.overflowed)
    _assert_pool_equal(tg, jg)


def _trees(capacity, size=1.0, depth_res=6, n=2000):
    kw = dict(resolution=2.0 / (1 << depth_res), center=(0, 0, 0),
              size=size, capacity=capacity, extract_capacity=1 << 13)
    jt = JOctree(**kw)
    tt = Octree(**kw, device=DEVICE)
    pts, cols = random_cloud(n, 1, lo=-0.9, hi=0.9)
    jt.add_cloud(jnp.asarray(pts), jnp.asarray(cols))
    jt.add_cloud(jnp.asarray(pts), jnp.asarray(cols))
    tt.add_cloud(torch.from_numpy(pts), torch.from_numpy(cols))
    tt.add_cloud(torch.from_numpy(pts), torch.from_numpy(cols))
    return jt, tt, pts


def test_octree_expand_by_size_matches_reference():
    jt, tt, pts = _trees(1 << 14, n=400)
    _assert_pool_equal(tt.pool, jt.pool)
    assert not bool(tt.pool.overflowed)
    depth0 = tt.max_depth
    # 3 doublings; a bridge of 4096 slots stops fitting 1 << 14, so the
    # pool grows on the way (4 dense levels both sides of the pad)
    jt.expand_by_size(6.0)
    tt.expand_by_size(6.0)
    assert tt.max_depth == jt.max_depth == depth0 + 3
    assert tt.capacity == jt.capacity > 1 << 14
    _assert_pool_equal(tt.pool, jt.pool)
    vg_j, vg_t = jt.extract_voxel_grid(), tt.extract_voxel_grid()
    assert int(vg_t.count) == int(vg_j.count) > 300
    np.testing.assert_allclose(vg_t.centers.numpy(),
                               np.asarray(vg_j.centers), atol=1e-6)
    assert float(vg_t.scale) == float(vg_j.scale)


def test_octree_grow_capacity_across_prealloc_boundary():
    """8192 -> 16384 slots is 3 -> 4 dense levels: a rebuild through
    insert_exact, every leaf word kept."""
    jt, tt, _ = _trees(8192, depth_res=5)
    jt.grow_capacity(1 << 14)
    tt.grow_capacity(1 << 14)
    assert svo.prealloc_levels(tt.capacity) == 4
    _assert_pool_equal(tt.pool, jt.pool)


def test_octree_save_load(tmp_path):
    _, tt, pts = _trees(1 << 15)
    assert not bool(tt.pool.overflowed)
    p = str(tmp_path / "tree.npz")
    tt.save(p)
    back = Octree.load(p, device=DEVICE)
    assert back.max_depth == tt.max_depth and back.capacity == tt.capacity
    for name in svo.SVONodePool._fields:
        assert torch.equal(getattr(back.pool, name), getattr(tt.pool, name))
    # the JAX package reads the port's file
    jback = JOctree.load(p)
    np.testing.assert_array_equal(np.asarray(jback.pool.value),
                                  words(tt.pool.value))
    with np.load(p) as z:
        np.savez(tmp_path / "old.npz",
                 **{k: z[k] for k in z.files if k != "prealloc"})
    with pytest.raises(ValueError, match="no prealloc stamp"):
        Octree.load(str(tmp_path / "old.npz"), device=DEVICE)
