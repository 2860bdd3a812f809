"""Port parity for extraction, the value-exact bulk write and growth:
svo.extract_voxels / extract_all_leaves / query_points,
splat.leaf_list_from_extraction, svo.insert_exact (both overwrite modes,
min_key paging), svo.grow_capacity and pipeline.grow_state in its three
branches (pad, registry rebuild, rebuild across a prealloc boundary),
against the JAX package on the same numpy inputs.

Tolerance: bit-exact everywhere (pool child / value / n_nodes, extraction
keys and nodes, every insert_exact stats field, registries, capacities,
the dense mirror, the flags); centres within 1e-6 m; extracted colours
equal as 8-bit levels and within 1e-7 as floats (XLA multiplies by the
reciprocal of 255 where the port divides)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_state_equal, jax_frame, np_state,
                          orbit_frames, port_config, random_cloud, to_t,
                          words)

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu.render import splat as jsplat
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.render import splat

DEPTH = 6


def _pools(capacity=1 << 16, n=3000, seed=0):
    """A JAX pool filled by three inserts of a random cloud, and the port's
    copy of it."""
    pool = jsvo.create(capacity, jnp.zeros(3), 1.0)
    pts, cols = random_cloud(n, seed, lo=-0.95, hi=0.95)
    for i in range(3):
        pool, _ = jsvo.insert(pool, jnp.asarray(pts[: n >> i]),
                              jnp.asarray(cols[: n >> i]), depth=DEPTH)
    return pool, _port_pool(pool)


def _port_pool(pool):
    return svo.SVONodePool(*(to_t(np.asarray(x)) for x in pool))


def _assert_pool_equal(tpool, jpool, where=""):
    np.testing.assert_array_equal(tpool.child.numpy(),
                                  np.asarray(jpool.child), err_msg=where)
    np.testing.assert_array_equal(words(tpool.value),
                                  np.asarray(jpool.value), err_msg=where)
    assert int(tpool.n_nodes) == int(jpool.n_nodes), where
    assert bool(tpool.overflowed) == bool(jpool.overflowed), where
    assert float(tpool.half_size) == float(jpool.half_size), where


@pytest.mark.parametrize("capacity", [64, 1 << 13])
def test_extract_voxels_parity(capacity):
    jpool, tpool = _pools()
    j = jsvo.extract_voxels(jpool, depth=DEPTH, capacity=capacity)
    t = svo.extract_voxels(tpool, depth=DEPTH, capacity=capacity)
    assert int(t.count) == int(j.count)
    assert int(j.count) == min(capacity, 2900) or int(j.count) > 2900
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.nodes.numpy(), np.asarray(j.nodes))
    # XLA folds the / 255 into a multiply by the reciprocal: one ulp apart
    np.testing.assert_allclose(t.colors.numpy(), np.asarray(j.colors),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np.round(t.colors.numpy() * 255),
                                  np.round(np.asarray(j.colors) * 255))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers),
                               atol=1e-6)


def test_extract_all_leaves_and_registry_parity():
    jpool, tpool = _pools()
    jex, jcap = jsvo.extract_all_leaves(jpool, depth=DEPTH, start_capacity=8)
    tex, tcap = svo.extract_all_leaves(tpool, depth=DEPTH, start_capacity=8)
    assert tcap == jcap and tcap > 8
    np.testing.assert_array_equal(tex.keys.numpy(), np.asarray(jex.keys))
    np.testing.assert_array_equal(tex.nodes.numpy(), np.asarray(jex.nodes))
    jl = jsplat.leaf_list_from_extraction(jex, jpool.value,
                                          node_capacity=jpool.capacity)
    tl = splat.leaf_list_from_extraction(tex, tpool.value,
                                         node_capacity=tpool.capacity)
    for name in splat.LeafList._fields:
        a, b = getattr(tl, name), np.asarray(getattr(jl, name))
        np.testing.assert_array_equal(
            words(a) if b.dtype == np.uint32 else a.numpy(), b,
            err_msg=name)


def test_query_points_parity():
    jpool, tpool = _pools()
    pts, _ = random_cloud(500, 7, lo=-1.2, hi=1.2)   # some outside
    pts[:3] = np.nan
    jv, jd = jsvo.query_points(jpool, jnp.asarray(pts), depth=DEPTH)
    tv, td = svo.query_points(tpool, torch.from_numpy(pts), depth=DEPTH)
    np.testing.assert_array_equal(words(tv), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _exact_inputs(jpool, seed=3, n_new=400):
    """Keys: every live leaf of the pool, new keys, duplicates and invalid
    rows, shuffled; random u32 words."""
    rng = np.random.default_rng(seed)
    ex = jsvo.extract_voxels(jpool, depth=DEPTH, capacity=1 << 13)
    live = np.asarray(ex.keys)[: int(ex.count)]
    new = rng.integers(0, 1 << (3 * DEPTH), n_new).astype(np.int32)
    keys = np.concatenate([live, new, live[:50], new[:20],
                           np.array([-1, 0x7FFFFFFF, -7], np.int32)])
    rng.shuffle(keys)
    vals = rng.integers(0, 1 << 32, keys.size, dtype=np.uint64).astype(
        np.uint32)
    return keys, vals


@pytest.mark.parametrize("overwrite", [True, False])
@pytest.mark.parametrize("unique_cap", [1 << 13, 256])
def test_insert_exact_parity(overwrite, unique_cap):
    """Both write modes; with a small unique_cap the call pages with
    min_key = last_key, and every page's stats must match."""
    jpool, tpool = _pools()
    keys, vals = _exact_inputs(jpool)
    jmin = tmin = None
    pages = 0
    while True:
        jpool, jst = jsvo.insert_exact(
            jpool, jnp.asarray(keys), jnp.asarray(vals), depth=DEPTH,
            unique_cap=unique_cap, min_key=jmin, shallow_level=4,
            overwrite=overwrite)
        tpool, tst = svo.insert_exact(
            tpool, torch.from_numpy(keys), to_t(vals), depth=DEPTH,
            unique_cap=unique_cap, min_key=tmin, shallow_level=4,
            overwrite=overwrite)
        pages += 1
        _assert_pool_equal(tpool, jpool, f"page {pages}")
        for name in jsvo.InsertStats._fields:
            a, b = getattr(tst, name), np.asarray(getattr(jst, name))
            np.testing.assert_array_equal(
                words(a) if b.dtype == np.uint32 else a.numpy(), b,
                err_msg=f"page {pages} stats.{name}")
        if not bool(jst.unique_overflow):
            break
        jmin, tmin = jst.last_key, tst.last_key
    assert pages == 1 if unique_cap > 4096 else pages > 2


def test_insert_exact_overflowing_pool_parity():
    """A pool too small for the keys: the allocations that do not fit are
    dropped and the pool flags its overflow, identically."""
    jpool = jsvo.create(1 << 10, jnp.zeros(3), 1.0)
    tpool = _port_pool(jpool)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << (3 * DEPTH), 3000).astype(np.int32)
    vals = rng.integers(0, 1 << 32, 3000, dtype=np.uint64).astype(np.uint32)
    jpool, jst = jsvo.insert_exact(jpool, jnp.asarray(keys),
                                   jnp.asarray(vals), depth=DEPTH,
                                   unique_cap=4096)
    tpool, tst = svo.insert_exact(tpool, torch.from_numpy(keys), to_t(vals),
                                  depth=DEPTH, unique_cap=4096)
    assert bool(jpool.overflowed)
    _assert_pool_equal(tpool, jpool)
    np.testing.assert_array_equal(tst.touched_leaf_nodes.numpy(),
                                  np.asarray(jst.touched_leaf_nodes))


def test_grow_capacity_parity():
    jpool, tpool = _pools()
    jg = jsvo.grow_capacity(jpool._replace(overflowed=jnp.bool_(True)),
                            1 << 17)
    tg = svo.grow_capacity(tpool._replace(overflowed=torch.tensor(True)),
                           1 << 17)
    _assert_pool_equal(tg, jg)
    with pytest.raises(AssertionError):
        svo.grow_capacity(tpool, 1 << 15)
    with pytest.raises(AssertionError, match="prealloc"):
        svo.grow_capacity(svo.create(8192, (0, 0, 0), 1.0, device=DEVICE),
                          1 << 14)


# 64x48 frames at depth 7, 5 cm leaves, a lazy splat stream
BASE = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                  pyramid_depth=2, pyramid_iters=(4, 4),
                  voxel_resolution=0.05, max_depth=7, node_capacity=1 << 14,
                  leaf_capacity=1 << 12, extract_capacity=1 << 12,
                  insert_unique_cap=1 << 11, max_march_iters=24,
                  precompile_ahead=False)
# (name, config overrides, grow_nodes, grow_leaves)
GROWTH = [
    ("pad", {}, True, True),
    # a registry of 512 rows overflows on the first frames: it is rebuilt
    # from an extraction of the pool
    ("registry_rebuild", {"leaf_capacity": 1 << 9}, False, True),
    # 8192 -> 16384 slots is 3 -> 4 dense levels: a rebuild
    ("prealloc_boundary", {"node_capacity": 8192,
                           "insert_dircache": True,
                           "saturation_gate": True}, True, False),
    ("prealloc_boundary_hybrid", {"node_capacity": 8192}, True, True),
]


@pytest.mark.parametrize("name,over,grow_nodes,grow_leaves", GROWTH,
                         ids=[g[0] for g in GROWTH])
def test_grow_state_parity(name, over, grow_nodes, grow_leaves):
    cfg = dataclasses.replace(BASE, **over)
    stream = orbit_frames(cfg, 3, step_angle=0.05)
    render = "cone_hybrid" if name.endswith("hybrid") else "splat"
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(stream[2][0]))
    for i in range(3):
        jstate, _ = jpipeline.step(jstate, jax_frame(stream[0], stream[1], i),
                                   cfg, render=render)
    tcfg = port_config(cfg)
    tstate = convert.state_from_numpy(np_state(jstate), tcfg, device=DEVICE)
    if name == "registry_rebuild":
        assert bool(jstate.leaves.overflowed)
    jstate, jcfg = jpipeline.grow_state(jstate, cfg, grow_nodes=grow_nodes,
                                        grow_leaves=grow_leaves)
    tstate, tcfg = pipeline.grow_state(tstate, tcfg, grow_nodes=grow_nodes,
                                       grow_leaves=grow_leaves)
    assert (tcfg.node_capacity, tcfg.leaf_capacity) == \
        (jcfg.node_capacity, jcfg.leaf_capacity)
    assert_state_equal(tstate, jstate, name)
    assert not bool(tstate.leaves.overflowed)
    if name.startswith("prealloc"):
        assert svo.prealloc_levels(tcfg.node_capacity) == 4
        # the rebuilt map is current: every flag cleared
        assert not bool(tstate.interior_stale)
    # both keep stepping identically on the grown map
    jstate, jo = jpipeline.step(jstate, jax_frame(stream[0], stream[1], 2),
                                jcfg, render=render)
    tstate, to = pipeline.step(
        tstate, convert.frame_from_numpy(stream[0][2], stream[1][2],
                                         device=DEVICE), tcfg, render=render)
    assert int(to.map_nodes) == int(jo.map_nodes)
    assert int(to.map_leaves) == int(jo.map_leaves)
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=1e-4)
