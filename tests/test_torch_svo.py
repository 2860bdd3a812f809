"""Port parity: the SVO insert, lazy and eager, `tile_topology` and
`refresh_interior` against the JAX package and the numpy oracle, over a
multi-frame stream of identical world points.

Tolerances: child, value, n_nodes, overflowed, unique_overflow and
last_key are bit-identical, and so are the eager insert's interior values,
the tile topology and the refreshed interiors. Leaf values are too: the
port blends as the reference's compiled insert does (packing.blend_mean;
tests/test_torch_fuzz_map.py pins a leaf where the op-by-op blend lands
one level apart)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from oracle import OracleOctree, morton_key
from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, random_cloud, to_t, words

from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import svo


def _port_pool(jpool):
    return svo.SVONodePool(*(to_t(np.asarray(x)) for x in jpool))


@pytest.mark.parametrize("unique_cap", [1 << 11, 1 << 14])
def test_insert_stream_bit_identical(unique_cap):
    """Five frames of one cloud moving slowly (revisits + new leaves); the
    small cap pages every frame through min_key, the large one never."""
    depth, cap = 6, 1 << 14
    jpool = jsvo.create(cap, jnp.zeros(3), 1.0)
    tpool = svo.create(cap, torch.zeros(3), 1.0, device=DEVICE)
    pts0, cols = random_cloud(6000, seed=11, lo=-0.7, hi=0.7)
    paged = 0
    for fr in range(5):
        pts = pts0 + np.float32(0.02 * fr)
        jmin = tmin = None
        while True:
            jpool, jst = jsvo.insert(jpool, jnp.asarray(pts),
                                     jnp.asarray(cols), depth=depth,
                                     unique_cap=unique_cap, min_key=jmin,
                                     update_interior=False)
            tpool, tst = svo.insert(tpool, to_t(pts), to_t(cols),
                                    depth=depth, unique_cap=unique_cap,
                                    min_key=tmin, update_interior=False)
            np.testing.assert_array_equal(tpool.child.numpy(),
                                          np.asarray(jpool.child))
            assert int(tpool.n_nodes) == int(jpool.n_nodes)
            assert bool(tpool.overflowed) == bool(jpool.overflowed)
            for name in ("unique_overflow", "last_key", "n_unique",
                         "n_valid", "new_nodes", "new_leaf_count",
                         "shallow_allocs"):
                assert int(getattr(tst, name)) == int(getattr(jst, name)), \
                    name
            for name in ("new_leaf_keys", "new_leaf_nodes",
                         "touched_leaf_nodes", "touched_leaf_keys"):
                np.testing.assert_array_equal(
                    getattr(tst, name).numpy(),
                    np.asarray(getattr(jst, name)), err_msg=name)
            np.testing.assert_array_equal(words(tpool.value),
                                          np.asarray(jpool.value))
            if not bool(jst.unique_overflow):
                break
            paged += 1
            jmin, tmin = jst.last_key, tst.last_key
    assert (paged > 0) == (unique_cap < 6000)


def test_pad_case_cap_above_point_count():
    """unique_cap > N pads the compacted uniques (svo.py:208-212)."""
    depth, cap = 5, 1 << 13
    pts, cols = random_cloud(300, seed=3)
    pts[::17] = np.nan
    jpool, jst = jsvo.insert(jsvo.create(cap, jnp.zeros(3), 1.0),
                             jnp.asarray(pts), jnp.asarray(cols),
                             depth=depth, unique_cap=1024,
                             update_interior=False)
    tpool, tst = svo.insert(
        svo.create(cap, torch.zeros(3), 1.0, device=DEVICE), to_t(pts),
        to_t(cols), depth=depth, unique_cap=1024, update_interior=False)
    np.testing.assert_array_equal(tpool.child.numpy(), np.asarray(jpool.child))
    np.testing.assert_array_equal(words(tpool.value), np.asarray(jpool.value))
    np.testing.assert_array_equal(tst.touched_leaf_keys.numpy(),
                                  np.asarray(jst.touched_leaf_keys))
    assert int(tst.last_key) == int(jst.last_key)
    assert not bool(tst.unique_overflow)


def test_node_capacity_overflow_matches():
    depth = 6
    pts, cols = random_cloud(500, seed=5)
    jpool, jst = jsvo.insert(jsvo.create(64, jnp.zeros(3), 1.0),
                             jnp.asarray(pts), jnp.asarray(cols),
                             depth=depth, update_interior=False,
                             unique_cap=1024)
    tpool, tst = svo.insert(
        svo.create(64, torch.zeros(3), 1.0, device=DEVICE), to_t(pts),
        to_t(cols), depth=depth, unique_cap=1024, update_interior=False)
    assert bool(tst.overflowed) and bool(jst.overflowed)
    np.testing.assert_array_equal(tpool.child.numpy(), np.asarray(jpool.child))
    np.testing.assert_array_equal(words(tpool.value), np.asarray(jpool.value))
    assert int(tpool.n_nodes) == int(jpool.n_nodes) <= 64


def test_leaves_match_oracle():
    """Leaf values against the independent numpy model (tests/oracle.py):
    alpha exact, colour within the oracle's own float64 rounding."""
    depth = 5
    pts, cols = random_cloud(400, seed=7)
    pool = svo.create(1 << 13, torch.zeros(3), 1.0, device=DEVICE)
    oracle = OracleOctree(np.zeros(3), 1.0, depth)
    for half in (slice(0, 250), slice(150, 400)):
        pool, st = svo.insert(pool, to_t(pts[half]), to_t(cols[half]),
                              depth=depth, unique_cap=1024)
        oracle.insert(pts[half], cols[half])
    keys = st.touched_leaf_keys.numpy()
    nodes = st.touched_leaf_nodes.numpy()
    r, g, b, a = (c.numpy() for c in packing.unpack_rgba8(pool.value))
    checked = 0
    for p in pts:
        key = morton_key(p, np.zeros(3), 1.0, depth)
        ov = oracle.values[(depth, key)]
        node = nodes[keys == key]
        if node.size == 0:      # leaf last touched by the first half only
            continue
        n = node[0]
        assert a[n] == ov[3]
        assert max(abs(r[n] - ov[0]), abs(g[n] - ov[1]),
                   abs(b[n] - ov[2])) <= 1
        checked += 1
    assert checked > 200


def _stream(unique_cap, eager, frames=3, depth=6, cap=1 << 14):
    """One moving cloud through both packages' inserts (paged through
    min_key where the cap is small); yields the pools after every page."""
    jpool = jsvo.create(cap, jnp.zeros(3), 1.0)
    tpool = svo.create(cap, torch.zeros(3), 1.0, device=DEVICE)
    pts0, cols = random_cloud(300, seed=13, lo=-0.7, hi=0.7)
    for fr in range(frames):
        pts = pts0 + np.float32(0.01 * fr)
        jmin = tmin = None
        while True:
            jpool, jst = jsvo.insert(jpool, jnp.asarray(pts),
                                     jnp.asarray(cols), depth=depth,
                                     unique_cap=unique_cap, min_key=jmin,
                                     update_interior=eager, emit_mips=eager)
            tpool, tst = svo.insert(tpool, to_t(pts), to_t(cols),
                                    depth=depth, unique_cap=unique_cap,
                                    min_key=tmin, update_interior=eager,
                                    emit_mips=eager)
            yield jpool, tpool, jst, tst
            if not bool(jst.unique_overflow):
                break
            jmin, tmin = jst.last_key, tst.last_key


@pytest.mark.parametrize("unique_cap", [1 << 7, 1 << 9])
def test_eager_insert_bit_identical(unique_cap):
    """update_interior=True: the bottom-up mipmap writes the same interior
    words, page by page (8^level < unique_cap at levels 1 and 2, where
    the reference compacts its rows and the port masks them)."""
    pages = 0
    for jpool, tpool, jst, tst in _stream(unique_cap, eager=True):
        pages += 1
        np.testing.assert_array_equal(tpool.child.numpy(),
                                      np.asarray(jpool.child))
        np.testing.assert_array_equal(words(tpool.value),
                                      np.asarray(jpool.value))
        assert int(tpool.n_nodes) == int(jpool.n_nodes)
        assert int(tst.last_key) == int(jst.last_key)
    assert (pages > 3) == (unique_cap < 300)
    assert not bool(tpool.overflowed)
    # the interiors really were written: the root tile is occupied
    assert bool(packing.is_occupied(tpool.value[:8]).any())


def test_insert_without_mips_emits_the_placeholder():
    pool = svo.create(1 << 12, torch.zeros(3), 1.0, device=DEVICE)
    pts, cols = random_cloud(50, seed=1)
    _, st = svo.insert(pool, to_t(pts), to_t(cols), depth=4, unique_cap=64)
    assert st.mip_idx.tolist() == [2**31 - 1] and st.mip_val.tolist() == [0]


def test_tile_topology_bit_identical():
    *_, (jpool, tpool, _, _) = _stream(1 << 9, eager=False)
    jt = jsvo.tile_topology(jpool, depth=6)
    tt = svo.tile_topology(tpool, depth=6)
    for name, t, j in zip(("parent", "level", "key"), tt, jt):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert int((tt[1] == 6).sum()) > 100    # leaf tiles were found


def test_refresh_interior_bit_identical_and_equals_eager():
    """Lazy inserts + refresh_interior: the JAX package's words, and the
    words the eager inserts leave (the reference's own invariant,
    tests/test_lazy_interior.py)."""
    *_, (jlazy, tlazy, _, _) = _stream(1 << 9, eager=False)
    *_, (_, teager, _, _) = _stream(1 << 9, eager=True)
    assert not torch.equal(tlazy.value, teager.value)
    jref = jsvo.refresh_interior(jlazy, depth=6)
    tref = svo.refresh_interior(tlazy, depth=6)
    np.testing.assert_array_equal(words(tref.value), np.asarray(jref.value))
    assert torch.equal(tref.value, teager.value)
    assert torch.equal(tref.child, teager.child)
    again = svo.refresh_interior(
        tref._replace(value=tref.value.clone()), depth=6)
    assert torch.equal(again.value, teager.value)     # idempotent
