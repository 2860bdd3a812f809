"""Port parity: the lazy SVO insert against the JAX package and the numpy
oracle, over a multi-frame stream of identical world points.

Tolerances: child, value, n_nodes, overflowed, unique_overflow and
last_key are bit-identical. A leaf value may differ by one level per
channel only where the reference's XLA-compiled blend (reciprocal
multiply + FMA, torch_parity.xla_blend) and the port's op-by-op blend
round differently, which the test checks row by row."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from oracle import OracleOctree, morton_key
from torch_parity import random_cloud, to_t, words, xla_blend

from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import svo


def _port_pool(jpool):
    return svo.SVONodePool(*(to_t(np.asarray(x)) for x in jpool))


def _segment_sums(pts, cols, keys_of_rows, depth):
    """Per-leaf colour sums and counts of the rows' keys (numpy)."""
    from octree_slam_tpu.map import morton as jmorton
    keys = np.asarray(jmorton.encode(jnp.asarray(pts), jnp.zeros(3), 1.0,
                                     depth)[0])
    c8 = np.clip(np.round(cols * 255.0), 0, 255).astype(np.int64)
    order = np.argsort(keys, kind="stable")
    uk, start, cnt = np.unique(keys[order], return_index=True,
                               return_counts=True)
    sums = np.add.reduceat(c8[order], start, axis=0)
    pos = np.searchsorted(uk, keys_of_rows)
    return sums[pos], cnt[pos]


def _assert_values(jv, tv, old, jst, pts, cols, depth):
    """Bit-identical words, except rows the XLA blend explains."""
    diff = np.nonzero(jv != tv)[0]
    if not diff.size:
        return
    tn = np.asarray(jst.touched_leaf_nodes)
    tk = np.asarray(jst.touched_leaf_keys)
    row_of = {int(n): i for i, n in enumerate(tn) if n >= 0}
    assert all(int(d) in row_of for d in diff), "non-leaf value differs"
    rows = np.array([row_of[int(d)] for d in diff])
    sums, cnt = _segment_sums(pts, cols, tk[rows], depth)
    np.testing.assert_array_equal(xla_blend(old[diff], sums, cnt), jv[diff])
    for s in (0, 8, 16):
        assert np.abs(((jv[diff] >> s) & 0xFF).astype(int)
                      - ((tv[diff] >> s) & 0xFF).astype(int)).max() <= 1
    np.testing.assert_array_equal(jv[diff] >> 24, tv[diff] >> 24)


@pytest.mark.parametrize("unique_cap", [1 << 11, 1 << 14])
def test_insert_stream_bit_identical(unique_cap):
    """Five frames of one cloud moving slowly (revisits + new leaves); the
    small cap pages every frame through min_key, the large one never."""
    depth, cap = 6, 1 << 14
    jpool = jsvo.create(cap, jnp.zeros(3), 1.0)
    tpool = svo.create(cap, torch.zeros(3), 1.0)
    pts0, cols = random_cloud(6000, seed=11, lo=-0.7, hi=0.7)
    paged = 0
    for fr in range(5):
        pts = pts0 + np.float32(0.02 * fr)
        old = words(tpool.value).copy()
        jmin = tmin = None
        while True:
            jpool, jst = jsvo.insert(jpool, jnp.asarray(pts),
                                     jnp.asarray(cols), depth=depth,
                                     unique_cap=unique_cap, min_key=jmin,
                                     update_interior=False)
            tpool, tst = svo.insert(tpool, to_t(pts), to_t(cols),
                                    depth=depth, unique_cap=unique_cap,
                                    min_key=tmin)
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
            _assert_values(np.asarray(jpool.value), words(tpool.value), old,
                           jst, pts, cols, depth)
            if not bool(jst.unique_overflow):
                break
            paged += 1
            jmin, tmin = jst.last_key, tst.last_key
            # later pages blend onto the port's own (equal) values
            old = words(tpool.value).copy()
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
    tpool, tst = svo.insert(svo.create(cap, torch.zeros(3), 1.0), to_t(pts),
                            to_t(cols), depth=depth, unique_cap=1024)
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
    tpool, tst = svo.insert(svo.create(64, torch.zeros(3), 1.0), to_t(pts),
                            to_t(cols), depth=depth, unique_cap=1024)
    assert bool(tst.overflowed) and bool(jst.overflowed)
    np.testing.assert_array_equal(tpool.child.numpy(), np.asarray(jpool.child))
    np.testing.assert_array_equal(words(tpool.value), np.asarray(jpool.value))
    assert int(tpool.n_nodes) == int(jpool.n_nodes) <= 64


def test_leaves_match_oracle():
    """Leaf values against the independent numpy model (tests/oracle.py):
    alpha exact, colour within the oracle's own float64 rounding."""
    depth = 5
    pts, cols = random_cloud(400, seed=7)
    pool = svo.create(1 << 13, torch.zeros(3), 1.0)
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
