"""Port parity: the insert's directory cache (svo._dir_lookup, the cached
branch of svo.insert, splat.append_new_leaves_cached) against the JAX
package and against the port's own uncached insert.

Everything here is integer structure on identical inputs (the same numpy
point clouds into both packages), so every comparison is exact: `child`,
`n_nodes`, the registry columns, `hit_aux`, `dir_hits`, the stats' key and
node columns. Leaf *values* are compared exactly too, between the port's
cached and uncached inserts and between the packages (the port blends as
the reference's compiled insert does, packing.blend_mean).

A frame with more first-seen keys than `miss_cap` defers every unique from
the first dropped miss on to the pager: the pass must stop at the same key
as the reference's, and the paged result must hold the leaf content of one
uncached pass."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, INVALID_KEY, random_cloud, to_t, words

from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu.render import splat as jsplat
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.render import splat

DEPTH, CAP, U = 7, 1 << 17, 4096
KW = dict(depth=DEPTH, unique_cap=U, update_interior=False)


def _clouds():
    """Two overlapping clouds: the second re-observes the first's second
    half and adds as many new points."""
    p1, c1 = random_cloud(3000, seed=3)
    p2, c2 = random_cloud(3000, seed=4)
    p2[:1500] = p1[1500:]
    return (p1, c1), (p2, c2)


def _pools():
    return (jsvo.create(CAP, jnp.zeros(3), jnp.float32(1.28)),
            svo.create(CAP, (0.0, 0.0, 0.0), 1.28, device=DEVICE))


def _dir_of(stats, as_jax):
    """The next insert's directory from an insert's stats, with registry
    positions made up as row + 100."""
    n = stats.touched_leaf_keys.shape[0]
    aux = np.arange(n, dtype=np.int32) + 100
    return dict(dir_keys=stats.touched_leaf_keys,
                dir_nodes=stats.touched_leaf_nodes,
                dir_vals=stats.touched_leaf_vals,
                dir_aux=jnp.asarray(aux) if as_jax else to_t(aux))


def _values_close(tval, jval, what):
    np.testing.assert_array_equal(words(tval), np.asarray(jval),
                                  err_msg=what)


def _same_structure(tpool, ts, jpool, js, what=""):
    np.testing.assert_array_equal(tpool.child.numpy(),
                                  np.asarray(jpool.child), err_msg=what)
    assert int(tpool.n_nodes) == int(jpool.n_nodes), what
    _values_close(tpool.value, jpool.value, what)
    for f in ("new_leaf_keys", "new_leaf_nodes", "touched_leaf_nodes",
              "touched_leaf_keys", "hit_aux", "sat_transition"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what} {f}")
    for f in ("new_leaf_count", "new_nodes", "n_unique", "dir_hits",
              "last_key", "unique_overflow", "overflowed"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), (what, f)


@pytest.mark.parametrize("dkeys,q,want", [
    ([3, 9, 17, INVALID_KEY, INVALID_KEY], [1, 3, 9, 10, 17, INVALID_KEY],
     [-1, 0, 1, -1, 2, -1]),
    ([17, INVALID_KEY, 3], [3, 17], [2, 0]),           # unsorted directory
    ([INVALID_KEY] * 4, [0, 5], [-1, -1]),             # cleared directory
])
def test_dir_lookup(dkeys, q, want):
    got = svo._dir_lookup(torch.tensor(dkeys, dtype=torch.int32),
                          torch.tensor(q, dtype=torch.int32))
    ref = jsvo._dir_lookup(jnp.asarray(dkeys, jnp.int32),
                           jnp.asarray(q, jnp.int32))
    assert got.tolist() == want == list(np.asarray(ref))


def test_dir_lookup_random_matches_reference():
    rng = np.random.default_rng(0)
    dk = rng.permutation(5000)[:1024].astype(np.int32)
    dk[rng.random(1024) < 0.2] = INVALID_KEY
    q = np.sort(rng.permutation(5000)[:2048]).astype(np.int32)
    q[-100:] = INVALID_KEY
    got = svo._dir_lookup(to_t(dk), to_t(q)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsvo._dir_lookup(jnp.asarray(dk), jnp.asarray(q))))
    hit = got >= 0
    assert 100 < hit.sum() < len(q) and (dk[got[hit]] == q[hit]).all()


@pytest.fixture(scope="module")
def warm():
    """Both packages' pools after the first cloud, and that insert's
    stats (the second insert's directory)."""
    (p1, c1), _ = _clouds()
    jpool, tpool = _pools()
    jpool, js = jsvo.insert(jpool, jnp.asarray(p1), jnp.asarray(c1), **KW)
    tpool, ts = svo.insert(tpool, to_t(p1), to_t(c1), **KW)
    _same_structure(tpool, ts, jpool, js, "first insert")
    assert int(ts.dir_hits) == -1 and int((ts.hit_aux >= 0).sum()) == 0
    return jpool, js, tpool, ts


def _clone(pool):
    return pool._replace(child=pool.child.clone(), value=pool.value.clone())


@pytest.mark.parametrize("miss_cap", [2048, 4096])
def test_cached_insert_matches_reference_and_uncached(warm, miss_cap):
    jpool, js, tpool, ts = warm
    _, (p2, c2) = _clouds()
    jp2, js2 = jsvo.insert(jpool, jnp.asarray(p2), jnp.asarray(c2),
                           miss_cap=miss_cap, **_dir_of(js, True), **KW)
    tp2, ts2 = svo.insert(_clone(tpool), to_t(p2), to_t(c2),
                          miss_cap=miss_cap, **_dir_of(ts, False), **KW)
    _same_structure(tp2, ts2, jp2, js2, "cached insert")
    hits = int(ts2.dir_hits)
    assert 500 < hits < int(ts2.n_unique)          # hits and misses
    assert int(ts2.new_leaf_count) > 500 and not bool(ts2.unique_overflow)
    aux = ts2.hit_aux.numpy()
    assert (aux >= 100).sum() == hits and set(aux[aux < 100]) == {-1}
    # no miss was dropped: the uncached insert's result, bit for bit
    tp3, ts3 = svo.insert(_clone(tpool), to_t(p2), to_t(c2), **KW)
    assert torch.equal(tp2.child, tp3.child)
    assert torch.equal(tp2.value, tp3.value)
    assert int(tp2.n_nodes) == int(tp3.n_nodes)
    for f in ("new_leaf_keys", "new_leaf_nodes", "touched_leaf_nodes",
              "touched_leaf_keys", "touched_leaf_vals", "sat_transition"):
        assert torch.equal(getattr(ts2, f), getattr(ts3, f)), f


def _leaf_content(pool):
    """Sorted (key, word) of every written leaf, whatever the order the
    tiles were allocated in."""
    _, level, tkey = svo.tile_topology(pool, depth=DEPTH)
    leaf_tile = (level == DEPTH).numpy()
    keys = ((tkey.numpy()[leaf_tile][:, None] << 3) | np.arange(8)).ravel()
    vals = words(pool.value).reshape(-1, 8)[leaf_tile].ravel()
    written = vals != (127 << 24)
    order = np.argsort(keys[written], kind="stable")
    return keys[written][order], vals[written][order]


def test_miss_cap_overflow_defers_to_the_pager(warm):
    jpool, js, tpool, ts = warm
    _, (p2, c2) = _clouds()
    miss_cap = 256                                  # ~1500 first-seen keys
    jp, jst = jsvo.insert(jpool, jnp.asarray(p2), jnp.asarray(c2),
                          miss_cap=miss_cap, **_dir_of(js, True), **KW)
    tp, tst = svo.insert(_clone(tpool), to_t(p2), to_t(c2),
                         miss_cap=miss_cap, **_dir_of(ts, False), **KW)
    _same_structure(tp, tst, jp, jst, "overflowing pass")
    assert bool(tst.unique_overflow) and int(tst.new_leaf_count) == miss_cap
    assert int(tst.n_unique) > int((tst.touched_leaf_nodes >= 0).sum())
    pages = 0
    while bool(tst.unique_overflow):                # uncached, as the step
        jp, jst = jsvo.insert(jp, jnp.asarray(p2), jnp.asarray(c2),
                              min_key=jst.last_key, **KW)
        tp, tst = svo.insert(tp, to_t(p2), to_t(c2), min_key=tst.last_key,
                             **KW)
        pages += 1
        _same_structure(tp, tst, jp, jst, f"page {pages}")
    assert pages == 1
    one, _ = svo.insert(_clone(tpool), to_t(p2), to_t(c2), **KW)
    assert int(tp.n_nodes) == int(one.n_nodes)
    for a, b in zip(_leaf_content(tp), _leaf_content(one)):
        np.testing.assert_array_equal(a, b)
    # the pages split elsewhere, so tiles were allocated in another order
    assert not torch.equal(tp.child, one.child)


def test_cache_on_an_eager_insert_raises(warm):
    _, _, tpool, ts = warm
    (p1, c1), _ = _clouds()
    for kw in ({"update_interior": True}, {"emit_mips": True}):
        with pytest.raises(ValueError):
            svo.insert(tpool, to_t(p1), to_t(c1), depth=DEPTH, unique_cap=U,
                       miss_cap=64, **{"update_interior": False, **kw},
                       **_dir_of(ts, False))
    with pytest.raises(ValueError):
        svo.insert(tpool, to_t(p1), to_t(c1), miss_cap=64,
                   dir_keys=ts.touched_leaf_keys, **KW)


def test_cached_append_matches_reference(warm):
    """The registry through two frames: uncached append, then the cached
    one fed by the first frame's positions."""
    jpool, js, tpool, ts = warm
    _, (p2, c2) = _clouds()
    jl = jsplat.create_leaf_list(1 << 13, CAP)
    tl = splat.create_leaf_list(1 << 13, CAP, device=DEVICE)
    jl, jpos = jsplat.append_new_leaves_cached(jl, js, 1024)
    tl, tpos = splat.append_new_leaves_cached(tl, ts)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert int((tpos >= 0).sum()) == int(ts.new_leaf_count)

    def directory(st, pos):
        return dict(dir_keys=st.touched_leaf_keys,
                    dir_nodes=st.touched_leaf_nodes,
                    dir_vals=st.touched_leaf_vals, dir_aux=pos)

    jp2, js2 = jsvo.insert(jpool, jnp.asarray(p2), jnp.asarray(c2),
                           miss_cap=2048, **directory(js, jpos), **KW)
    tp2, ts2 = svo.insert(_clone(tpool), to_t(p2), to_t(c2), miss_cap=2048,
                          **directory(ts, tpos), **KW)
    jl, jpos2 = jsplat.append_new_leaves_cached(jl, js2, 2048)
    tl, tpos2 = splat.append_new_leaves_cached(tl, ts2)
    np.testing.assert_array_equal(tpos2.numpy(), np.asarray(jpos2))
    for f in ("keys", "nodes", "node2pos"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    _values_close(tl.vals, jl.vals, "registry values")
    assert int(tl.count) == int(jl.count) > int(ts.new_leaf_count)
    # every touched row's position is the registry's own
    tn = ts2.touched_leaf_nodes
    want = torch.where(tn >= 0, tl.node2pos[tn.clamp(min=0)], -1)
    assert torch.equal(tpos2, want)
    # and the uncached append writes the same registry
    tl0 = splat.create_leaf_list(1 << 13, CAP, device=DEVICE)
    tl0 = splat.append_new_leaves(tl0, ts)
    tl0 = splat.append_new_leaves(tl0, ts2._replace(
        hit_aux=torch.full_like(ts2.hit_aux, -1)))
    for f in ("keys", "nodes", "vals", "node2pos", "count"):
        assert torch.equal(getattr(tl0, f), getattr(tl, f)), f
