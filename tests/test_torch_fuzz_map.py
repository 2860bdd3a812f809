"""Port parity for the map's op interplay: tests/test_fuzz_map.py's random
interleavings of insert (paged on last_key), insert_exact (both overwrite
modes), grow_capacity and reroot_double, drawn per seed as run_fuzz draws
them (tests/torch_fuzz.py), through the port's pool, the JAX package's
pool and the numpy oracle.

After every round: the port's pool equals the JAX pool word for word
(child, value, n_nodes, the capacity, centre, half size, the overflow
flag) at the same depth; a refreshed copy of each (refresh_interior; the
pools themselves keep their stale interiors, as the reference's
functional refresh leaves them) equals word for word, and so do their
extract_all_leaves (keys, nodes, leaf words); the port's leaves match the
oracle's set, alpha exact and colour within one level (the oracle blends
in float64 and truncates).

Points and keys are padded to 600 rows that every op skips (NaN points,
key -1), so that the JAX package compiles each op once per capacity and
depth instead of once per drawn count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle as orc
from torch_fuzz import (Spec, apply_oracle, apply_port, compare_oracle,
                        differing_words, leaf_words, pool_arrays, run_rounds)
from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, to_t, words

from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import morton, svo

SPEC = Spec(pad_to=600)


def apply_jax(pool, op):
    """The same op on a JAX pool, paged like apply_port, with its return."""
    if op.kind == "grow":
        return jsvo.grow_capacity(pool, op.capacity), 1
    if op.kind == "reroot":
        pool = jsvo.reroot_double(pool)
        assert not bool(pool.overflowed)
        return pool, 1
    if op.kind == "insert":
        def run(min_key):
            return jsvo.insert(pool, jnp.asarray(op.points),
                               jnp.asarray(op.colors), depth=op.depth,
                               unique_cap=op.unique_cap, min_key=min_key)
    else:
        def run(min_key):
            return jsvo.insert_exact(pool, jnp.asarray(op.keys),
                                     jnp.asarray(op.values), depth=op.depth,
                                     unique_cap=op.unique_cap,
                                     min_key=min_key,
                                     overwrite=op.overwrite)
    pool, st = run(None)
    passes = 1
    while bool(st.unique_overflow):
        pool, st = run(st.last_key)
        passes += 1
    return pool, passes


def _assert_same(tp: dict, jp: dict, ctx: str) -> None:
    n = differing_words(tp, jp)
    if n:
        bad = [k for k in tp if differing_words({k: tp[k]}, {k: jp[k]})]
        raise AssertionError(f"{ctx}: {n} words differ in {bad}")


def _assert_refreshed_same(tpool, jpool, depth, ctx) -> None:
    """Refreshed copies of both pools word for word, and their
    extract_all_leaves: keys, nodes and leaf words."""
    tref, tkeys, tnodes, twords = leaf_words(tpool, depth)
    jref = jsvo.refresh_interior(jpool, depth=depth)
    jex, _ = jsvo.extract_all_leaves(jref, depth=depth,
                                     start_capacity=1 << 13)
    n = int(jex.count)
    jnodes = np.asarray(jex.nodes[:n])
    np.testing.assert_array_equal(words(tref.value), np.asarray(jref.value),
                                  err_msg=ctx)
    np.testing.assert_array_equal(tkeys, np.asarray(jex.keys[:n]),
                                  err_msg=ctx)
    np.testing.assert_array_equal(tnodes, jnodes, err_msg=ctx)
    np.testing.assert_array_equal(
        twords, np.asarray(jref.value)[np.maximum(jnodes, 0)], err_msg=ctx)


def run_fuzz_both(seed: int, n_rounds: int = 10) -> dict:
    """One seed's rounds through the port's pool, the JAX pool and the
    oracle, held together after every round; returns run_rounds' op
    counts."""
    def check(step, rnd, targets, passes):
        tpool, jpool, o = targets
        ctx = f"seed={seed} step={step} op={rnd.label}"
        _assert_same(pool_arrays(tpool), pool_arrays(jpool), ctx)
        assert [p[0] for p in passes] == [p[1] for p in passes], ctx
        assert o.depth == rnd.depth, ctx
        if step == n_rounds - 1:
            _assert_refreshed_same(tpool, jpool, rnd.depth, ctx)
        compare_oracle(tpool, rnd.depth, o, ctx)

    targets = [svo.create(SPEC.capacity, torch.zeros(3), SPEC.half_size,
                          device=DEVICE),
               jsvo.create(SPEC.capacity, jnp.zeros(3), SPEC.half_size),
               orc.OracleOctree((0.0, 0.0, 0.0), SPEC.half_size, SPEC.depth)]
    return run_rounds(np.random.default_rng(seed), targets,
                      (apply_port, apply_jax, apply_oracle), SPEC,
                      [None] * n_rounds, check)


# the ops each seed's ten rounds run (run_rounds' counts): between them
# the seeds page, grow and re-root, so the interplay the rounds check is
# there to check
REACHES = {
    0: dict(insert=2, exact=1, grow=1, reroot=2, paged=2),
    1: dict(insert=5, exact=1, grow=3, reroot=1, paged=3),
    2: dict(insert=5, exact=1, grow=2, reroot=2, paged=4),
    3: dict(insert=2, exact=3, grow=2, reroot=2, paged=1),
    4: dict(insert=2, exact=2, grow=3, reroot=2, paged=0),
    5: dict(insert=4, exact=0, grow=3, reroot=2, paged=3),
    6: dict(insert=2, exact=1, grow=3, reroot=2, paged=2),
    7: dict(insert=3, exact=1, grow=3, reroot=2, paged=1),
}


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_interleaving_matches_reference(seed):
    """Seeds 0-2 are tests/test_fuzz_map.py's; 3-7 add interleavings."""
    seen = run_fuzz_both(seed)
    assert seen == REACHES[seed]
    assert all(sum(r[k] for r in REACHES.values()) > 0 for k in seen)


def test_blend_rounds_as_the_compiled_insert():
    """A leaf whose blend the reference's compiled insert rounds to red 56
    where the blend with every op rounded as written (packing.blend_value)
    gives 55: XLA cancels the mean's `/ 255` against the blend's `* 255`,
    and so does the port's insert (packing.blend_mean), so the pools stay
    equal word for word. The leaf holds 0xac483b15 (insert_exact), then
    three samples of colour sum (383, 484, 581) land in it."""
    depth, cap = 5, 1 << 13
    key = np.array([12345], np.int32)
    old = np.array([0xAC483B15], np.uint32)
    c8 = np.array([[128, 162, 194], [128, 161, 194], [127, 161, 193]])
    cols = (c8 / 255.0).astype(np.float32)
    want = 0xAE6F5C38       # alpha 0xac + 2, blue 111, green 92, red 56
    jpool = jsvo.create(cap, jnp.zeros(3), 1.0)
    tpool = svo.create(cap, torch.zeros(3), 1.0, device=DEVICE)
    jpool, _ = jsvo.insert_exact(jpool, jnp.asarray(key), jnp.asarray(old),
                                 depth=depth, unique_cap=8)
    tpool, st = svo.insert_exact(tpool, to_t(key), to_t(old), depth=depth,
                                 unique_cap=8)
    centre = morton.decode_centers(to_t(key), torch.zeros(3), 1.0, depth)
    pts = np.repeat(centre.numpy(), 3, axis=0)
    jpool, _ = jsvo.insert(jpool, jnp.asarray(pts), jnp.asarray(cols),
                           depth=depth, unique_cap=8)
    tpool, _ = svo.insert(tpool, to_t(pts), to_t(cols), depth=depth,
                          unique_cap=8)
    node = int(st.touched_leaf_nodes[0])
    assert np.asarray(jpool.value)[node] == want
    assert words(tpool.value)[node] == want
    mean = torch.from_numpy(c8.sum(0, keepdims=True).astype(np.float32)) / 3
    assert words(packing.blend_value(to_t(old), mean / 255.0))[0] == want - 1
    _assert_same(pool_arrays(tpool), pool_arrays(jpool), "blend")
