"""The map's op-interplay fuzz without JAX: the port's twin of
tests/test_fuzz_map.py.

One seed draws a random interleaving of
  insert (blending, paged on last_key past the unique cap),
  insert_exact (value-verbatim, overwriting or not),
  grow_capacity (a pad within one prealloc tier) and
  reroot_double (the volume doubled, [i, rest] -> [i, ~i, rest])
with run_fuzz's draws. A round is a short list of `Op`s, drawn against
the primary pool and then applied (run_rounds), the same ops to every
pool that is held against it: the JAX package's
(tests/test_torch_fuzz_map.py), the card's
(tests/test_torch_cuda_fuzz_map.py, at run_fuzz's sizes and at a run's)
and the numpy oracle (tests/oracle.py). The oracle helpers are copies of
test_fuzz_map.py's, with the words unpacked by the port's core/packing.
Nothing here imports JAX, so it runs where JAX is not installed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

import oracle as orc
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import morton, svo

# the op draw of run_fuzz (tests/test_fuzz_map.py)
OP_CHOICES = ["insert", "insert", "exact", "grow", "reroot"]


def unpack_word(word) -> List[int]:
    """An RGBA8 word (uint32 or its int32 pattern) as [r, g, b, a]."""
    w = torch.tensor(np.array(word, np.uint32).view(np.int32))
    return [int(c) for c in packing.unpack_rgba8(w)]


def rebuild_oracle_interiors(o: orc.OracleOctree) -> None:
    """Recompute every interior from the leaf dict with the mipmap rule
    (the oracle twin of svo.refresh_interior)."""
    leaves = {k: list(v) for (lv, k), v in o.values.items() if lv == o.depth}
    o.values = {}
    o.children = set()
    for k, v in leaves.items():
        for level in range(1, o.depth):
            p = k >> (3 * (o.depth - level))
            o.values.setdefault((level, p), o._init_value())
            o.children.add((level, p))
        o.values[(o.depth, k)] = v
    for level in range(o.depth - 1, 0, -1):
        for (lv, p) in [n for n in list(o.values) if n[0] == level]:
            kids = [o.values.get((level + 1, (p << 3) | i),
                                 o._init_value()) for i in range(8)]
            occ = [v for v in kids if v[3] > 127]
            rgb = ([sum(v[i] for v in occ) / len(occ) for i in range(3)]
                   if occ else [0.0, 0.0, 0.0])
            o.values[(level, p)] = [int(rgb[0]), int(rgb[1]), int(rgb[2]),
                                    max(v[3] for v in kids)]


def oracle_insert_exact(o: orc.OracleOctree, keys, vals, overwrite) -> None:
    for k, v in zip(keys, vals):
        k = int(k)
        leaf = (o.depth, k)
        cur = o.values.get(leaf)
        fresh = cur is None or cur == o._init_value()
        for level in range(1, o.depth):
            p = k >> (3 * (o.depth - level))
            o.values.setdefault((level, p), o._init_value())
            o.children.add((level, p))
        if overwrite or fresh:
            o.values[leaf] = unpack_word(v)
        else:
            o.values.setdefault(leaf, cur if cur is not None
                                else o._init_value())
    rebuild_oracle_interiors(o)


def oracle_reroot(o: orc.OracleOctree) -> None:
    d = o.depth
    low = (1 << (3 * (d - 1))) - 1
    leaves = {}
    for (lv, k), v in o.values.items():
        if lv != d:
            continue
        i1 = k >> (3 * (d - 1))
        leaves[(i1 << (3 * d)) | ((i1 ^ 7) << (3 * (d - 1))) | (k & low)] \
            = list(v)
    o.depth = d + 1
    o.half_size *= 2.0
    o.values = {(o.depth, k): v for k, v in leaves.items()}
    rebuild_oracle_interiors(o)


class Spec(NamedTuple):
    """The sizes of one fuzz; the defaults are run_fuzz's."""

    depth: int = 5
    capacity: int = 1 << 14
    half_size: float = 1.0
    unique_cap: int = 256
    insert_n: Tuple[int, int] = (50, 600)
    exact_n: Tuple[int, int] = (5, 120)
    max_capacity: int = 1 << 18   # a drawn "grow" stops here
    max_reroots: int = 2
    max_depth: int = 7
    # pad point and key arrays to this many rows with rows every op skips
    # (NaN points, key -1), so that a compiled op sees one shape a kind
    pad_to: int = 0
    # points on a plane patch of 300 x 220 leaves about the centre (a
    # depth frame's surface, inside the volume from depth 8 on) instead
    # of run_fuzz's box of 0.9 half sizes
    surface: bool = False


class Op(NamedTuple):
    kind: str                 # "grow" | "insert" | "exact" | "reroot"
    depth: int                # the key depth the op runs at
    capacity: int = 0         # grow: the new capacity
    points: Optional[np.ndarray] = None   # insert: f32[N, 3]
    colors: Optional[np.ndarray] = None   # insert: f32[N, 3]
    keys: Optional[np.ndarray] = None     # exact: i32[K], -1 = skip
    values: Optional[np.ndarray] = None   # exact: u32[K]
    overwrite: bool = True
    unique_cap: int = 256


class Round(NamedTuple):
    label: str          # the op drawn
    ops: List[Op]       # what it runs, headroom growth first
    depth: int          # the key depth after the round
    reroots: int        # re-roots so far


def headroom_grows(capacity: int, n_nodes: int, n_new: int,
                   depth: int) -> List[int]:
    """The capacities ensure_headroom (tests/test_fuzz_map.py) grows
    through before an op of n_new points: proactive growth as the
    production loops do it, since a silent capacity overflow drops leaves
    by design and the oracle does not model that."""
    need = 8 * n_new * max(1, depth - svo.prealloc_levels(capacity))
    caps = []
    while capacity - n_nodes < need:
        capacity *= 2
        caps.append(capacity)
    return caps


def _points(rng, n: int, half_size: float, depth: int,
            spec: Spec) -> np.ndarray:
    if not spec.surface:
        return rng.uniform(-0.9 * half_size, 0.9 * half_size,
                           (n, 3)).astype(np.float32)
    leaf = 2.0 * half_size / (1 << depth)
    axes, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    origin = rng.uniform(-0.2 * half_size, 0.2 * half_size, 3)
    uv = rng.uniform(-1.0, 1.0, (n, 2)) * np.array([150.0, 110.0]) * leaf
    noise = rng.normal(0.0, 0.25 * leaf, n)
    pts = origin + uv[:, :1] * axes[0] + uv[:, 1:] * axes[1] \
        + noise[:, None] * axes[2]
    return pts.astype(np.float32)


def _pad(a: np.ndarray, rows: int, fill) -> np.ndarray:
    if rows <= a.shape[0]:
        return a
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def draw_round(rng, pool: svo.SVONodePool, depth: int, reroots: int,
               spec: Spec = Spec(), op: Optional[str] = None) -> Round:
    """One round of run_fuzz's draws against `pool` (read, not changed):
    the op (drawn from OP_CHOICES unless given), its data and the growth
    it needs. Keys of an exact write are encoded by the port's morton."""
    cap, n_nodes = pool.capacity, int(pool.n_nodes)
    half = float(pool.half_size)
    if op is None:
        op = str(rng.choice(OP_CHOICES))
    ops: List[Op] = []
    if op == "insert":
        n = int(rng.integers(*spec.insert_n))
        pts = _points(rng, n, half, depth, spec)
        cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        ops += [Op("grow", depth, capacity=c)
                for c in headroom_grows(cap, n_nodes, n, depth)]
        ops.append(Op("insert", depth,
                      points=_pad(pts, spec.pad_to, np.float32(np.nan)),
                      colors=_pad(cols, spec.pad_to, np.float32(0)),
                      unique_cap=spec.unique_cap))
    elif op == "exact":
        n = int(rng.integers(*spec.exact_n))
        pts = _points(rng, n, half, depth, spec)
        keys, ok = morton.encode(torch.from_numpy(pts), pool.center.cpu(),
                                 pool.half_size.cpu(), depth)
        keys = np.unique(keys.numpy()[ok.numpy()])
        vals = rng.integers(0, 1 << 24, keys.size).astype(np.uint32) \
            | (rng.integers(120, 256, keys.size).astype(np.uint32) << 24)
        overwrite = bool(rng.integers(0, 2))
        ops += [Op("grow", depth, capacity=c)
                for c in headroom_grows(cap, n_nodes, int(keys.size), depth)]
        ops.append(Op("exact", depth,
                      keys=_pad(keys.astype(np.int32), spec.pad_to,
                                np.int32(-1)),
                      values=_pad(vals, spec.pad_to, np.uint32(0)),
                      overwrite=overwrite, unique_cap=spec.unique_cap))
    elif op == "grow":
        if cap < spec.max_capacity and (svo.prealloc_levels(cap * 2)
                                        == svo.prealloc_levels(cap)):
            ops.append(Op("grow", depth, capacity=cap * 2))
    elif op == "reroot":
        if reroots < spec.max_reroots and depth < spec.max_depth:
            if n_nodes + 8 ** svo.prealloc_levels(cap) > cap:
                ops.append(Op("grow", depth, capacity=cap * 2))
            ops.append(Op("reroot", depth))
            depth += 1
            reroots += 1
    else:
        raise ValueError(f"unknown op {op!r}")
    return Round(op, ops, depth, reroots)


def apply_port(pool: svo.SVONodePool, op: Op) -> Tuple[svo.SVONodePool, int]:
    """`op` on a port pool (on its own device). Returns (pool, the passes
    the op took: an insert or exact write pages on last_key)."""
    dev = pool.child.device
    if op.kind == "grow":
        return svo.grow_capacity(pool, op.capacity), 1
    if op.kind == "reroot":
        pool = svo.reroot_double(pool)
        assert not bool(pool.overflowed), "reroot_double overflowed"
        return pool, 1
    if op.kind == "insert":
        pts = torch.from_numpy(op.points).to(dev)
        cols = torch.from_numpy(op.colors).to(dev)

        def run(min_key):
            return svo.insert(pool, pts, cols, depth=op.depth,
                              unique_cap=op.unique_cap, min_key=min_key)
    elif op.kind == "exact":
        keys = torch.from_numpy(op.keys).to(dev)
        vals = torch.from_numpy(op.values.view(np.int32)).to(dev)

        def run(min_key):
            return svo.insert_exact(pool, keys, vals, depth=op.depth,
                                    unique_cap=op.unique_cap,
                                    min_key=min_key, overwrite=op.overwrite)
    else:
        raise ValueError(f"unknown op {op.kind!r}")
    pool, st = run(None)
    passes = 1
    while bool(st.unique_overflow):
        pool, st = run(st.last_key)
        passes += 1
    return pool, passes


def apply_oracle(o: orc.OracleOctree, op: Op
                 ) -> Tuple[orc.OracleOctree, int]:
    """`op` on the numpy oracle (growth changes nothing there), with
    apply_port's return."""
    if op.kind == "insert":
        live = np.isfinite(op.points).all(axis=1)
        o.insert(op.points[live], op.colors[live])
    elif op.kind == "exact":
        live = op.keys >= 0
        oracle_insert_exact(o, op.keys[live], op.values[live], op.overwrite)
    elif op.kind == "reroot":
        oracle_reroot(o)
    return o, 1


def run_rounds(rng, targets: list, appliers, spec: Spec, schedule,
               on_round: Callable) -> Dict[str, int]:
    """One fuzz: each entry of `schedule` (an op name, or None for
    run_fuzz's draw) is a round drawn against targets[0], a port pool,
    whose ops then run on every target in order, appliers[k] taking
    (targets[k], op) to (its new state, the passes it took). After each
    round on_round(step, round, targets, passes) sees the targets (the
    list is updated in place) and the passes of each op on each target.
    Returns the ops run by kind, and "paged": those that took more than
    one pass on targets[0]."""
    depth, reroots = spec.depth, 0
    seen = {"insert": 0, "exact": 0, "grow": 0, "reroot": 0, "paged": 0}
    for step, want in enumerate(schedule):
        rnd = draw_round(rng, targets[0], depth, reroots, spec, op=want)
        passes = []
        for op in rnd.ops:
            per = []
            for k, apply in enumerate(appliers):
                targets[k], n = apply(targets[k], op)
                per.append(n)
            passes.append(per)
            seen[op.kind] += 1
            seen["paged"] += per[0] > 1
        depth, reroots = rnd.depth, rnd.reroots
        on_round(step, rnd, targets, passes)
    return seen


def refreshed(pool: svo.SVONodePool, depth: int) -> svo.SVONodePool:
    """A copy of `pool` with every interior recomputed; the pool itself
    keeps its values, as the reference's functional refresh leaves them
    (a later eager insert reads the interiors it left stale)."""
    p = pool._replace(child=pool.child.clone(), value=pool.value.clone())
    return svo.refresh_interior(p, depth=depth)


def leaf_words(pool: svo.SVONodePool, depth: int,
               start_capacity: int = 1 << 13):
    """The occupied leaves of the refreshed copy of `pool`:
    (refreshed pool, keys i32[n], nodes i32[n], words u32[n]) as numpy."""
    p = refreshed(pool, depth)
    ex, _ = svo.extract_all_leaves(p, depth=depth,
                                   start_capacity=start_capacity)
    n = int(ex.count)
    nodes = ex.nodes[:n]
    words = p.value[torch.clamp(nodes, min=0)]
    return (p, ex.keys[:n].cpu().numpy(), nodes.cpu().numpy(),
            words.cpu().numpy().view(np.uint32))


def compare_oracle(pool: svo.SVONodePool, depth: int, o: orc.OracleOctree,
                   ctx: str) -> int:
    """Hold the pool's occupied leaves to the oracle's: the same leaf set,
    alpha equal, colour within one level (the oracle blends in float64
    and truncates). Returns the leaf count."""
    _, keys, _, words = leaf_words(pool, depth)
    got = dict(zip(keys.tolist(), words.tolist()))
    want = o.occupied_leaves()
    assert set(got) == set(want), (
        f"{ctx}: leaf sets differ: only-port="
        f"{sorted(set(got) - set(want))[:5]} only-oracle="
        f"{sorted(set(want) - set(got))[:5]}")
    for k, v in got.items():
        r, g, b, a = unpack_word(v)
        ov = want[k]
        assert a == ov[3], (ctx, k, a, ov)
        for i, c in enumerate((r, g, b)):
            assert abs(c - ov[i]) <= 1, (ctx, k, (r, g, b), ov)
    return len(got)


def pool_arrays(pool) -> dict:
    """The words of a pool of either package as numpy, for a word-for-word
    comparison: child, value (u32), n_nodes, the capacity, centre, half
    size and the overflow flag."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    value = host(pool.value)
    return {"child": host(pool.child).astype(np.int32),
            "value": value.view(np.uint32) if value.dtype == np.int32
            else value.astype(np.uint32),
            "n_nodes": int(host(pool.n_nodes)),
            "capacity": int(pool.child.shape[0]),
            "center": host(pool.center).astype(np.float32),
            "half_size": np.float32(host(pool.half_size)),
            "overflowed": bool(host(pool.overflowed))}


def differing_words(a: dict, b: dict) -> int:
    """Words that differ between two pool_arrays (arrays of two lengths
    count every word of the longer one)."""
    n = 0
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        if x.shape != y.shape:
            n += max(x.size, y.size)
            continue
        if x.dtype == np.float32:   # bit patterns, so -0.0 and NaN count
            x, y = x.view(np.uint32), y.view(np.uint32)
        n += int(np.count_nonzero(x != y))
    return n
