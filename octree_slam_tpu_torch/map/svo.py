"""Sparse voxel octree as a static-capacity, Morton-keyed linear node pool
(counterpart: octree_slam_tpu/map/svo.py).

Same layout and insert algorithm as the reference package, so node indices
agree bit for bit: nodes live in a flat pool, a tile is 8 consecutive
slots, `child[i]` is the child-tile base (0 = none), `value[i]` the packed
RGBA8 word (held as an int32 bit pattern); the shallowest levels are dense
and preallocated (`create`), and one insert sorts the Morton keys, compacts
them to unique leaves with exact int32 colour means, descends the existing
tree once per unique, allocates every missing tile across all levels with
one cumsum, and alpha-blends the leaves.

This slice ports the lazy, uncached insert only: the interior mipmap
(`update_interior=True`), the dense-mip emission, the directory cache
(`dir_*`), the saturation-gate transition flags, `insert_exact`,
extraction, growth and queries wait for the slices that need them. The
pool's `child` and `value` tensors are updated in place (the JAX code
donates them); the returned pool carries the new scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.utils import compaction


class SVONodePool(NamedTuple):
    """Static-capacity linear octree; capacity is its array length."""

    child: torch.Tensor      # i32[cap] child tile base index; 0 = none
    value: torch.Tensor      # i32[cap] packed RGBA8 bit pattern
    n_nodes: torch.Tensor    # i32[]   allocation cursor (multiple of 8)
    center: torch.Tensor     # f32[3]  octree centre in world coords
    half_size: torch.Tensor  # f32[]   half edge length of the root cell
    overflowed: torch.Tensor  # bool[] capacity exhausted at some insert

    @property
    def capacity(self) -> int:
        return self.child.shape[0]


# node index of (level l, morton cell m) in the dense-preallocated region:
# _LEVEL_BASE[l] + m, the (8^l - 8)/7 breadth-first layout
_LEVEL_BASE = [0] + [((1 << (3 * l)) - 8) // 7 for l in range(1, 12)]


def prealloc_levels(capacity: int) -> int:
    """Number of fully preallocated shallow levels for a pool of this
    capacity (the reference package's schedule: level 6 from ~900k
    slots, level 5 from ~300k, else the deepest level at half the pool)."""
    if 3 * _LEVEL_BASE[7] <= capacity:
        return 6
    if 8 * _LEVEL_BASE[6] <= capacity:
        return 5
    for pre in (4, 3, 2, 1):
        if 2 * _LEVEL_BASE[pre + 1] <= capacity:
            return pre
    return 1


def create(capacity: int, center, half_size, device="cpu") -> SVONodePool:
    """Fresh pool with the shallow levels dense: the node of cell m at
    level l sits at (8^l - 8)/7 + m with child tile base(l+1) + 8m. Values
    start at the fresh-node word (rgb=0, alpha=127, svo.cu:274)."""
    pre = prealloc_levels(capacity)
    child_np = np.zeros((capacity,), np.int32)
    for l in range(1, pre):
        base, nxt = _LEVEL_BASE[l], _LEVEL_BASE[l + 1]
        m = np.arange(nxt - base, dtype=np.int32)
        child_np[base + m] = nxt + 8 * m
    return SVONodePool(
        child=torch.from_numpy(child_np).to(device),
        value=torch.full((capacity,), packing.EMPTY_VALUE, dtype=torch.int32,
                         device=device),
        n_nodes=torch.tensor(_LEVEL_BASE[pre + 1], dtype=torch.int32,
                             device=device),
        center=torch.as_tensor(center, dtype=torch.float32).to(device),
        half_size=torch.as_tensor(half_size, dtype=torch.float32).to(device),
        overflowed=torch.tensor(False, device=device),
    )


class InsertStats(NamedTuple):
    new_nodes: torch.Tensor        # i32[] nodes allocated by this insert
    n_valid: torch.Tensor          # i32[] valid input points
    n_unique: torch.Tensor         # i32[] unique leaf voxels processed
    overflowed: torch.Tensor       # bool[] any capacity exceeded (union)
    unique_overflow: torch.Tensor  # bool[] > unique_cap distinct leaves:
                                   #        re-insert with min_key=last_key
    last_key: torch.Tensor         # i32[] largest unique key processed
    shallow_allocs: torch.Tensor   # i32[] new tiles at levels <= shallow_level
    new_leaf_keys: torch.Tensor    # i32[U] keys of first-seen leaves, -1 pad
    new_leaf_nodes: torch.Tensor   # i32[U] node indices of those leaves
    new_leaf_count: torch.Tensor   # i32[]
    touched_leaf_nodes: torch.Tensor  # i32[U] node of every blended leaf, -1 pad
    touched_leaf_keys: torch.Tensor   # i32[U] their keys, INVALID_KEY pad
    touched_leaf_vals: torch.Tensor   # i32[U] their post-blend words


def _at(c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Rows c[i] with i clipped to range, zeroed where i < 0."""
    v = c[torch.clamp(i, 0, c.shape[0] - 1)]
    return torch.where((i >= 0)[:, None], v, 0)


def _unique_compact(skeys, svalid, scolors, unique_cap: int):
    """Compact sorted keys to their first `unique_cap` uniques with exact
    per-key colour means from int32 cumulative-sum differences.
    Returns (ukeys i32[U], mean_rgb f32[U,3] in [0,1], ulive bool[U],
    u_count i32[] = all uniques, processed or not)."""
    n = skeys.shape[0]
    dev = skeys.device
    first = compaction.first_occurrence(skeys, svalid)
    ranks, u_count = compaction.exclusive_ranks(first)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    (upos, ukeys), _ = compaction.compact_multi(
        [rows, skeys], first, unique_cap, fill=0)
    live_row = torch.arange(unique_cap, device=dev) < torch.clamp(
        u_count, max=unique_cap)
    upos = torch.where(live_row, upos, n)
    ukeys = torch.where(live_row, ukeys, morton.INVALID_KEY)

    w = svalid.to(torch.int32)
    # one int32 running sum of (rgb, count): exact, since the sums are
    # bounded by N * 255 < 2^31. Scanned as [4, N] along the contiguous
    # dim and viewed back as [N, 4]: an outer-dim scan of [N, 4] runs on
    # the card with only 4-way parallelism (measured 28.8 ms at N=307200
    # on an H100 at 700 W).
    csum = torch.cumsum(
        torch.cat([(scolors * w[:, None]).T, w[None, :]], dim=0), dim=1,
        dtype=torch.int32).T
    # the last processed unique's segment stops where the first
    # unprocessed unique (rank == unique_cap) begins
    pos_cut = torch.min(torch.where(first & (ranks == unique_cap), rows, n))
    nstart = torch.cat([upos[1:], pos_cut[None]])
    end = torch.clamp(nstart - 1, 0, n - 1)
    seg = _at(csum, end) - _at(csum, upos - 1)
    cnt = seg[:, 3].to(torch.float32)
    mean_rgb = seg[:, :3].to(torch.float32) / torch.clamp(
        cnt, min=1.0)[:, None] / 255.0
    ulive = live_row & (ukeys != morton.INVALID_KEY)
    return ukeys, mean_rgb, ulive, u_count


def _highest_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of non-negative int32 x (-1 for 0)."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int32) - 1


def _descend_alloc(child: torch.Tensor, n_nodes: torch.Tensor,
                   ukeys: torch.Tensor, ulive: torch.Tensor, *, cap: int,
                   depth: int, shallow_level: int):
    """Descend the existing tree once per unique sorted key, then allocate
    every missing tile across all levels with one cumsum and one child
    scatter (prepassCheckResize + expandTreeAtKeys, svo.cu:179-289).
    Updates `child` in place. Returns (n_nodes, paths[level 1..depth],
    reached[level 1..depth], n_new_tiles, shallow_allocs)."""
    dev = ukeys.device
    # Phase 1: shallow levels are dense, so their node index is bit math;
    # the dependent-gather chain starts below them.
    pre = min(prealloc_levels(cap), depth)
    path_old = [torch.where(ulive, _LEVEL_BASE[l]
                            + morton.level_prefix(ukeys, depth, l), 0)
                for l in range(1, pre + 1)]
    cur = path_old[-1]
    exist_level = ulive.to(torch.int32) * pre
    exists = ulive
    for level in range(pre, depth):
        tile = child[cur]
        has = exists & (tile > 0)
        cur = torch.where(has, tile + morton.octant_at(ukeys, depth, level + 1),
                          cur)
        exists = has
        exist_level = torch.where(has, level + 1, exist_level)
        path_old.append(cur)

    # Phase 2: two sorted uniques share the level-l prefix iff their keys
    # agree above bit 3*(depth-l); div_level is the shallowest level where
    # they differ (row 0 differs from everything).
    prev = torch.cat([ukeys[:1] ^ -1, ukeys[:-1]])
    h = _highest_bit((ukeys ^ prev) & 0x7FFFFFFF)
    div_level = depth - torch.div(h, 3, rounding_mode="floor")

    mat_lo = min(pre, depth - 1)
    levels = torch.arange(mat_lo, depth, dtype=torch.int32,
                          device=dev)[:, None]                    # [L', 1]
    first_all = ulive[None, :] & (div_level[None, :] <= levels)   # [L', U]
    # a new tile hangs off the level-l node iff the path stops at or above l
    need = first_all & (exist_level[None, :] <= levels)
    # one inclusive cumsum in (level, unique) order ranks every segment
    inc = torch.cumsum(need.reshape(-1).to(torch.int32), dim=0,
                       dtype=torch.int32).reshape(need.shape)
    tile_base = n_nodes + 8 * (inc - 1)
    fits = tile_base + 8 <= cap
    alloc = need & fits
    n_new = alloc.sum(dtype=torch.int32)
    shallow = (alloc & (levels <= shallow_level)).sum(dtype=torch.int32)

    # every row's view of its segment's new tile (-1 = none)
    seg_needed = ulive[None, :] & (exist_level[None, :] <= levels)
    seg_tile = torch.where(seg_needed & fits, tile_base, -1)
    octants = torch.stack(
        [morton.octant_at(ukeys, depth, l + 1) for l in range(mat_lo, depth)])
    path_old_m = torch.stack(path_old[mat_lo:])
    new_node = torch.clamp(seg_tile, min=0) + octants
    node_at = torch.where(exist_level[None, :] >= levels + 1, path_old_m,
                          new_node)
    ok_lvl = (exist_level[None, :] >= levels + 1) | (seg_tile >= 0)
    reached_m = torch.cumprod(ok_lvl.to(torch.int32), dim=0,
                              dtype=torch.int32).bool() & ulive[None, :]

    # one child scatter for every allocated tile whose parent was reached
    parent_idx = torch.cat([path_old[mat_lo - 1][None, :], node_at[:-1]])
    parent_ok = torch.cat([ulive[None, :], reached_m[:-1]])
    scatter_idx = torch.where(alloc & parent_ok, parent_idx, cap)
    compaction.scatter_set_(child, scatter_idx.reshape(-1),
                            tile_base.reshape(-1))

    paths = path_old[:mat_lo] + [node_at[i] for i in range(depth - mat_lo)]
    reached = [ulive] * mat_lo + [reached_m[i]
                                  for i in range(depth - mat_lo)]
    return n_nodes + 8 * n_new, paths, reached, n_new, shallow


def insert(pool: SVONodePool, points: torch.Tensor, colors: torch.Tensor,
           valid: torch.Tensor | None = None, *, depth: int,
           unique_cap: int = 1 << 16, shallow_level: int = 6,
           min_key: torch.Tensor | None = None):
    """Fuse a coloured point set into the leaves of the octree (the lazy
    path: interior values are not refreshed).

    points f32[N,3] world coords; colors f32[N,3] in [0,1]; valid optional
    bool[N]. At most `unique_cap` distinct leaves are processed, in sorted
    key order; a frame with more sets stats.unique_overflow and is finished
    exactly by re-running with min_key = stats.last_key until it clears.
    Returns (pool, stats); pool.child / pool.value are updated in place."""
    cap = pool.capacity
    U = unique_cap

    keys, key_valid = morton.encode(points, pool.center, pool.half_size,
                                    depth)
    if valid is not None:
        key_valid = key_valid & valid
    if min_key is not None:
        key_valid = key_valid & (keys > min_key)
    keys = torch.where(key_valid, keys, morton.INVALID_KEY)

    # one sort carries the colour payload packed into an int32 (colours
    # blend at 8 bits anyway, svo.cu:318-332)
    c8 = torch.clamp(torch.round(colors * 255.0), 0, 255).to(torch.int32)
    packed = c8[:, 0] | (c8[:, 1] << 8) | (c8[:, 2] << 16)
    skeys, order = torch.sort(keys, stable=True)
    spacked = packed[order]
    svalid = skeys != morton.INVALID_KEY
    sc = torch.stack([spacked & 0xFF, (spacked >> 8) & 0xFF,
                      (spacked >> 16) & 0xFF], dim=-1)

    ukeys, mean_rgb, ulive, u_count = _unique_compact(skeys, svalid, sc, U)
    n_nodes, paths, reached, total_new, shallow = _descend_alloc(
        pool.child, pool.n_nodes, ukeys, ulive, cap=cap, depth=depth,
        shallow_level=shallow_level)
    cur = paths[-1]
    old = pool.value[cur]

    # leaf blend (uniques are already deduplicated)
    leaf_ok = ulive & reached[-1]
    blended = packing.blend_value(old, mean_rgb)
    compaction.scatter_set_(pool.value, torch.where(leaf_ok, cur, cap),
                            blended)

    # first-ever-written leaves: the renderer's registry appends these
    is_new_leaf = leaf_ok & (old == packing.EMPTY_VALUE)
    new_leaf_keys, nl_count = compaction.compact(ukeys, is_new_leaf, U,
                                                 fill=-1)
    new_leaf_nodes, _ = compaction.compact(cur, is_new_leaf, U, fill=0)

    unique_overflow = u_count > U
    last_idx = torch.clamp(torch.clamp(u_count, max=U) - 1, 0, U - 1)
    pool_overflowed = pool.overflowed | (n_nodes + 8 > cap)
    stats = InsertStats(
        new_nodes=8 * total_new,
        n_valid=svalid.sum(dtype=torch.int32),
        n_unique=torch.clamp(u_count, max=U),
        overflowed=pool_overflowed | unique_overflow,
        unique_overflow=unique_overflow,
        last_key=ukeys[last_idx.reshape(1)].reshape(()),
        shallow_allocs=shallow,
        new_leaf_keys=new_leaf_keys,
        new_leaf_nodes=new_leaf_nodes,
        new_leaf_count=torch.clamp(nl_count, max=U),
        touched_leaf_nodes=torch.where(leaf_ok, cur, -1),
        touched_leaf_keys=torch.where(leaf_ok, ukeys, morton.INVALID_KEY),
        touched_leaf_vals=blended,
    )
    new_pool = pool._replace(n_nodes=n_nodes, overflowed=pool_overflowed)
    return new_pool, stats
