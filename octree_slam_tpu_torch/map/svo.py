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

The insert is lazy (`update_interior=False`: leaves only) or eager (the
bottom-up mipmap over the touched paths, and with `emit_mips` the (flat
index, value) pairs the dense mirror of map/mips.py scatters). A lazy
insert can take last frame's directory (`dir_*`: leaf key -> node, value,
registry position) and then descends only for the keys it misses.
`tile_topology` and `refresh_interior` rebuild every interior value after
lazy frames. `insert_exact` writes leaf words verbatim (the restore half
of host tiering and the rebuilds across a prealloc boundary),
`extract_voxels` / `extract_all_leaves` enumerate the occupied leaves by a
frontier BFS, `grow_capacity` pads the pool, `reroot_double` doubles the
volume in place and `query_points` looks points up. The pool's `child` and
`value` tensors are updated in place (the JAX code donates them); the
returned pool carries the new scalars.
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


def prealloc_levels_legacy(capacity: int) -> int:
    """The schedule before level 6 was allowed at 1/3 headroom (levels 6
    and 5 both at 1/8 of the pool). Checkpoints written without a
    prealloc stamp were laid out under this rule: loaders compare it with
    prealloc_levels to refuse a pool whose dense layout no longer matches
    (a silent mismatch misindexes every shallow level)."""
    for pre in (6, 5):
        if 8 * _LEVEL_BASE[pre + 1] <= capacity:
            return pre
    for pre in (4, 3, 2, 1):
        if 2 * _LEVEL_BASE[pre + 1] <= capacity:
            return pre
    return 1


def create(capacity: int, center, half_size, device="cuda") -> SVONodePool:
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
    dir_hits: torch.Tensor         # i32[] directory hits, -1 = no directory
    hit_aux: torch.Tensor          # i32[U] dir_aux of the hit rows, else -1
    new_leaf_keys: torch.Tensor    # i32[U] keys of first-seen leaves, -1 pad
    new_leaf_nodes: torch.Tensor   # i32[U] node indices of those leaves
    new_leaf_count: torch.Tensor   # i32[]
    touched_leaf_nodes: torch.Tensor  # i32[U] node of every blended leaf, -1 pad
    touched_leaf_keys: torch.Tensor   # i32[U] their keys, INVALID_KEY pad
    touched_leaf_vals: torch.Tensor   # i32[U] their post-blend words
    sat_transition: torch.Tensor   # bool[U] rows whose alpha reached 255 in
                                   #         this insert: once in a leaf's
                                   #         life, so the saturation mask may
                                   #         add each leaf's bit
    mip_idx: torch.Tensor   # i32[M] dense-mirror cells this insert wrote,
                            #        mips.total_cells(depth) = no cell
    mip_val: torch.Tensor   # i32[M] their words (emit_mips; else M = 1)


def _at(c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Rows c[i] with i clipped to range, zeroed where i < 0."""
    v = c[torch.clamp(i, 0, c.shape[0] - 1)]
    return torch.where((i >= 0)[:, None], v, 0)


def _unique_compact(skeys, svalid, scolors, unique_cap: int):
    """Compact sorted keys to their first `unique_cap` uniques with exact
    per-key colour means from int32 cumulative-sum differences.
    Returns (ukeys i32[U], mean_rgb f32[U,3] in [0, 255], ulive bool[U],
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
    # in 0..255 units: the reference's compiled insert cancels its
    # `/ 255.0` against the blend's `* 255.0` (packing.blend_mean)
    mean_rgb = seg[:, :3].to(torch.float32) / torch.clamp(cnt,
                                                          min=1.0)[:, None]
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


def _dir_lookup(dkeys: torch.Tensor, qkeys: torch.Tensor) -> torch.Tensor:
    """For each query key the directory row that holds it, or -1. The
    directory is last frame's touched_leaf_keys: unique keys in any row
    order, INVALID_KEY on dead rows. One stable sort of the concatenation
    puts each query right after its directory row (directory rows come
    first, so they stay ahead of an equal query key): a merge in one sort
    instead of a binary search's chain of dependent gathers."""
    C, U = dkeys.shape[0], qkeys.shape[0]
    dev = qkeys.device
    # directory rows carry their row index (>= 0), queries -(pos + 1)
    payload = torch.cat([torch.arange(C, dtype=torch.int32, device=dev),
                         -1 - torch.arange(U, dtype=torch.int32, device=dev)])
    sk, order = torch.sort(torch.cat([dkeys, qkeys]), stable=True)
    sp = payload[order]
    minus1 = sk.new_full((1,), -1)
    prev_k = torch.cat([minus1, sk[:-1]])
    prev_p = torch.cat([minus1, sp[:-1]])
    is_q = sp < 0
    hit_r = torch.where(is_q & (prev_k == sk) & (prev_p >= 0)
                        & (sk != morton.INVALID_KEY), prev_p, -1)
    out = sk.new_full((U,), -1)
    return compaction.scatter_set_(out, torch.where(is_q, -1 - sp, U), hit_r)


def insert(pool: SVONodePool, points: torch.Tensor, colors: torch.Tensor,
           valid: torch.Tensor | None = None, *, depth: int,
           unique_cap: int = 1 << 16, shallow_level: int = 6,
           min_key: torch.Tensor | None = None,
           update_interior: bool = True, emit_mips: bool = False,
           dir_keys: torch.Tensor | None = None,
           dir_nodes: torch.Tensor | None = None,
           dir_vals: torch.Tensor | None = None,
           dir_aux: torch.Tensor | None = None, miss_cap: int = 0):
    """Fuse a coloured point set into the octree: allocate the missing
    tiles along each key path, alpha-blend the leaf colours and, with
    `update_interior`, re-mipmap the interior values along the touched
    paths (svoFromPointCloud). With update_interior=False the mipmap is
    deferred until `refresh_interior` runs.

    points f32[N,3] world coords; colors f32[N,3] in [0,1]; valid optional
    bool[N]. At most `unique_cap` distinct leaves are processed, in sorted
    key order; a frame with more sets stats.unique_overflow and is finished
    exactly by re-running with min_key = stats.last_key until it clears.
    `emit_mips` reports every written node as a (flat index, word) pair of
    the dense mirror in stats.mip_idx / mip_val.

    dir_keys / dir_nodes / dir_vals / dir_aux with miss_cap > 0 turn on
    the directory cache (lazy inserts only): the last insert's
    touched_leaf_keys / _nodes / _vals answer repeat keys without the
    descent and without the pool-value gather, and only the first-seen
    keys descend, on miss_cap lanes. dir_aux is a payload the caller
    chooses, handed back for the hits as stats.hit_aux (the pipeline keeps
    registry positions there). A frame with more than miss_cap misses
    defers every unique from the first dropped miss on to the unique-cap
    pager (unique_overflow + last_key), whose pages run uncached. The
    result equals the uncached insert's bit for bit as long as the
    directory is current: callers clear it whenever keys, node indices,
    registry positions or leaf values change under the map.

    Returns (pool, stats); pool.child / pool.value are updated in place."""
    cap = pool.capacity
    U = unique_cap
    if emit_mips:
        from octree_slam_tpu_torch.map import mips
    use_cache = dir_keys is not None and miss_cap > 0
    if use_cache and (update_interior or emit_mips):
        raise ValueError(
            "the directory cache serves only the lazy leaf path: the "
            "interior mipmap and the dense-mirror pairs need the full "
            "per-level paths, which cache hits skip")
    if use_cache and (dir_nodes is None or dir_vals is None
                      or dir_aux is None):
        raise ValueError("the directory cache needs dir_nodes, dir_vals "
                         "and dir_aux beside dir_keys")

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
    dev = ukeys.device
    if use_cache:
        # The directory holds only keys whose leaf existed after the last
        # insert, so a hit needs no allocation and is reached by
        # construction; its cached value is current because every other
        # writer of leaves touches other keys or clears the directory.
        rows = torch.arange(U, dtype=torch.int32, device=dev)
        j = _dir_lookup(dir_keys, ukeys)
        js = torch.clamp(j, 0, dir_keys.shape[0] - 1)
        hit = ulive & (j >= 0)
        hit_nodes = torch.where(hit, dir_nodes[js], 0)
        hit_vals = dir_vals[js]
        hit_aux = torch.where(hit, dir_aux[js], -1)

        miss = ulive & ~hit
        miss_ranks, m_total = compaction.exclusive_ranks(miss)
        m_over = m_total > miss_cap
        # every unique from the first dropped miss on defers, hits
        # included: the pager needs the key order contiguous
        first_drop = torch.min(torch.where(miss & (miss_ranks >= miss_cap),
                                           rows, U))
        keep = ulive & (rows < first_drop)
        hit = hit & keep
        miss = miss & keep

        mrow = torch.arange(miss_cap, dtype=torch.int32, device=dev)
        (mkeys, mpos), m_count = compaction.compact_multi(
            [ukeys, rows], miss, miss_cap, fill=0)
        mlive = mrow < m_count
        mkeys = torch.where(mlive, mkeys, morton.INVALID_KEY)
        n_nodes, mpaths, mreached, total_new, shallow = _descend_alloc(
            pool.child, pool.n_nodes, mkeys, mlive, cap=cap, depth=depth,
            shallow_level=shallow_level)
        scat = torch.where(mlive, mpos, U)
        # -1 = not reached folds (cur, reached) into one scatter
        cur = compaction.scatter_set_(
            torch.where(hit, hit_nodes, -1), scat,
            torch.where(mreached[-1], mpaths[-1], -1))
        leaf_reached = cur >= 0
        cur = torch.clamp(cur, min=0)
        # hits read their old value from the directory; only the misses
        # touch the pool's values
        old = compaction.scatter_set_(
            torch.where(hit, hit_vals, packing.EMPTY_VALUE), scat,
            pool.value[torch.clamp(mpaths[-1], 0, cap - 1)])
        # deferred rows must not blend in this pass
        ulive = keep
        dir_hits = hit.sum(dtype=torch.int32)
    else:
        n_nodes, paths, reached, total_new, shallow = _descend_alloc(
            pool.child, pool.n_nodes, ukeys, ulive, cap=cap, depth=depth,
            shallow_level=shallow_level)
        cur = paths[-1]
        leaf_reached = reached[-1]
        old = pool.value[cur]
        hit_aux = torch.full((U,), -1, dtype=torch.int32, device=dev)
        dir_hits = torch.full((), -1, dtype=torch.int32, device=dev)

    # leaf blend (uniques are already deduplicated)
    leaf_ok = ulive & leaf_reached
    blended = packing.blend_mean(old, mean_rgb)
    compaction.scatter_set_(pool.value, torch.where(leaf_ok, cur, cap),
                            blended)

    if emit_mips:
        no_cell = mips.total_cells(depth)
        mip_idx_parts = [torch.where(
            leaf_ok, mips.flat_index(ukeys, depth, depth), no_cell)]
        mip_val_parts = [blended]

    # first-ever-written leaves: the renderer's registry appends these
    is_new_leaf = leaf_ok & (old == packing.EMPTY_VALUE)
    new_leaf_keys, nl_count = compaction.compact(ukeys, is_new_leaf, U,
                                                 fill=-1)
    new_leaf_nodes, _ = compaction.compact(cur, is_new_leaf, U, fill=0)

    # bottom-up mipmap over the unique parents, deepest first so that the
    # shallower means see refreshed children. Each level works on the U
    # rows masked to the first row of every parent; the reference compacts
    # those rows where 8^level < U, a static-shape device that changes no
    # result.
    tiles8 = pool.value.view(cap // 8, 8)
    for level in (range(depth - 1, 0, -1) if update_interior else ()):
        prefix = morton.level_prefix(ukeys, depth, level)
        # the level's node has a tile on this row's path iff the path
        # reached level + 1 (known from the allocation, no gather)
        mask = compaction.first_occurrence(prefix, ulive) & reached[level]
        node = torch.where(mask, paths[level - 1], cap)
        tile = torch.where(mask, pool.child[torch.clamp(node, max=cap - 1)],
                           0)
        # tiles are 8-aligned: the 8 children are one row of the tile view
        packed_v = _mipmap_tiles(
            tiles8[torch.clamp(tile >> 3, max=cap // 8 - 1)])
        ok_mip = mask & (tile > 0)
        compaction.scatter_set_(pool.value, torch.where(ok_mip, node, cap),
                                packed_v)
        if emit_mips:
            mip_idx_parts.append(torch.where(
                ok_mip, mips.level_offset(level) + prefix, no_cell))
            mip_val_parts.append(packed_v)

    if emit_mips:
        mip_idx = torch.cat(mip_idx_parts)
        mip_val = torch.cat(mip_val_parts)
    else:
        mip_idx = torch.full((1,), 2**31 - 1, dtype=torch.int32,
                             device=ukeys.device)
        mip_val = torch.zeros((1,), dtype=torch.int32, device=ukeys.device)

    unique_overflow = u_count > U
    last_idx = torch.clamp(u_count, max=U) - 1
    if use_cache:
        # a miss overflow is reported as a unique overflow whose resume
        # cursor is the last kept key (first_drop >= miss_cap >= 1, so the
        # cursor always advances)
        unique_overflow = unique_overflow | m_over
        last_idx = torch.where(m_over, first_drop - 1, last_idx)
    last_idx = torch.clamp(last_idx, 0, U - 1)
    pool_overflowed = pool.overflowed | (n_nodes + 8 > cap)
    stats = InsertStats(
        new_nodes=8 * total_new,
        n_valid=svalid.sum(dtype=torch.int32),
        n_unique=torch.clamp(u_count, max=U),
        overflowed=pool_overflowed | unique_overflow,
        unique_overflow=unique_overflow,
        last_key=ukeys[last_idx.reshape(1)].reshape(()),
        shallow_allocs=shallow,
        dir_hits=dir_hits,
        hit_aux=hit_aux,
        new_leaf_keys=new_leaf_keys,
        new_leaf_nodes=new_leaf_nodes,
        new_leaf_count=torch.clamp(nl_count, max=U),
        touched_leaf_nodes=torch.where(leaf_ok, cur, -1),
        touched_leaf_keys=torch.where(leaf_ok, ukeys, morton.INVALID_KEY),
        touched_leaf_vals=blended,
        sat_transition=(leaf_ok & (packing.alpha_of(old) < 255)
                        & (packing.alpha_of(blended) == 255)),
        mip_idx=mip_idx,
        mip_val=mip_val,
    )
    new_pool = pool._replace(n_nodes=n_nodes, overflowed=pool_overflowed)
    return new_pool, stats


def _mipmap_tiles(kid_val: torch.Tensor) -> torch.Tensor:
    """Parent word of each row of 8 child words i32[T, 8]: mean rgb over
    the occupied children, max alpha (averageChildren, svo.cu:417-439).
    The sums are integers below 2^24, exact in float32 in any order."""
    r, g, b, a = packing.unpack_rgba8(kid_val)
    occ = (a > packing.OCCUPIED_ALPHA).to(torch.float32)
    safe = torch.clamp(occ.sum(dim=1), min=1.0)

    def mean(c):
        return ((c.to(torch.float32) * occ).sum(dim=1) / safe).to(torch.int32)

    return packing.pack_rgba8(mean(r), mean(g), mean(b), a.amax(dim=1))


def tile_topology(pool: SVONodePool, *, depth: int):
    """Per-tile (parent node, level, Morton key) from the child pointers
    alone: parent[t] is the node whose child pointer is tile t (one inverse
    scatter), then levels and keys spread root-down in depth-1 gather
    rounds, level(t) = level(parent's tile) + 1 and key(t) = key(parent's
    tile) << 3 | (parent & 7). Tile 0 is the root tile (level-1 nodes, key
    prefix 0); unallocated tiles keep level 0.
    Returns (parent i32[cap/8], level i32[cap/8], key i32[cap/8])."""
    cap = pool.capacity
    nt = cap // 8
    dev = pool.child.device
    idx = torch.where(pool.child > 0, pool.child >> 3, nt)
    parent = torch.full((nt,), -1, dtype=torch.int32, device=dev)
    compaction.scatter_set_(parent, idx,
                            torch.arange(cap, dtype=torch.int32, device=dev))
    level = torch.zeros((nt,), dtype=torch.int32, device=dev)
    level[0] = 1
    key = torch.zeros((nt,), dtype=torch.int32, device=dev)
    pt = torch.clamp(parent, 0, cap - 1) >> 3
    for _ in range(depth - 1):
        pl = level[pt]
        grow = (level == 0) & (parent >= 0) & (pl > 0)
        level = torch.where(grow, pl + 1, level)
        key = torch.where(grow, (key[pt] << 3) | (parent & 7), key)
    return parent, level, key


def refresh_interior(pool: SVONodePool, *, depth: int) -> SVONodePool:
    """Recompute every interior node value bottom-up from the current
    leaves, in place: per level one row reduce over the tile-major view of
    the values and one scatter to the parents of that level's tiles. The
    one-shot companion of insert(update_interior=False), bit-identical to
    the eager mipmap."""
    cap = pool.capacity
    parent, level, _ = tile_topology(pool, depth=depth)
    for lvl in range(depth, 1, -1):
        packed = _mipmap_tiles(pool.value.view(cap // 8, 8))
        sel = (level == lvl) & (parent >= 0)
        compaction.scatter_set_(pool.value, torch.where(sel, parent, cap),
                                packed)
    return pool


def insert_exact(pool: SVONodePool, keys: torch.Tensor, values: torch.Tensor,
                 *, depth: int, unique_cap: int = 1 << 16,
                 min_key: torch.Tensor | None = None,
                 shallow_level: int = 6, overwrite: bool = True):
    """Bulk value-exact leaf write, the restore half of host tiering: each
    unique leaf key gets its packed word verbatim (pushToGPU's
    re-serialisation, octree.cpp:41-79), missing tiles are allocated as in
    `insert`, interior values are left for `refresh_interior` or the stale
    flags.

    keys i32[N] leaf Morton keys at `depth` (< 0 or INVALID_KEY = skip);
    values i32[N] packed words. A stable sort makes duplicate keys take
    the value sorted first. More than `unique_cap` distinct keys page like
    `insert`: re-run with min_key = stats.last_key until
    stats.unique_overflow clears. overwrite=False writes only leaves still
    at the fresh-node word, so a restore never clobbers a leaf observed
    again while its region was spilled.
    Returns (pool, stats); pool.child / pool.value are updated in place."""
    cap = pool.capacity
    U = unique_cap
    dev = pool.child.device
    keys = keys.to(torch.int32)
    values = values.to(torch.int32)
    key_valid = (keys >= 0) & (keys != morton.INVALID_KEY)
    if min_key is not None:
        key_valid = key_valid & (keys > min_key)
    k = torch.where(key_valid, keys, morton.INVALID_KEY)
    skeys, order = torch.sort(k, stable=True)
    svals = values[order]
    svalid = skeys != morton.INVALID_KEY
    first = compaction.first_occurrence(skeys, svalid)
    (ukeys, uvals), _ = compaction.compact_multi([skeys, svals], first, U)
    u_count = first.sum(dtype=torch.int32)
    rows = torch.arange(U, device=dev)
    ukeys = torch.where(rows < u_count, ukeys, morton.INVALID_KEY)
    ulive = (rows < u_count) & (ukeys != morton.INVALID_KEY)

    n_nodes, paths, reached, n_new, shallow = _descend_alloc(
        pool.child, pool.n_nodes, ukeys, ulive, cap=cap, depth=depth,
        shallow_level=shallow_level)
    cur = paths[-1]
    leaf_ok = ulive & reached[-1]
    old = pool.value[cur]
    is_new_leaf = leaf_ok & (old == packing.EMPTY_VALUE)
    write_ok = leaf_ok if overwrite else is_new_leaf
    compaction.scatter_set_(pool.value, torch.where(write_ok, cur, cap),
                            uvals)
    final_vals = torch.where(write_ok, uvals, old)
    new_leaf_keys, nl_count = compaction.compact(ukeys, is_new_leaf, U,
                                                 fill=-1)
    new_leaf_nodes, _ = compaction.compact(cur, is_new_leaf, U, fill=0)

    unique_overflow = u_count > U
    pool_overflowed = pool.overflowed | (n_nodes + 8 > cap)
    last_idx = torch.clamp(torch.clamp(u_count, max=U) - 1, 0, U - 1)
    stats = InsertStats(
        new_nodes=8 * n_new,
        n_valid=key_valid.sum(dtype=torch.int32),
        n_unique=torch.clamp(u_count, max=U),
        overflowed=pool_overflowed | unique_overflow,
        unique_overflow=unique_overflow,
        last_key=ukeys[last_idx.reshape(1)].reshape(()),
        shallow_allocs=shallow,
        # constants of the bulk write: no directory, no gate transitions
        # (pool rebuilds rebuild the mask from the registry), no mirror pairs
        dir_hits=torch.full((), -1, dtype=torch.int32, device=dev),
        hit_aux=torch.full((U,), -1, dtype=torch.int32, device=dev),
        new_leaf_keys=new_leaf_keys,
        new_leaf_nodes=new_leaf_nodes,
        new_leaf_count=nl_count,
        touched_leaf_nodes=torch.where(leaf_ok, cur, -1),
        touched_leaf_keys=torch.where(leaf_ok, ukeys, morton.INVALID_KEY),
        touched_leaf_vals=final_vals,
        sat_transition=torch.zeros((U,), dtype=torch.bool, device=dev),
        mip_idx=torch.full((1,), 2**31 - 1, dtype=torch.int32, device=dev),
        mip_val=torch.zeros((1,), dtype=torch.int32, device=dev),
    )
    return pool._replace(n_nodes=n_nodes, overflowed=pool_overflowed), stats


def _reroot_dense_map(pre: int):
    """Host index maps of one volume doubling: Octree::expand wraps child i
    in a new parent at ~i (octree.cpp:184-206), so an old cell [i, rest]
    at level l becomes [i, ~i, rest] at level l+1. Returns (src i64[dense],
    valid bool[dense]): new dense node d takes old dense node src[d]'s
    value where valid; level 1 is invalid (re-mipmapped afterwards)."""
    dense = _LEVEL_BASE[pre + 1]
    src = np.zeros((dense,), np.int64)
    valid = np.zeros((dense,), bool)
    for l in range(2, pre + 1):
        base = _LEVEL_BASE[l]
        m = np.arange(_LEVEL_BASE[l + 1] - base, dtype=np.int64)
        s = 3 * (l - 2)
        i1 = m >> (s + 3)
        ok = ((m >> s) & 7) == (i1 ^ 7)
        m_old = (i1 << s) | (m & ((1 << s) - 1))
        src[base + m] = np.where(ok, _LEVEL_BASE[l - 1] + m_old, 0)
        valid[base + m] = ok
    return src, valid


def reroot_double(pool: SVONodePool) -> SVONodePool:
    """Double the volume (half_size x2, one level deeper) keeping every
    node value and child pointer, in place (Octree::expand,
    octree.cpp:184-206): the dense shallow values are permuted ([i] ->
    [i, ~i]), the old dense level-`pre` nodes move verbatim into one bridge
    block of 8^pre slots at the allocation cursor (their child pointers
    still address the same unmoved tiles), and level 1 is re-mipmapped.
    No node outside the dense region moves.

    Needs 8^pre free slots: when they do not fit (one host read) the pool
    only gets its `overflowed` flag, as the reference package's result."""
    cap = pool.capacity
    pre = prealloc_levels(cap)
    if pre < 2:
        raise ValueError(f"reroot_double needs >= 2 dense levels, capacity "
                         f"{cap} has {pre}")
    dense = _LEVEL_BASE[pre + 1]
    lo_pre = _LEVEL_BASE[pre]
    n_bridge = dense - lo_pre     # 8^pre nodes
    base = int(pool.n_nodes)
    if base + n_bridge > cap:
        return pool._replace(overflowed=torch.ones_like(pool.overflowed))
    dev = pool.value.device
    src_np, valid_np = _reroot_dense_map(pre)
    new_dense = torch.where(torch.from_numpy(valid_np).to(dev),
                            pool.value[torch.from_numpy(src_np).to(dev)],
                            packing.EMPTY_VALUE)
    new_dense[:8] = _mipmap_tiles(
        new_dense[_LEVEL_BASE[2]:_LEVEL_BASE[3]].view(8, 8))

    # the bridge block: the old dense level-`pre` rows, verbatim
    pool.value[base:base + n_bridge] = pool.value[lo_pre:dense]
    pool.child[base:base + n_bridge] = pool.child[lo_pre:dense]
    # dense level-`pre` cell m = [i1, ~i1, p_rest] covers old level-(pre-1)
    # cell p = [i1, p_rest], whose children are bridge tile base + 8p
    m = torch.arange(n_bridge, dtype=torch.int32, device=dev)
    s = 3 * (pre - 2)
    i1 = m >> (s + 3)
    covered = ((m >> s) & 7) == (i1 ^ 7)
    p = (i1 << s) | (m & ((1 << s) - 1))
    pool.value[:dense] = new_dense
    pool.child[lo_pre:dense] = torch.where(covered, base + 8 * p, 0)
    return pool._replace(n_nodes=pool.n_nodes + n_bridge,
                         half_size=pool.half_size * 2.0)


def grow_capacity(pool: SVONodePool, new_capacity: int) -> SVONodePool:
    """The pool at a larger capacity (the reference's per-insert realloc,
    svo.cu:609-614, once per doubling). Child pointers are absolute and the
    dense layout depends only on prealloc_levels(capacity), so within one
    prealloc schedule a pad keeps the whole structure; across a boundary
    the callers rebuild through insert_exact."""
    cap = pool.capacity
    assert new_capacity >= cap and new_capacity % 8 == 0
    assert prealloc_levels(new_capacity) == prealloc_levels(cap), \
        "growth across a prealloc-level boundary needs a rebuild " \
        "(pipeline.grow_state and Octree.grow_capacity rebuild through " \
        "insert_exact)"
    pad = new_capacity - cap
    if pad == 0:
        return pool
    return pool._replace(
        child=torch.cat([pool.child, pool.child.new_zeros((pad,))]),
        value=torch.cat([pool.value,
                         pool.value.new_full((pad,), packing.EMPTY_VALUE)]),
        overflowed=torch.zeros_like(pool.overflowed))


class ExtractedVoxels(NamedTuple):
    keys: torch.Tensor     # i32[cap] leaf Morton keys, -1 past count
    nodes: torch.Tensor    # i32[cap] node-pool indices, -1 past count
    centers: torch.Tensor  # f32[cap, 3] world-space cell centres
    colors: torch.Tensor   # f32[cap, 4] rgba in [0, 1]
    count: torch.Tensor    # i32[] live entries


def extract_voxels(pool: SVONodePool, *, depth: int,
                   capacity: int) -> ExtractedVoxels:
    """The occupied (alpha > 127) cells at `depth` by a frontier BFS:
    extractVoxelGridFromSVO's per-level getOccupiedChildren +
    thrust::remove_if (svo.cu:699-745) as masked expansion and prefix-sum
    compaction into a `capacity`-row buffer (>= 8). No host read."""
    cap = pool.capacity
    dev = pool.child.device
    eight = torch.arange(8, dtype=torch.int32, device=dev)
    node = torch.full((capacity,), cap, dtype=torch.int32, device=dev)
    key = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    node[:8] = eight
    key[:8] = eight
    live = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    live[:8] = packing.is_occupied(pool.value[:8])
    rows = torch.arange(capacity, device=dev)
    for _ in range(depth - 1):
        tile = torch.where(live, pool.child[torch.clamp(node, max=cap - 1)],
                           0)
        has_kids = live & (tile > 0)
        kid_nodes = (tile[:, None] + eight).reshape(-1)
        kid_keys = ((key[:, None] << 3) | eight).reshape(-1)
        kid_occ = packing.is_occupied(
            pool.value[torch.clamp(kid_nodes, max=cap - 1)])
        mask = has_kids.repeat_interleave(8) & kid_occ
        (node, key), count = compaction.compact_multi(
            [kid_nodes, kid_keys], mask, capacity)
        live = rows < count

    centers = morton.decode_centers(key, pool.center, pool.half_size, depth)
    colors = packing.unpack_rgba_unit(pool.value[torch.where(live, node, 0)])
    return ExtractedVoxels(
        keys=torch.where(live, key, -1),
        nodes=torch.where(live, node, -1),
        centers=torch.where(live[:, None], centers, 0.0),
        colors=torch.where(live[:, None], colors, 0.0),
        count=live.sum(dtype=torch.int32))


def extract_all_leaves(pool: SVONodePool, *, depth: int,
                       start_capacity: int):
    """extract_voxels at a capacity doubled until every occupied leaf fits,
    one host read of the count per try. Returns (extraction, capacity)."""
    cap = max(start_capacity, 8)
    while True:
        ex = extract_voxels(pool, depth=depth, capacity=cap)
        if int(ex.count) < cap:
            return ex, cap
        cap *= 2


def query_points(pool: SVONodePool, points: torch.Tensor, *, depth: int):
    """The deepest existing node containing each point (fillNodes' walk,
    svo.cu:352-364, without mutation). Returns (value i32[N], reached
    depth i32[N])."""
    keys, valid = morton.encode(points, pool.center, pool.half_size, depth)
    cur = torch.where(valid, morton.octant_at(keys, depth, 1), 0)
    reached = valid.to(torch.int32)
    for level in range(1, depth):
        tile = pool.child[cur]
        go = valid & (tile > 0)
        cur = torch.where(go, tile + morton.octant_at(keys, depth, level + 1),
                          cur)
        reached = torch.where(go, level + 1, reached)
    return pool.value[cur], reached
