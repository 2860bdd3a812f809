"""Host-RAM tiering of the Morton-range-sharded map (counterpart:
octree_slam_tpu/parallel/tiering2d.py).

map/tiering.py's protocol for distributed.ShardedMap:

  * `spill_cold_sharded`: the complete union leaf snapshot on the host,
    every cold tier cell (no leaf within spill_keep_radius of the camera)
    archived in the same HostArchive, and every shard rebuilt from the kept
    rows of its own Morton range (distributed.rebuild_from_union: the
    value-verbatim insert, shard-local);
  * `restore_due_sharded`: archived cells whose centre comes within
    restore_radius go back through a shard-routed value-verbatim insert
    (insert_exact_sharded, overwrite=False: a leaf observed again while its
    cell was spilled keeps its newer word), with the single-device
    insert-with-retry guarantee: an overflow grows the sharded map
    (grow_sharded) and writes the same keys again, which is idempotent.

A spill -> restore round trip is bit-exact for every leaf word. The 2-D
step carries no saturation mask and no insert directory, so
tiering._rebuild_derived's resets of those have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from octree_slam_tpu_torch import pipeline
from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.map import morton, svo
from octree_slam_tpu_torch.map.tiering import HostArchive, bulk_insert_exact
from octree_slam_tpu_torch.parallel import distributed
from octree_slam_tpu_torch.parallel.distributed import Mesh, ShardedMap
from octree_slam_tpu_torch.render.splat import append_new_leaves


def spill_cold_sharded(smap: ShardedMap, cfg: SLAMConfig, mesh: Mesh,
                       archive: HostArchive, *, camera_pos,
                       axis_name: str = "map") -> Tuple[ShardedMap, int]:
    """Archive every cold tier cell in host RAM and rebuild each shard from
    its kept leaves (bounds unchanged). Returns (map, leaves spilled); 0
    when every cell is warm. Host-level, at growth cadence."""
    assert archive.level == cfg.tier_level
    # the complete snapshot: a registry union would miss the leaves of an
    # overflowed registry and lose them for good
    keys, vals = distributed.union_leaf_snapshot(smap, cfg)
    if keys.size == 0:
        return smap, 0
    p0 = smap.pools[0]
    centers = morton.decode_centers(
        torch.from_numpy(keys).to(p0.child.device), p0.center,
        p0.half_size, cfg.max_depth).cpu().numpy()
    d = np.linalg.norm(centers - np.asarray(camera_pos, np.float32), axis=1)
    pfx = keys >> (3 * (cfg.max_depth - cfg.tier_level))
    # each cell's nearest leaf by one sorted segment reduction
    order = np.argsort(pfx, kind="stable")
    spfx, sd = pfx[order], d[order]
    starts = np.flatnonzero(np.concatenate([[True], spfx[1:] != spfx[:-1]]))
    seg_cold = np.minimum.reduceat(sd, starts) > cfg.spill_keep_radius
    if not seg_cold.any():
        return smap, 0

    skeys, svals = keys[order], vals[order]
    ends = np.append(starts[1:], spfx.size)
    for s, e, is_cold in zip(starts, ends, seg_cold):
        if is_cold:
            archive.add(int(spfx[s]), skeys[s:e].copy(), svals[s:e].copy())
    cold = np.empty(pfx.size, bool)
    cold[order] = np.repeat(seg_cold, np.diff(np.append(starts, spfx.size)))
    smap = distributed.rebuild_from_union(
        smap, cfg, mesh, keys[~cold], vals[~cold], smap.bounds,
        axis_name=axis_name)
    return smap, int(np.sum(cold))


def insert_exact_sharded(smap: ShardedMap, keys: np.ndarray,
                         vals: np.ndarray, cfg: SLAMConfig, mesh: Mesh,
                         axis_name: str = "map") -> ShardedMap:
    """Value-verbatim insert of (keys, u32 words) into the sharded map,
    routed by Morton range as insert_sharded routes points, in sorted key
    chunks of insert_unique_cap, overwrite=False (an existing leaf keeps
    its word: restores never clobber, and retries are idempotent). The
    registry takes every chunk's first-seen leaves, and the interiors are
    refreshed: the sharded pools keep them current (insert_sharded's eager
    mipmap), and a later extraction's BFS would skip a stale subtree."""
    prefix = keys >> (3 * (cfg.max_depth - cfg.map_split_level))
    pools, leaves = list(smap.pools), list(smap.leaves)
    for d, pool in enumerate(pools):
        mine = (keys != morton.INVALID_KEY) & (keys >= 0) \
            & (prefix >= smap.bounds[d]) & (prefix < smap.bounds[d + 1])
        pool, stats = bulk_insert_exact(
            pool, keys[mine], vals[mine], depth=cfg.max_depth,
            unique_cap=cfg.insert_unique_cap,
            shallow_level=pipeline._accel_level(cfg), overwrite=False)
        for st in stats:
            leaves[d] = append_new_leaves(leaves[d], st)
        pools[d] = svo.refresh_interior(pool, depth=cfg.max_depth)
    return ShardedMap(pools, leaves, smap.bounds)


def restore_due_sharded(smap: ShardedMap, cfg: SLAMConfig, mesh: Mesh,
                        archive: HostArchive, *, camera_pos,
                        axis_name: str = "map"
                        ) -> Tuple[ShardedMap, SLAMConfig, int]:
    """Re-insert the archived cells whose centre is within restore_radius.
    Returns (map, cfg, leaves restored). A restore that outgrows a pool or
    a registry grows the sharded map and writes the same keys again
    (registrations an overflowed round dropped come back with
    grow_sharded's rebuild)."""
    assert archive.level == cfg.tier_level
    p0 = smap.pools[0]
    pfx, centers = archive.cell_centers(p0.center, p0.half_size)
    if pfx.size == 0:
        return smap, cfg, 0
    d = np.linalg.norm(centers - np.asarray(camera_pos, np.float32), axis=1)
    due = pfx[d <= cfg.restore_radius]
    if due.size == 0:
        return smap, cfg, 0
    keys, vals = archive.take(int(p) for p in due)
    home = mesh.home
    while True:
        smap = insert_exact_sharded(smap, keys, vals, cfg, mesh,
                                    axis_name=axis_name)
        pool_of = distributed.any_flag([p.overflowed for p in smap.pools],
                                       home)
        leaf_of = distributed.any_flag(
            [lv.overflowed for lv in smap.leaves], home)
        if not pool_of and not leaf_of:
            break
        if pool_of:
            smap = smap._replace(pools=[
                p._replace(overflowed=torch.zeros_like(p.overflowed))
                for p in smap.pools])
        smap, cfg = distributed.grow_sharded(
            smap, cfg, mesh, grow_nodes=pool_of, grow_leaves=leaf_of,
            axis_name=axis_name)
    return smap, cfg, int(keys.size)
