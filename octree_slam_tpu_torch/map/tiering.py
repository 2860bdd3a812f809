"""Host-RAM tiering of cold map regions (counterpart:
octree_slam_tpu/map/tiering.py).

The reference keeps only the active subtree on the device and moves the
rest with pushToGPU / pullToCPU (octree.cpp:41-111). Here the pool is one
static-capacity device array, so tiering works on regions:

  * the volume is cut into level-`tier_level` Morton cells; a cell is cold
    when every leaf in it is farther than `spill_keep_radius` from the
    camera;
  * `spill_cold` extracts every leaf with its exact packed word, keeps the
    cold cells' (key, word) arrays in host RAM and rebuilds the pool from
    the kept leaves with svo.insert_exact, so the freed slots become
    insert headroom;
  * `restore_due` re-inserts the archived cells whose centre comes within
    `restore_radius`, with overwrite=False: a leaf the camera observed
    again while its region was spilled keeps its newer word, and a restore
    that outgrows the pool grows it and writes the same keys again, so it
    never loses a leaf.

The archive keeps numpy words with the bits of the reference package's u32
arrays (uint32); the device side holds them as int32 views. Both operations
run between frames and leave the state whole: registry rebuilt or
appended, interiors refreshed or flagged stale, the render cache rebuilt
or flagged. A spill -> restore round trip is bit-exact for every leaf word.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from octree_slam_tpu_torch import pipeline
from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.map import mips, morton, svo
from octree_slam_tpu_torch.render import raycast
from octree_slam_tpu_torch.render.splat import (append_new_leaves,
                                                leaf_list_from_extraction)


def _decode_center_host(prefix: int, center: np.ndarray, half: float,
                        level: int) -> np.ndarray:
    """Cell centre of a level-`level` Morton prefix on the host (the numpy
    twin of morton.decode_centers: the restore check runs every frame and
    must not touch the device)."""
    c = np.array(center, np.float32).copy()
    e = float(half)
    for lv in range(level):
        octant = (prefix >> (3 * (level - 1 - lv))) & 7
        e *= 0.5
        c += np.float32(e) * np.array(
            [1.0 if octant & 1 else -1.0,
             1.0 if octant & 2 else -1.0,
             1.0 if octant & 4 else -1.0], np.float32)
    return c


class HostArchive:
    """Host-RAM store of spilled cells: level-`level` Morton prefix ->
    (leaf keys i32[n], packed words u32[n])."""

    def __init__(self, level: int):
        self.level = level
        self.cells: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._centers: Dict[int, np.ndarray] = {}
        self._frame = None  # (centre f32[3], half size), read once a run

    @property
    def n_leaves(self) -> int:
        return sum(k.size for k, _ in self.cells.values())

    def __len__(self) -> int:
        return len(self.cells)

    def add(self, prefix: int, keys: np.ndarray, vals: np.ndarray) -> None:
        if prefix in self.cells:
            # merge; the new spill wins on a duplicate key (it is newer)
            ok, ov = self.cells[prefix]
            stale = ~np.isin(ok, keys)
            keys = np.concatenate([keys, ok[stale]])
            vals = np.concatenate([vals, ov[stale]])
        self.cells[prefix] = (keys, vals)

    def take(self, prefixes) -> Tuple[np.ndarray, np.ndarray]:
        ks, vs = [], []
        for p in prefixes:
            k, v = self.cells.pop(p)
            ks.append(k)
            vs.append(v)
        if not ks:
            return np.zeros((0,), np.int32), np.zeros((0,), np.uint32)
        return np.concatenate(ks), np.concatenate(vs)

    def cell_centers(self, center, half_size) -> Tuple[np.ndarray, np.ndarray]:
        """(prefixes i32[m], centres f32[m, 3]) of every archived cell. The
        map frame (center, half_size) is read from the device once, on the
        first call; after that this is host arithmetic."""
        if self._frame is None:
            self._frame = (_host(center).astype(np.float32),
                           float(_host(half_size)))
        c0, h0 = self._frame
        pfx = np.fromiter(self.cells.keys(), np.int32, count=len(self.cells))
        if pfx.size == 0:
            return pfx, np.zeros((0, 3), np.float32)
        out = np.empty((pfx.size, 3), np.float32)
        for i, p in enumerate(pfx.tolist()):
            c = self._centers.get(p)
            if c is None:
                c = _decode_center_host(p, c0, h0, self.level)
                self._centers[p] = c
            out[i] = c
        return pfx, out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaf_snapshot(state, cfg: SLAMConfig):
    """(pool, keys i32[n], exact words u32[n]) of every occupied leaf, on
    the host. Interiors are refreshed first when stale (the extraction's
    BFS reads occupancy); the refresh writes the pool's values in place,
    which changes no leaf and leaves the stale flags to the caller."""
    pool = state.pool
    if bool(state.interior_stale):
        pool = svo.refresh_interior(pool, depth=cfg.max_depth)
    ex, _ = svo.extract_all_leaves(
        pool, depth=cfg.max_depth,
        start_capacity=max(cfg.extract_capacity, cfg.leaf_capacity))
    n = int(ex.count)
    nodes = ex.nodes[:n]
    live = nodes >= 0
    keys = ex.keys[:n][live]
    vals = pool.value[nodes[live]]
    return pool, _host(keys), _host(vals).view(np.uint32)


def bulk_insert_exact(pool, keys: np.ndarray, vals: np.ndarray, *,
                      depth: int, unique_cap: int, shallow_level: int = 6,
                      overwrite: bool):
    """Value-verbatim bulk write in chunks of `unique_cap` keys: the keys are
    sorted once here, so no two chunks share a key. vals are u32 words.
    Returns (pool, per-chunk stats list)."""
    order = np.argsort(keys, kind="stable")
    keys = np.ascontiguousarray(keys[order], np.int32)
    vals = np.ascontiguousarray(vals[order]).view(np.int32)
    dev = pool.child.device
    U = unique_cap
    n = keys.size
    pad = (-n) % U if n else U
    # one upload of the whole set, padded to whole chunks
    kt = torch.from_numpy(np.concatenate(
        [keys, np.full((pad,), morton.INVALID_KEY, np.int32)])).to(dev)
    vt = torch.from_numpy(np.concatenate(
        [vals, np.zeros((pad,), np.int32)])).to(dev)
    stats_list = []
    for i in range(0, kt.shape[0], U):
        pool, st = svo.insert_exact(pool, kt[i:i + U], vt[i:i + U],
                                    depth=depth, unique_cap=U,
                                    shallow_level=shallow_level,
                                    overwrite=overwrite)
        stats_list.append(st)
    return pool, stats_list


def _insert_all_exact(pool, keys: np.ndarray, vals: np.ndarray,
                      cfg: SLAMConfig, *, overwrite: bool):
    return bulk_insert_exact(
        pool, keys, vals, depth=cfg.max_depth,
        unique_cap=cfg.insert_unique_cap,
        shallow_level=pipeline._accel_level(cfg),
        overwrite=overwrite)


def _rebuild_derived(state, cfg: SLAMConfig, pool):
    """Everything derived from a rebuilt pool (node indices changed):
    interiors, the leaf registry, the render cache (stamped when the
    hybrid's fused band march reads stamps), the directory cache and the
    saturation mask. Clears all three stale flags. Returns (state, cfg)
    with the registry capacity the extraction needed."""
    pool = svo.refresh_interior(pool, depth=cfg.max_depth)
    lvl = pipeline._accel_level(cfg)
    ex, cap = svo.extract_all_leaves(pool, depth=cfg.max_depth,
                                     start_capacity=cfg.leaf_capacity)
    leaves = leaf_list_from_extraction(ex, pool.value,
                                       node_capacity=cfg.node_capacity)
    if cfg.use_dense_mips:
        accel = mips.rebuild_from_pool(pool, max_depth=cfg.max_depth,
                                       dist_level=lvl,
                                       max_skip=cfg.dist_max_skip)
        if cfg.cone_band_fused_dist:
            # this rebuild clears mirror_stale, so no in-step trigger would
            # stamp a quiet next frame: stamp here
            accel = mips.encode_free_dist(accel, max_depth=cfg.max_depth,
                                          dist_level=lvl)
    else:
        accel = raycast.build_accel(pool, level=lvl)
    new_cfg = cfg if cap == cfg.leaf_capacity else dataclasses.replace(
        cfg, leaf_capacity=cap)
    false = torch.zeros((), dtype=torch.bool, device=pool.child.device)
    state = state._replace(pool=pool, leaves=leaves, accel=accel,
                           interior_stale=false, mirror_stale=false,
                           stamps_stale=false)
    # node indices changed under the directory; the gate's mask is rebuilt
    # from the live registry, so spilled leaves stop gating until restored
    state = pipeline.reset_dircache(state)
    state = pipeline.rebuild_sat_mask(state, new_cfg)
    return state, new_cfg


def spill_cold(state, cfg: SLAMConfig, archive: HostArchive, *,
               camera_pos) -> Tuple[object, SLAMConfig, int]:
    """Archive every cold tier cell in host RAM and rebuild the pool from
    the kept leaves. Returns (state, cfg, leaves spilled); spills nothing
    when every cell has a leaf within spill_keep_radius."""
    assert archive.level == cfg.tier_level
    pool, keys, vals = _leaf_snapshot(state, cfg)
    # the no-op paths keep the stale flags: only the pool's interiors were
    # refreshed, the dense mirror still misses the lazy frames' updates
    state = state._replace(pool=pool)
    if keys.size == 0:
        return state, cfg, 0

    centers = _host(morton.decode_centers(
        torch.from_numpy(keys).to(pool.child.device), pool.center,
        pool.half_size, cfg.max_depth))
    d = np.linalg.norm(centers - np.asarray(_host(camera_pos), np.float32),
                       axis=1)
    pfx = keys >> (3 * (cfg.max_depth - cfg.tier_level))
    # each cell's nearest leaf by one sorted segment reduction
    order = np.argsort(pfx, kind="stable")
    spfx, sd = pfx[order], d[order]
    starts = np.flatnonzero(np.concatenate([[True], spfx[1:] != spfx[:-1]]))
    seg_cold = np.minimum.reduceat(sd, starts) > cfg.spill_keep_radius
    if not seg_cold.any():
        return state, cfg, 0

    skeys, svals = keys[order], vals[order]
    ends = np.append(starts[1:], spfx.size)
    for s, e, is_cold in zip(starts, ends, seg_cold):
        if is_cold:
            archive.add(int(spfx[s]), skeys[s:e].copy(), svals[s:e].copy())
    cold = np.empty(pfx.size, bool)
    cold[order] = np.repeat(seg_cold, np.diff(np.append(starts, spfx.size)))

    fresh = svo.create(cfg.node_capacity, pool.center, pool.half_size,
                       device=pool.child.device)
    fresh, _ = _insert_all_exact(fresh, keys[~cold], vals[~cold], cfg,
                                 overwrite=True)
    state, cfg = _rebuild_derived(state, cfg, fresh)
    return state, cfg, int(np.sum(cold))


def restore_due(state, cfg: SLAMConfig, archive: HostArchive, *,
                camera_pos) -> Tuple[object, SLAMConfig, int]:
    """Re-insert the archived cells whose centre is within restore_radius.
    Returns (state, cfg, leaves restored)."""
    assert archive.level == cfg.tier_level
    pfx, centers = archive.cell_centers(state.pool.center,
                                        state.pool.half_size)
    if pfx.size == 0:
        return state, cfg, 0
    d = np.linalg.norm(centers - np.asarray(_host(camera_pos), np.float32),
                       axis=1)
    due = pfx[d <= cfg.restore_radius]
    if due.size == 0:
        return state, cfg, 0
    keys, vals = archive.take(int(p) for p in due)

    # Insert with retry: insert_exact drops allocations that do not fit and
    # the archive entries are already taken, so an overflow grows the pool
    # or the registry and writes the same keys again; overwrite=False makes
    # that idempotent (leaves written in an earlier round are not EMPTY any
    # more). Registry appends an overflowed round dropped come back with
    # grow_state's rebuild.
    dev = state.pool.child.device

    def flag(v):
        return torch.full((), bool(v), dtype=torch.bool, device=dev)

    state = state._replace(
        interior_stale=flag(True), mirror_stale=flag(cfg.use_dense_mips),
        stamps_stale=flag(cfg.use_dense_mips and cfg.cone_band_fused_dist))
    while True:
        pool, stats_list = _insert_all_exact(state.pool, keys, vals, cfg,
                                             overwrite=False)
        leaves = state.leaves
        for st in stats_list:
            leaves = append_new_leaves(leaves, st)
        state = state._replace(pool=pool, leaves=leaves)
        pool_of, leaf_of = torch.stack(
            [pool.overflowed, leaves.overflowed]).tolist()
        if not pool_of and not leaf_of:
            break
        state = state._replace(pool=pool._replace(overflowed=flag(False)))
        state, cfg = pipeline.grow_state(state, cfg, grow_nodes=pool_of,
                                         grow_leaves=leaf_of)
    # A restore only adds tiles, so node indices stay valid, but the entry
    # grid or the dense mirror is stale: lazy dense configs heal in the
    # step off the flags, everything else refreshes here.
    lvl = pipeline._accel_level(cfg)
    if not cfg.use_dense_mips:
        state = state._replace(accel=raycast.build_accel(state.pool,
                                                         level=lvl))
    if not cfg.lazy_interior:
        pool = svo.refresh_interior(state.pool, depth=cfg.max_depth)
        state = state._replace(pool=pool, interior_stale=flag(False))
        if cfg.use_dense_mips:
            # a rebuilt mirror has no stamps: stamps_stale (set above)
            # stays, so the next hybrid frame stamps it
            state = state._replace(
                accel=mips.rebuild_from_pool(
                    pool, max_depth=cfg.max_depth, dist_level=lvl,
                    max_skip=cfg.dist_max_skip),
                mirror_stale=flag(False))
    return state, cfg, int(keys.size)
