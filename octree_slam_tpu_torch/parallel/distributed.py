"""Multi-device execution: the row-sharded tracker and the Morton-range-
sharded map over a device mesh (counterpart:
octree_slam_tpu/parallel/distributed.py).

The reference package is single-controller: one process runs `shard_map`
programs over a `Mesh` of chips. This module is the same design in eager
PyTorch, with no extra processes and no communication library:

  * A `Mesh` is an ndarray of torch devices with axis names. On a host with
    one card every shard sits on cuda:0; with more cards they spread over
    them, cycling to fill the mesh; the CPU tests put every shard on "cpu".
    Row slab i of the "px" axis lives on devices[i, 0], map shard j of the
    "map" axis on devices[0, j], and everything the reference replicates
    (pose, pyramids, flags, the composited images) on devices[0, 0], the
    mesh's `home`.
  * Each collective the reference uses is one small function here: `psum`
    and `pmin` over a list of per-shard tensors, and `all_gather`. Each
    reduces on the first shard's device in shard order and hands the result
    back to every shard's device (a no-op copy on one card).
  * The row-sharded front end (`row_sharded_sensor`). The reference leaves
    the halo exchange of its window stencils to XLA; here each "px" slab
    builds its pyramid on its device from the slab plus `pyramid_halo`
    rows on each side (real rows of the frame, clipped only at the image's
    own borders, the rule of pallas_ops._run_stencil), through the two
    CUDA kernels, and is then cropped to its rows. Slab boundaries and the
    halo are multiples of 2^(pyramid_depth-1), so every level keeps the
    whole image's (2y, 2x) samples, and the vertex map takes each slab's
    rows at their place in the level: the slab pyramids are the whole
    frame's, bit for bit. Tracking pairs each slab with the same rows of
    the last frame (projective association is by pixel index), adds the
    slabs' normal-equation sums with one psum per Gauss-Newton iteration
    and solves once (tracking.track_slabs, the contract of `icp_psum`). The
    whole pyramid, gathered, is carried to the next frame replicated, as
    the reference pins it: the photometric term projects into the whole
    last image.
  * `ShardedMap` keeps one node pool and one leaf registry per map shard,
    each on its own device (the reference stacks them [M, ...]); shard d
    owns the Morton cells [bounds[d], bounds[d+1]) at level
    cfg.map_split_level. The fused points reach every shard in the
    single-device row order, so each shard's insert sees what the
    single-pool insert sees of its range, and the union of the shards is
    the single-pool map bit for bit.

Host reads. insert_sharded reads every shard's unique-cap overflow flag
once per paging round (one read when nothing overflows); growth,
rebalancing and snapshots read what the reference reads on its host.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from octree_slam_tpu_torch import pipeline
from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.core.types import Frame, PyramidLevel
from octree_slam_tpu_torch.map import mips, morton, svo
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.render import conesplat, hybrid
from octree_slam_tpu_torch.render import splat as sp
from octree_slam_tpu_torch.render.splat import (LeafList, append_new_leaves,
                                                create_leaf_list,
                                                leaf_list_from_extraction)
from octree_slam_tpu_torch.sensor import tracking
from octree_slam_tpu_torch.utils import compaction


# ---------------------------------------------------------------- the mesh

class Mesh:
    """An ndarray of torch devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        assert devices.ndim == len(self.axis_names)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """Where replicated state lives: the mesh's first device."""
        return self.devices.flat[0]

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The device of each index along `axis_name`, at index 0 of every
        other axis."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis_name)] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _device_list(n: int, devices) -> List[torch.device]:
    """n devices: `devices` (one device, or a sequence) cycled to fill n;
    by default the visible cards, cuda:0 .. cuda:k-1. Without a card the
    default raises."""
    if devices is None:
        k = torch.cuda.device_count()
        if k == 0:
            raise RuntimeError("no CUDA device is available: pass "
                               "devices='cpu' to build a mesh on the CPU")
        devs = [torch.device("cuda", i) for i in range(k)]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)]
    else:
        devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    return [devs[i % len(devs)] for i in range(n)]


def _mesh(shape: Tuple[int, ...], names, devices) -> Mesh:
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = _device_list(devs.size, devices)
    return Mesh(devs.reshape(shape), names)


def make_mesh(n_devices: int | None = None, axis_name: str = "px",
              devices=None) -> Mesh:
    """1-D mesh of n_devices (default: one per given device, or per card)."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if devices is None else
                     1 if isinstance(devices, (str, torch.device))
                     else len(devices))
    return _mesh((n_devices,), (axis_name,), devices)


def make_mesh2(n_px: int, n_map: int, devices=None) -> Mesh:
    """2-D device mesh ("px", "map"): tracking parallelism on one axis,
    Morton-range map parallelism on the other."""
    return _mesh((n_px, n_map), ("px", "map"), devices)


def axis_name_of(mesh: Mesh, preferred: str = "map") -> str:
    """The map axis name on this mesh ("map" when present, else the sole
    axis: make_mesh(axis_name="map") and make_mesh2 both qualify)."""
    names = list(mesh.shape.keys())
    return preferred if preferred in names else names[-1]


def _to(tree, device):
    """Every tensor of a nested tuple / NamedTuple moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(x, device) for x in tree)
    return tree


def replicated(mesh: Mesh, tree):
    """`tree` placed as replicated state: on the mesh's home device."""
    return _to(tree, mesh.home)


# ---------------------------------------------------------- collectives

def _reduce(xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(out.device))
    return [out.to(x.device) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """lax.psum over per-shard tensors: their sum, added in shard order on
    the first shard's device, on every shard's device."""
    return _reduce(xs, torch.add)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """lax.pmin over per-shard tensors: the elementwise minimum."""
    return _reduce(xs, torch.minimum)


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0
               ) -> List[torch.Tensor]:
    """lax.all_gather(tiled=True): the shards concatenated along `dim` in
    shard order on the first shard's device, on every shard's device."""
    out = torch.cat([x.to(xs[0].device) for x in xs], dim=dim)
    return [out.to(x.device) for x in xs]


# ------------------------------------------------- the row-sharded frame

class RowSlab(NamedTuple):
    """One "px" shard of the frame."""

    rows: Tuple[int, int]     # [y0, y1): the slab's rows of the frame
    padded: Tuple[int, int]   # [p0, p1): with the halo, clipped to the image
    device: torch.device


def pyramid_halo(cfg: SLAMConfig) -> int:
    """Raw rows each slab reads beyond its own on each side. The normals
    of the deepest level D = pyramid_depth - 1 read one row past the
    slab's last, whose pixel is the gated mean centred on the next slab's
    first level-0 row y1; that mean reads level-0 rows up to
    y1 + 2^(D+1) - 2 (each gated level reads 2 rows of the one before, a
    5x5 window at (2y, 2x)), and the bilateral reads
    half = bilateral_kernel_size // 2 raw rows around each filtered one:
    half + 2^(D+1) - 1 rows past the slab's last. Rounded up to a multiple
    of 2^D, so that a padded slab starts on a sample of every level (12
    for the default three levels and 7x7 window)."""
    d = cfg.pyramid_depth - 1
    need = cfg.bilateral_kernel_size // 2 + (1 << (d + 1)) - 1
    unit = 1 << d
    return -(-need // unit) * unit


def frame_sharding(mesh: Mesh, cfg: SLAMConfig,
                   axis_name: str = "px") -> List[RowSlab]:
    """The frame's row slabs, one per `axis_name` index: near-equal row
    counts, every boundary a multiple of 2^(pyramid_depth-1) (the last slab
    takes the rows past the last whole unit)."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    unit = 1 << (cfg.pyramid_depth - 1)
    units = cfg.height // unit
    if units < n:
        raise ValueError(f"{cfg.height} rows cannot be cut into {n} slabs "
                         f"of whole {unit}-row units")
    halo = pyramid_halo(cfg)
    cuts = [round(i * units / n) * unit for i in range(n)] + [cfg.height]
    return [RowSlab(rows=(y0, y1),
                    padded=(max(0, y0 - halo), min(cfg.height, y1 + halo)),
                    device=dev)
            for y0, y1, dev in zip(cuts[:-1], cuts[1:], devs)]


def slab_pyramid(frame: Frame, cfg: SLAMConfig, slab: RowSlab
                 ) -> List[PyramidLevel]:
    """One slab's pyramid on its device: the padded rows through
    tracking.build_pyramid (both kernels), cropped to the slab's rows at
    every level (1x1 placeholder levels stay as they are)."""
    (y0, y1), (p0, p1) = slab.rows, slab.padded
    depth = frame.depth[p0:p1].to(slab.device).contiguous()
    color = frame.color[p0:p1].to(slab.device)
    levels = tracking.build_pyramid(depth, color, cfg, row0=p0,
                                    full_height=cfg.height)
    min_map_level = min(cfg.track_finest_level, cfg.fuse_level)
    out = []
    for lvl, level in enumerate(levels):
        a = (y0 - p0) >> lvl
        b = a + (y1 >> lvl) - (y0 >> lvl)
        if lvl < min_map_level:
            out.append(level._replace(intensity=level.intensity[a:b]))
        else:
            out.append(PyramidLevel(*(x[a:b] for x in level)))
    return out


def gather_pyramid(slab_pyrs: List[List[PyramidLevel]], cfg: SLAMConfig
                   ) -> List[PyramidLevel]:
    """The whole frame's pyramid from its slabs, on the first slab's
    device (placeholder levels are the first slab's)."""
    min_map_level = min(cfg.track_finest_level, cfg.fuse_level)
    out = []
    for lvl in range(cfg.pyramid_depth):
        parts = [p[lvl] for p in slab_pyrs]
        out.append(PyramidLevel(*(
            all_gather([getattr(q, f) for q in parts])[0]
            if f == "intensity" or lvl >= min_map_level
            else getattr(parts[0], f)
            for f in PyramidLevel._fields)))
    return out


def row_sharded_sensor(cfg: SLAMConfig, mesh: Mesh, axis_name: str = "px"):
    """The row-sharded front end of a step: a function frame -> (the whole
    pyramid, a tracker). The tracker has tracking.track's arguments and
    runs tracking.track_slabs over this frame's slab pyramids with psum, so
    pipeline._track takes it as it is."""
    slabs = frame_sharding(mesh, cfg, axis_name)

    def sensor(frame: Frame, cfg: SLAMConfig = cfg):
        pyrs = [slab_pyramid(frame, cfg, s) for s in slabs]
        rows = [(s.rows[0], p) for s, p in zip(slabs, pyrs)]

        def track(last_pyramid, _pyramid, cfg, init_T=None):
            return tracking.track_slabs(last_pyramid, rows, cfg,
                                        init_T=init_T, psum=psum)

        return gather_pyramid(pyrs, cfg), track

    return sensor


def sharded_step(cfg: SLAMConfig, mesh: Mesh, axis_name: str = "px"):
    """pipeline.step with the frame row-sharded over the mesh: each slab's
    pyramid on its device, the normal equations psum'd; the state
    replicated (one map, on the mesh's home device)."""
    sensor = row_sharded_sensor(cfg, mesh, axis_name)

    def fn(state, frame):
        return pipeline.step(replicated(mesh, state), frame, cfg,
                             sensor=sensor)

    return fn


def icp_psum(v1, n1, v2, n2, cfg: SLAMConfig, mesh: Mesh,
             axis_name: str = "px") -> Tuple[torch.Tensor, torch.Tensor]:
    """The collective contract of the row-sharded tracker: rows split over
    the mesh axis (equal slabs, as shard_map splits them), each slab's
    partial normal equations, one psum of A (36 floats) and b (6). Returns
    (A, b) on the mesh's home device."""
    devs = mesh.axis_devices(axis_name)
    h = v1.shape[0]
    assert h % len(devs) == 0, f"{h} rows over {len(devs)} slabs"
    r = h // len(devs)
    parts = [tracking.icp_sums(*(x[i * r:(i + 1) * r].to(dev)
                                 for x in (v1, n1, v2, n2)), cfg)
             for i, dev in enumerate(devs)]
    return psum([p[0] for p in parts])[0], psum([p[1] for p in parts])[0]


# ------------------------------------------------------ the sharded map

class ShardedMap(NamedTuple):
    """Morton-range-sharded map: shard d's pool and registry on its own
    device. Shard d owns the contiguous Morton cell range [bounds[d],
    bounds[d+1]) at level cfg.map_split_level (keys are level-major, so a
    cell range is a key range); `rebalance_sharded` re-cuts the ranges to
    equalise the observed leaf load."""

    pools: List[SVONodePool]
    leaves: List[LeafList]
    bounds: np.ndarray       # i32[M+1], on the host


def default_bounds(cfg: SLAMConfig, m: int) -> np.ndarray:
    """Equal key-space split of the 8^split_level cells over m shards
    (i32[m+1]). With split_level=1 and m=8 this is one octant a shard."""
    cells = 1 << (3 * cfg.map_split_level)
    need = max(1, (m - 1).bit_length() + 2) // 3
    assert m <= cells, f"{m} shards need map_split_level >= {need}"
    return np.round(np.arange(m + 1) * cells / m).astype(np.int32)


def make_sharded_map(cfg: SLAMConfig, mesh: Mesh, map_center=(0.0, 0.0, 0.0),
                     axis_name: str = "map", bounds=None) -> ShardedMap:
    """M empty pools and registries, one per device of the map axis."""
    devs = mesh.axis_devices(axis_name)
    if bounds is None:
        bounds = default_bounds(cfg, len(devs))
    bounds = np.asarray(bounds, np.int32)
    assert bounds.shape == (len(devs) + 1,)
    half = cfg.voxel_resolution * (2 ** (cfg.max_depth - 1))
    return ShardedMap(
        pools=[svo.create(cfg.node_capacity, map_center, half, device=d)
               for d in devs],
        leaves=[create_leaf_list(cfg.leaf_capacity, cfg.node_capacity,
                                 device=d) for d in devs],
        bounds=bounds)


def _owned(prefix: torch.Tensor, bounds: np.ndarray, d: int) -> torch.Tensor:
    return (prefix >= int(bounds[d])) & (prefix < int(bounds[d + 1]))


def insert_sharded(smap: ShardedMap, points, colors, cfg: SLAMConfig,
                   mesh: Mesh, axis_name: str = "map"
                   ) -> Tuple[ShardedMap, torch.Tensor]:
    """Morton-range-sharded insert: every shard sees the frame's world
    points, keeps those whose level-L key prefix lies in its range (the
    octant chain is prefix-consistent, so encoding at depth L is the full
    key's prefix; non-finite points encode to INVALID_KEY, owned by no
    shard) and runs the batched insert into its own pool, paging its
    unique-cap remainder in sorted key order. All shards page together,
    one host read of their overflow flags a round. Shards are disjoint by
    key, so their union is the single-pool insert bit for bit.
    Returns (map, global unique count: one psum)."""
    L = cfg.map_split_level
    devs = mesh.axis_devices(axis_name)
    pools, leaves = list(smap.pools), list(smap.leaves)
    work = []
    for d, dev in enumerate(devs):
        pts, cols = points.to(dev), colors.to(dev)
        prefix, _ = morton.encode(pts, pools[d].center, pools[d].half_size, L)
        work.append((pts, cols, _owned(prefix, smap.bounds, d)))
    n_unique: list = [None] * len(devs)
    cursor: list = [None] * len(devs)
    todo = list(range(len(devs)))
    while todo:
        more = []
        for d in todo:
            pts, cols, mine = work[d]
            pools[d], st = svo.insert(pools[d], pts, cols, valid=mine,
                                      depth=cfg.max_depth,
                                      unique_cap=cfg.insert_unique_cap,
                                      min_key=cursor[d])
            leaves[d] = append_new_leaves(leaves[d], st)
            n_unique[d] = (st.n_unique if n_unique[d] is None
                           else n_unique[d] + st.n_unique)
            cursor[d] = st.last_key
            more.append(st.unique_overflow.to(mesh.home))
        todo = [d for d, m in zip(todo, torch.stack(more).tolist()) if m]
    return (ShardedMap(pools=pools, leaves=leaves, bounds=smap.bounds),
            psum(n_unique)[0])


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def registry_rows(lv: LeafList) -> Tuple[np.ndarray, np.ndarray]:
    """(keys i32, words u32) of a registry's live rows, on the host."""
    k = _host(lv.keys)
    live = k >= 0
    return k[live], _host(lv.vals)[live].view(np.uint32)


def _exact_rebuild(keys: np.ndarray, vals: np.ndarray, center, half_size,
                   cfg: SLAMConfig, device):
    """A fresh pool and registry from a (keys, u32 words) leaf snapshot of
    distinct live keys: the value-verbatim insert in sorted key chunks of
    insert_unique_cap (the reference's unique-cap pages), then the interior
    refresh. The shard-local rebuild behind boundary growth, rebalancing
    and the sharded spill."""
    from octree_slam_tpu_torch.map import tiering
    fresh = svo.create(cfg.node_capacity, center, half_size, device=device)
    out = create_leaf_list(cfg.leaf_capacity, cfg.node_capacity,
                           device=device)
    fresh, stats = tiering.bulk_insert_exact(
        fresh, keys, vals, depth=cfg.max_depth,
        unique_cap=cfg.insert_unique_cap,
        shallow_level=pipeline._accel_level(cfg), overwrite=True)
    for st in stats:
        out = append_new_leaves(out, st)
    return svo.refresh_interior(fresh, depth=cfg.max_depth), out


def any_flag(flags: Sequence[torch.Tensor], home) -> bool:
    """Whether any shard's 0-d flag is set: one host read."""
    return bool(torch.stack([f.to(home) for f in flags]).any())


def grow_sharded(smap: ShardedMap, cfg: SLAMConfig, mesh: Mesh, *,
                 grow_nodes: bool = True, grow_leaves: bool = False,
                 axis_name: str = "map") -> Tuple[ShardedMap, SLAMConfig]:
    """Double every shard's pool and/or registry capacity, keeping all
    content: pipeline.grow_state for the sharded map (all shards share one
    capacity). A registry that overflowed is first rebuilt from an
    extraction of each shard's pool, sized to the largest shard; within a
    prealloc schedule the pools and registries pad in place (child pointers
    are absolute); a doubling across a prealloc boundary rebuilds each
    shard from its own registry by the value-verbatim insert. Everything is
    shard-local."""
    new_cfg = dataclasses.replace(
        cfg,
        node_capacity=cfg.node_capacity * (2 if grow_nodes else 1),
        leaf_capacity=cfg.leaf_capacity * (2 if grow_leaves else 1))
    pools, leaves = list(smap.pools), list(smap.leaves)
    rebuild = grow_nodes and (svo.prealloc_levels(new_cfg.node_capacity)
                              != svo.prealloc_levels(cfg.node_capacity))
    if any_flag([lv.overflowed for lv in leaves], mesh.home):
        # appends were dropped: re-register every shard's leaves from its
        # pool (the extraction's BFS reads interiors: refresh them first)
        exs = []
        for pool in pools:
            pool = svo.refresh_interior(pool, depth=cfg.max_depth)
            exs.append((pool, *svo.extract_all_leaves(
                pool, depth=cfg.max_depth,
                start_capacity=new_cfg.leaf_capacity)))
        final_cap = max(cap for _, _, cap in exs)
        new_cfg = dataclasses.replace(new_cfg, leaf_capacity=final_cap)
        for d, (pool, ex, cap) in enumerate(exs):
            if cap != final_cap:
                ex = svo.extract_voxels(pool, depth=cfg.max_depth,
                                        capacity=final_cap)
            leaves[d] = leaf_list_from_extraction(
                ex, pool.value, node_capacity=cfg.node_capacity)

    if rebuild:
        for d, pool in enumerate(pools):
            keys, vals = registry_rows(leaves[d])
            pools[d], leaves[d] = _exact_rebuild(
                keys, vals, pool.center, pool.half_size, new_cfg,
                pool.child.device)
        return ShardedMap(pools, leaves, smap.bounds), new_cfg

    if grow_nodes:
        pools = [svo.grow_capacity(p, new_cfg.node_capacity) for p in pools]
    leaves = [sp.pad_leaf_list(lv, new_cfg.leaf_capacity,
                               new_cfg.node_capacity) for lv in leaves]
    return ShardedMap(pools, leaves, smap.bounds), new_cfg


def shard_leaf_counts(smap: ShardedMap) -> np.ndarray:
    """Per-shard live leaf counts (i32[M], on the host): the load-imbalance
    metric. Registry keys are -1 until appended, so `keys >= 0` counts
    exactly the registered leaves."""
    home = smap.pools[0].child.device
    return _host(torch.stack([(lv.keys >= 0).sum(dtype=torch.int32).to(home)
                              for lv in smap.leaves]))


def balanced_bounds(cell_counts, m: int) -> np.ndarray:
    """Cut the level-L cell space into m contiguous ranges of near-equal
    total count (greedy cumulative-sum split). cell_counts: i64[8^L]
    leaves per cell. Returns i32[m+1], strictly increasing, covering
    [0, 8^L]: every shard owns at least one cell, so the partition stays
    total and disjoint."""
    cells = len(cell_counts)
    c = np.concatenate([[0], np.cumsum(cell_counts)])
    total = int(c[-1])
    bounds = [0]
    for d in range(1, m):
        t = total * d / m
        i = int(np.searchsorted(c, t, side="left"))
        i = max(bounds[-1] + 1, min(i, cells - (m - d)))
        bounds.append(i)
    bounds.append(cells)
    return np.asarray(bounds, np.int32)


def rebuild_from_union(smap: ShardedMap, cfg: SLAMConfig, mesh: Mesh,
                       keys_live, vals_live, bounds,
                       axis_name: str = "map") -> ShardedMap:
    """Rebuild every shard from a union (keys, u32 words) leaf snapshot
    under `bounds`: each shard keeps the rows in its own Morton range and
    runs the shard-local value-verbatim rebuild. Shared by
    rebalance_sharded (re-cut bounds) and the sharded spill (unchanged
    bounds, cold rows dropped). Host-level, rare."""
    keys_live = np.asarray(keys_live, np.int32)
    vals_live = np.asarray(vals_live, np.uint32)
    bounds = np.asarray(bounds, np.int32)
    prefix = keys_live >> (3 * (cfg.max_depth - cfg.map_split_level))
    pools, leaves = [], []
    for d, pool in enumerate(smap.pools):
        mine = (keys_live >= 0) & (prefix >= bounds[d]) \
            & (prefix < bounds[d + 1])
        p, lv = _exact_rebuild(keys_live[mine], vals_live[mine], pool.center,
                               pool.half_size, cfg, pool.child.device)
        pools.append(p)
        leaves.append(lv)
    return ShardedMap(pools, leaves, bounds)


def union_leaf_snapshot(smap: ShardedMap, cfg: SLAMConfig
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The complete union (keys i32, words u32) leaf snapshot of the map on
    the host. From the registries, which mirror every leaf's word; when a
    registry has overflowed it misses leaves that only its pool holds, so
    then from an extraction of every shard's pool (the single-device
    tiering._leaf_snapshot rule). Every rebuild that feeds a union back
    into the pools (rebalance, spill) goes through this."""
    home = smap.pools[0].child.device
    if not any_flag([lv.overflowed for lv in smap.leaves], home):
        rows = [registry_rows(lv) for lv in smap.leaves]
        return (np.concatenate([k for k, _ in rows]),
                np.concatenate([v for _, v in rows]))
    ks, vs = [], []
    for pool in smap.pools:
        pool = svo.refresh_interior(pool, depth=cfg.max_depth)
        ex, _ = svo.extract_all_leaves(
            pool, depth=cfg.max_depth,
            start_capacity=max(cfg.extract_capacity, cfg.leaf_capacity))
        n = int(ex.count)
        nodes = ex.nodes[:n]
        live = nodes >= 0
        ks.append(_host(ex.keys[:n][live]))
        vs.append(_host(pool.value[nodes[live]]).view(np.uint32))
    return np.concatenate(ks), np.concatenate(vs)


def rebalance_sharded(smap: ShardedMap, cfg: SLAMConfig, mesh: Mesh,
                      axis_name: str = "map") -> ShardedMap:
    """Re-cut the shard boundaries to equalise leaf load and redistribute
    the map (host-level, at growth cadence): the per-cell leaf histogram at
    cfg.map_split_level, balanced contiguous ranges, and every shard
    rebuilt from the complete union snapshot filtered to its new range, so
    the union is bit-identical before and after. Needs map_split_level >= 2
    to help: level 1 has only 8 cells to cut."""
    m = len(smap.pools)
    L = cfg.map_split_level
    keys_live, vals_live = union_leaf_snapshot(smap, cfg)
    prefixes = keys_live >> (3 * (cfg.max_depth - L))
    counts = np.bincount(prefixes, minlength=1 << (3 * L))
    return rebuild_from_union(smap, cfg, mesh, keys_live, vals_live,
                              balanced_bounds(counts, m),
                              axis_name=axis_name)


# ----------------------------------------------------------- rendering

def splat_sharded(leaf_vals: Sequence[torch.Tensor],
                  leaf_keys: Sequence[torch.Tensor], center, half_size,
                  world_T_cam, fx, fy, cfg: SLAMConfig, mesh: Mesh,
                  axis_name: str = "map") -> torch.Tensor:
    """Map-sharded splat: each shard z-buffers its own registry on its
    device and one pmin of the packed depth<<16|RGB565 words composites
    them (the exact global z-resolve: min per shard, then across shards, is
    the global scatter-min). Returns the finished f32[H, W, 4] image on the
    first shard's device."""
    return sp.finish_zbuffer(
        _zbuffer_sharded(leaf_vals, leaf_keys, center, half_size,
                         world_T_cam, fx, fy, cfg),
        width=cfg.width, height=cfg.height)


def _zbuffer_sharded(leaf_vals, leaf_keys, center, half_size, world_T_cam,
                     fx, fy, cfg: SLAMConfig) -> torch.Tensor:
    bufs = []
    for vals, keys in zip(leaf_vals, leaf_keys):
        dev = keys.device
        bufs.append(sp.leaf_zbuffer(
            vals, keys, None, center.to(dev), half_size.to(dev),
            world_T_cam.to(dev), fx, fy, width=cfg.width, height=cfg.height,
            depth=cfg.max_depth, max_range=cfg.max_range))
    return pmin(bufs)[0]


def render_sharded_map(smap: ShardedMap, world_T_cam, fx, fy,
                       cfg: SLAMConfig, mesh: Mesh,
                       axis_name: str = "map") -> torch.Tensor:
    """Splat the sharded map (splat_sharded over its registries)."""
    p0 = smap.pools[0]
    return splat_sharded([lv.vals for lv in smap.leaves],
                         [lv.keys for lv in smap.leaves], p0.center,
                         p0.half_size, world_T_cam, fx, fy, cfg, mesh,
                         axis_name=axis_name)


def model_zbuffer_sharded(smap: ShardedMap, pose, cfg: SLAMConfig,
                          mesh: Mesh, axis_name: str = "map"
                          ) -> torch.Tensor:
    """Packed splat z-buffer i32[H*W] of the sharded map from `pose`: the
    model view relocalization scores candidates against (per-shard
    scatter, one pmin); relocalize.pyramid_from_zbuffer finishes it."""
    p0 = smap.pools[0]
    return _zbuffer_sharded([lv.vals for lv in smap.leaves],
                            [lv.keys for lv in smap.leaves], p0.center,
                            p0.half_size, pose, cfg.focal_x, cfg.focal_y,
                            cfg)


def slab_words_sharded(smap: ShardedMap, world_T_cam, fx, fy,
                        cfg: SLAMConfig, spec) -> torch.Tensor:
    """Each shard's slab-cell scatter-min of its own registry, one pmin of
    the packed (prio9 | inv_alpha7 | rgb555) words: bit-identical to the
    global scatter-min."""
    p0 = smap.pools[0]
    bufs = []
    for lv in smap.leaves:
        dev = lv.keys.device
        bufs.append(conesplat.slab_scatter_min(
            lv.vals, lv.keys, lv.keys >= 0, p0.center.to(dev),
            p0.half_size.to(dev), world_T_cam.to(dev), fx, fy, spec=spec,
            depth=cfg.max_depth))
    return pmin(bufs)[0]


def render_sharded_cone(smap: ShardedMap, world_T_cam, fx, fy,
                        cfg: SLAMConfig, mesh: Mesh,
                        axis_name: str = "map") -> torch.Tensor:
    """The slab cone (render/conesplat.py) over the sharded map: per-shard
    scatter-min, one pmin of the word buffer (total_cells words a frame,
    the same order as the splat's z-buffer), then the front-to-back
    composite once, on the first shard's device."""
    spec = pipeline._slab_spec(cfg)
    return conesplat.composite_min_words(
        slab_words_sharded(smap, world_T_cam, fx, fy, cfg, spec), spec=spec)


def union_leaf_mirror(smap: ShardedMap, cfg: SLAMConfig):
    """The dense leaf mirror (leaf level, occupancy, distance field) of the
    sharded map, on the first shard's device: what the hybrid's band march
    samples (it reads only the leaf level and `dist`). One scatter of the
    all-gathered registries (their words mirror every leaf's; shards own
    disjoint keys, so indices never collide); interior levels stay EMPTY.
    With cfg.cone_band_fused_dist the free leaf cells carry their dist
    cell's skip distance (mips.encode_free_dist). Returns (cache, level)."""
    lvl = pipeline._accel_level(cfg)
    keys = all_gather([lv.keys for lv in smap.leaves])[0]
    vals = all_gather([lv.vals for lv in smap.leaves])[0]
    live = keys >= 0
    total = mips.total_cells(cfg.max_depth)
    values = torch.full((total,), packing.EMPTY_VALUE, dtype=torch.int32,
                        device=keys.device)
    compaction.scatter_set_(
        values, torch.where(live, mips.flat_index(keys, cfg.max_depth,
                                                  cfg.max_depth), total),
        vals)
    g = 1 << lvl
    x, y, z = mips.deinterleave3(
        torch.where(live, keys >> (3 * (cfg.max_depth - lvl)), 0), lvl)
    occ = torch.zeros((g * g * g,), dtype=torch.bool, device=keys.device)
    compaction.scatter_set_(
        occ, torch.where(live, (z << (2 * lvl)) | (y << lvl) | x, g * g * g),
        torch.ones_like(live))
    dist = mips._dist_from_occ(occ.reshape(g, g, g),
                               cfg.dist_max_skip).reshape(-1)
    cache = mips.RenderCache(values=values, occ=occ, dist=dist)
    if cfg.cone_band_fused_dist:
        cache = mips.encode_free_dist(cache, max_depth=cfg.max_depth,
                                      dist_level=lvl)
    return cache, lvl


def render_sharded_hybrid(smap: ShardedMap, world_T_cam, fx, fy,
                          cfg: SLAMConfig, mesh: Mesh,
                          axis_name: str = "map") -> torch.Tensor:
    """The hybrid (render/hybrid.py) over the sharded map: the slab words
    as render_sharded_cone makes them, the composite with its per-pixel
    first-hit seeds, then the band select, seeded march and merge over the
    union leaf mirror, once, on the first shard's device. As in the
    reference, cfg.cone_band_sel_decimate is not passed on: the 2-D render
    always selects the full top-C."""
    spec = pipeline._slab_spec(cfg)
    fb, _w, z_first = conesplat.composite_min_words(
        slab_words_sharded(smap, world_T_cam, fx, fy, cfg, spec),
        spec=spec, dilate=1, want_aux=True)
    cache, lvl = union_leaf_mirror(smap, cfg)
    p0 = smap.pools[0]
    return hybrid.band_march_merge(
        fb, z_first, cache, p0.center, p0.half_size,
        world_T_cam.to(fb.device), fx, fy, spec=spec, depth=cfg.max_depth,
        dist_level=lvl, max_range=cfg.max_range, start_dist=cfg.start_dist,
        band_cap=cfg.cone_band_cap, band_iters=cfg.cone_band_iters,
        crawl=cfg.cone_band_crawl, fused_dist=cfg.cone_band_fused_dist,
        depth_prio=cfg.cone_band_depth_prio,
        compact_after=cfg.cone_band_compact_after)


# ------------------------------------------------- the 2-D mesh's step

RENDERS_2D = ("splat", "cone", "cone_hybrid", "none")


class State2D(NamedTuple):
    """slam_step_2d's state, in the reference's tuple order. The key_*
    fields are empty unless cfg.track_keyframe (pipeline.SLAMState's
    gating). Everything but `smap` is replicated, on the mesh's home."""

    last_pyramid: Tuple[PyramidLevel, ...]
    pose: torch.Tensor          # f32[4,4] world_T_cam
    initialized: torch.Tensor   # bool[]
    smap: ShardedMap
    diverged: torch.Tensor      # bool[]
    key_pyramid: Tuple[PyramidLevel, ...]
    key_pose: torch.Tensor      # f32[4,4] ((0,) when off)
    key_T_cam: torch.Tensor     # f32[4,4] ((0,) when off)


def slam_init_2d(cfg: SLAMConfig, mesh: Mesh, map_center=(0.0, 0.0, 0.0),
                 initial_pose=None) -> State2D:
    """The empty state of slam_step_2d: pyramids, pose and flags on the
    mesh's home, one empty pool and registry per map shard."""
    home = mesh.home
    pose = (torch.eye(4, dtype=torch.float32, device=home)
            if initial_pose is None
            else torch.as_tensor(initial_pose, dtype=torch.float32)
            .to(home).clone())
    false = torch.zeros((), dtype=torch.bool, device=home)
    empty = torch.zeros((0,), dtype=torch.float32, device=home)
    kf = cfg.track_keyframe
    return State2D(
        last_pyramid=pipeline._empty_pyramid(cfg, home), pose=pose,
        initialized=false,
        smap=make_sharded_map(cfg, mesh, map_center=map_center,
                              axis_name=axis_name_of(mesh)),
        diverged=false.clone(),
        key_pyramid=pipeline._empty_pyramid(cfg, home) if kf else (),
        key_pose=pose.clone() if kf else empty,
        key_T_cam=(torch.eye(4, dtype=torch.float32, device=home) if kf
                   else empty.clone()))


def slam_step_2d(cfg: SLAMConfig, mesh: Mesh, render: str = "splat",
                 sticky_gate: bool = False):
    """The whole SLAM frame on a 2-D ("px", "map") mesh:

      * the pyramid by row slabs over "px" and the tracker with its sums
        psum'd (row_sharded_sensor), the same math as pipeline.step's
        frame-to-frame or keyframe-anchored tracking (pipeline._track);
      * fusion routes the world points into the Morton-range map shards
        over "map" (insert_sharded: shard-local key filter, per-shard
        insert and paging, one psum of the unique count);
      * the render: "splat" (z-buffer pmin), "cone" (the slab cone's word
        pmin), "cone_hybrid" (plus the band march over the union mirror)
        or "none" (a zero image).

    sticky_gate is pipeline.step's recovery contract: with it the diverged
    flag latches and gates fusion until the host loop's relocalization
    clears it (run2d.run_slam_2d); without it a bad frame is skipped and
    fusion resumes when tracking locks again.

    Returns step(state, frame) -> (state, (framebuffer, pose, signals)),
    signals the packed f32[11] health vector [unique_total,
    max_shard_nodes, max_shard_leaf_count, any_pool_overflow,
    any_leaf_overflow, diverged, residual, inliers, cam_x, cam_y, cam_z]
    on the mesh's home: one read a frame drives the host loop. The map is
    written in place: never step twice from one state."""
    if render not in RENDERS_2D:
        raise ValueError(f"render={render!r} is none of {RENDERS_2D}")
    home = mesh.home
    map_axis = axis_name_of(mesh)
    sensor = row_sharded_sensor(cfg, mesh, "px")

    def step(state: State2D, frame: Frame):
        pyramid, track = sensor(frame, cfg)
        pose, tstats, new_div, key_pyramid, key_pose, key_T_cam = \
            pipeline._track(state, pyramid, cfg, track)
        v = pyramid[cfg.fuse_level].vertex.reshape(-1, 3)
        world_pts = v @ pose[:3, :3].T + pose[:3, 3]
        colors = pipeline._fuse_colors(frame, cfg).to(home)
        gate = new_div if sticky_gate else (state.initialized
                                            & tstats.diverged)
        world_pts = torch.where(~gate, world_pts, torch.inf)
        smap, total = insert_sharded(state.smap, world_pts, colors, cfg,
                                     mesh, axis_name=map_axis)
        if render == "cone":
            fb = render_sharded_cone(smap, pose, cfg.focal_x, cfg.focal_y,
                                     cfg, mesh)
        elif render == "cone_hybrid":
            fb = render_sharded_hybrid(smap, pose, cfg.focal_x, cfg.focal_y,
                                       cfg, mesh)
        elif render == "splat":
            fb = render_sharded_map(smap, pose, cfg.focal_x, cfg.focal_y,
                                    cfg, mesh)
        else:
            fb = torch.zeros((cfg.height, cfg.width, 4), device=home)

        def stacked(xs):
            return torch.stack([x.to(home) for x in xs])

        signals = torch.cat([torch.stack([
            total.to(torch.float32),
            stacked([p.n_nodes for p in smap.pools]).max().to(torch.float32),
            stacked([lv.count for lv in smap.leaves]).max()
            .to(torch.float32),
            stacked([p.overflowed for p in smap.pools]).any()
            .to(torch.float32),
            stacked([lv.overflowed for lv in smap.leaves]).any()
            .to(torch.float32),
            new_div.to(torch.float32),
            # the finest tracked level's stats (index 0)
            tstats.residual[0].to(torch.float32),
            tstats.inliers[0].to(torch.float32),
        ]), pose[:3, 3].to(torch.float32)])
        new_state = State2D(
            last_pyramid=tuple(pyramid), pose=pose,
            initialized=torch.ones((), dtype=torch.bool, device=home),
            smap=smap, diverged=new_div, key_pyramid=key_pyramid,
            key_pose=key_pose, key_T_cam=key_T_cam)
        return new_state, (fb, pose, signals)

    return step
