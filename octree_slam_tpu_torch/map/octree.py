"""Host-side octree facade: resolution, growth, checkpoints (counterpart:
octree_slam_tpu/map/octree.py, the Octree host API of octree.cpp:251-385).

The pool is always the linear device form, which is also a complete
snapshot, so the reference's pushToGPU / pullToCPU are not needed. Growth
(Octree::expandBySize, octree.cpp:362-378) doubles the half-size k times
with svo.reroot_double, which keeps every leaf's word and world position;
past the 30-bit key budget (depth 10) the map coarsens by extraction and
re-insertion, as the reference's bounded max_depth does (octree.cpp:284).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from octree_slam_tpu_torch.core.types import BoundingBox, VoxelGrid
from octree_slam_tpu_torch.map import svo

MAX_KEY_DEPTH = 10  # 30-bit int32 Morton keys


class Octree:
    """Dynamic-resolution octree over a fixed-capacity node pool on
    `device`."""

    def __init__(self, resolution: float, center, size: float,
                 capacity: int = 1 << 20, extract_capacity: int = 1 << 18,
                 device="cuda"):
        """resolution = target leaf half-edge; size = root half-edge (the
        root box is center +- size, octree.cpp:274-275)."""
        self.resolution = float(resolution)
        self.capacity = int(capacity)
        self.extract_capacity = int(extract_capacity)
        self.max_depth = self._depth_for(size)
        self.pool = svo.create(capacity, center, size, device=device)

    def _depth_for(self, size: float) -> int:
        # max_depth = ceil(log2(edge / resolution)) (octree.cpp:284)
        d = max(1, math.ceil(math.log2(max(size / self.resolution, 2.0))))
        return min(d, MAX_KEY_DEPTH)

    @property
    def center(self) -> np.ndarray:
        return self.pool.center.cpu().numpy()

    @property
    def size(self) -> float:
        return float(self.pool.half_size)

    def bounding_box(self) -> BoundingBox:
        c, s = self.pool.center, self.pool.half_size
        return BoundingBox(bbox0=c - s, bbox1=c + s)

    def contains(self, bbox: BoundingBox) -> bool:
        """True if `bbox` lies wholly inside the root cell."""
        return bool(self.bounding_box().contains(bbox))

    def _insert_all(self, points, colors, valid) -> svo.InsertStats:
        """Insert, paging through the sorted remainder while a frame has
        more than unique_cap distinct leaves (each leaf blends once)."""
        self.pool, stats = svo.insert(self.pool, points, colors, valid,
                                      depth=self.max_depth)
        n_unique, new_nodes = stats.n_unique, stats.new_nodes
        while bool(stats.unique_overflow):
            self.pool, stats = svo.insert(self.pool, points, colors, valid,
                                          depth=self.max_depth,
                                          min_key=stats.last_key)
            n_unique = n_unique + stats.n_unique
            new_nodes = new_nodes + stats.new_nodes
        return stats._replace(n_unique=n_unique, new_nodes=new_nodes)

    def add_cloud(self, points, colors, valid=None) -> svo.InsertStats:
        """svoFromPointCloud (octree.cpp:269-291); colours in [0, 1]."""
        return self._insert_all(points, colors, valid)

    def add_voxel_grid(self, grid: VoxelGrid) -> svo.InsertStats:
        """svoFromVoxelGrid (octree.cpp:293-313)."""
        live = torch.arange(grid.centers.shape[0],
                            device=grid.centers.device) < grid.count
        return self._insert_all(grid.centers, grid.colors[:, :3], live)

    def expand_by_size(self, add_size: float) -> None:
        """Grow the volume to cover size + add_size by k doublings, each a
        value-preserving in-pool remap (svo.reroot_double); past
        MAX_KEY_DEPTH the map coarsens instead."""
        old_size = self.size
        k = max(1, math.ceil(math.log2((old_size + add_size) / old_size)))
        for _ in range(k):
            if self.max_depth + 1 > MAX_KEY_DEPTH:
                self._expand_coarsen(self.size * 2.0)
                continue
            # the bridge reroot_double writes is 8^pre slots, pre from the
            # current capacity (a growth may cross a prealloc boundary)
            while True:
                pre = svo.prealloc_levels(self.capacity)
                bridge = svo._LEVEL_BASE[pre + 1] - svo._LEVEL_BASE[pre]
                if int(self.pool.n_nodes) + bridge <= self.capacity:
                    break
                self.grow_capacity(2 * self.capacity)
            before = self.size
            self.pool = svo.reroot_double(self.pool)
            if self.size <= before:
                raise RuntimeError("expand_by_size: reroot_double did not "
                                   "fit despite the headroom check")
            self.max_depth += 1

    def grow_capacity(self, new_capacity: int) -> None:
        """The pool at a larger capacity: a pad, or across a prealloc
        boundary a rebuild from the exact leaf set (insert_exact), with
        every value kept."""
        if (svo.prealloc_levels(new_capacity)
                != svo.prealloc_levels(self.capacity)):
            from octree_slam_tpu_torch.map import tiering
            ex, _ = svo.extract_all_leaves(
                self.pool, depth=self.max_depth,
                start_capacity=self.extract_capacity)
            n = int(ex.count)
            nodes = ex.nodes[:n]
            live = nodes >= 0
            keys = ex.keys[:n][live].cpu().numpy()
            vals = self.pool.value[nodes[live]].cpu().numpy().view(
                np.uint32)
            fresh = svo.create(new_capacity, self.pool.center,
                               self.pool.half_size,
                               device=self.pool.child.device)
            fresh, _ = tiering.bulk_insert_exact(
                fresh, keys, vals, depth=self.max_depth,
                unique_cap=min(1 << 16, new_capacity), overwrite=True)
            self.pool = svo.refresh_interior(fresh, depth=self.max_depth)
        else:
            self.pool = svo.grow_capacity(self.pool, new_capacity)
        self.capacity = new_capacity

    def _expand_coarsen(self, new_size: float) -> None:
        """Depth-capped growth: the volume doubles with the keys exhausted,
        so 8 leaves merge into 1 through extraction and re-insertion."""
        ex = svo.extract_voxels(self.pool, depth=self.max_depth,
                                capacity=self.extract_capacity)
        count = int(ex.count)
        if count >= self.extract_capacity:
            warnings.warn(
                "Octree._expand_coarsen: map has >= extract_capacity "
                f"({self.extract_capacity}) occupied leaves; coarsening "
                "drops the excess; raise extract_capacity", RuntimeWarning)
        self.max_depth = self._depth_for(new_size)
        self.pool = svo.create(self.capacity, self.pool.center, new_size,
                               device=self.pool.child.device)
        if count:
            live = torch.arange(ex.centers.shape[0],
                                device=ex.centers.device) < ex.count
            # observed twice, so that each leaf is occupied (alpha > 127)
            for _ in range(2):
                self.pool, _ = svo.insert(self.pool, ex.centers,
                                          ex.colors[:, :3], valid=live,
                                          depth=self.max_depth)

    def extract_voxel_grid(self) -> VoxelGrid:
        """extractVoxelGridFromSVO at the octree's own resolution
        (octree.cpp:315-337)."""
        out = svo.extract_voxels(self.pool, depth=self.max_depth,
                                 capacity=self.extract_capacity)
        scale = self.size / (2 ** (self.max_depth - 1)) / 2.0
        return VoxelGrid(centers=out.centers, colors=out.colors,
                         count=out.count,
                         scale=torch.tensor(scale, dtype=torch.float32),
                         bbox=self.bounding_box())

    def extract_svo(self) -> svo.SVONodePool:
        """The live pool (Octree::extractSVO, octree.cpp:339-360)."""
        return self.pool

    def save(self, path: str) -> None:
        p = self.pool
        np.savez_compressed(
            path, child=p.child.cpu().numpy(),
            value=p.value.cpu().numpy().view(np.uint32),
            n_nodes=p.n_nodes.cpu().numpy(), center=p.center.cpu().numpy(),
            half_size=p.half_size.cpu().numpy(),
            overflowed=p.overflowed.cpu().numpy(),
            resolution=self.resolution, max_depth=self.max_depth,
            # the dense layout is part of the file's meaning: see load()
            prealloc=svo.prealloc_levels(self.capacity))

    @classmethod
    def load(cls, path: str, device="cuda") -> "Octree":
        """An octree from `save`'s file. A file without the prealloc stamp
        or with another prealloc schedule is refused: its shallow levels
        would be misindexed."""
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        tree = cls.__new__(cls)
        tree.resolution = float(data["resolution"])
        tree.max_depth = int(data["max_depth"])
        tree.capacity = int(data["child"].shape[0])
        if "prealloc" not in data:
            raise ValueError(f"octree file {path!r} has no prealloc stamp: "
                             f"its pool layout cannot be checked")
        cur = svo.prealloc_levels(tree.capacity)
        if int(data["prealloc"]) != cur:
            raise ValueError(
                f"octree file {path!r} was written with "
                f"{int(data['prealloc'])} dense-preallocated levels but this "
                f"build uses {cur} for capacity {tree.capacity}")
        tree.extract_capacity = 1 << 18

        def t(name, view=None):
            a = data[name]
            return torch.from_numpy(np.array(a.view(view) if view else a,
                                             order="C")).to(device)

        tree.pool = svo.SVONodePool(
            child=t("child"), value=t("value", np.int32),
            n_nodes=t("n_nodes"), center=t("center"),
            half_size=t("half_size"), overflowed=t("overflowed"))
        return tree
