"""Configuration of the port (counterpart: octree_slam_tpu/config.py).

The port keeps its own copy of the reference package's `SLAMConfig`: the
same fields, defaults, properties and methods, so a configuration built
for one package describes the same run in the other, field for field
(tests/test_torch_config.py holds the two against each other); the port
runs every value of every field that the reference's step runs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    # --- sensor / image ---
    width: int = 640
    height: int = 480
    focal_x: float = 532.57
    focal_y: float = 531.54
    depth_min_mm: int = 1          # depth == 0 is "no measurement"
    depth_max_mm: int = 15000

    # --- bilateral filter ---
    bilateral_kernel_size: int = 7
    bilateral_sigma_depth: float = 40.0   # mm
    bilateral_sigma_spatial: float = 4.5

    # --- intensity ratios (r, g, b) ---
    intensity_ratio: Tuple[float, float, float] = (0.299, 0.587, 0.114)

    # --- ICP tracking ---
    pyramid_depth: int = 3
    pyramid_iters: Tuple[int, ...] = (10, 5, 4)   # fine -> coarse
    track_finest_level: int = 0   # ICP refines down to this level;
                                  # pyramid_iters indexes relative to it
    fuse_level: int = 0           # level whose vertex map feeds fusion
    track_keyframe: bool = False  # anchor ICP to the last keyframe
    keyframe_max_dist: float = 0.12       # m: re-anchor beyond this
    keyframe_max_angle_deg: float = 8.0   # deg: ... or this rotation
    icp_symmetric: bool = True    # r = (n1 + n2').(v1 - v2')
    icp_huber_k: float = 0.02     # > 0: IRLS Huber weight min(1, k/|r|)
    icp_dist_thresh: float = 0.1        # meters
    icp_norm_thresh: float = 0.87       # cos(30 deg)
    icp_z_min: float = 0.1              # meters
    icp_z_max: float = 10.0
    w_rgbd: float = 0.0                 # photometric term weight

    # --- map / SVO ---
    lazy_interior: bool = True    # defer the interior mipmap refresh on
                                  # frames whose renderer reads only leaves
    device_remainder: bool = True  # finish unique-cap remainder pages
                                   # inside the step
    voxel_resolution: float = 0.01      # meters, leaf size
    max_depth: int = 9                  # octree levels (<= 10: 30-bit keys)
    node_capacity: int = 1 << 21        # static node-pool capacity
    extract_capacity: int = 1 << 18     # static voxel-extraction buffer
    insert_unique_cap: int = 1 << 16    # distinct leaf voxels per insert
    leaf_capacity: int = 1 << 19        # persistent leaf registry
    insert_dircache: bool = False       # last frame's key -> node cache
    saturation_gate: bool = False       # drop points of saturated leaves
    debug_validate_dircache: int = 0    # N > 0: re-check the cache every N
    insert_miss_cap: int = 0            # first-seen keys per cached insert

    # --- rendering ---
    max_range: float = 10.0             # meters
    start_dist: float = 0.002
    max_march_iters: int = 96
    accel_level: int = 6                # entry/dist grid level
    use_dense_mips: bool = True         # dense value-mip render cache
    dist_max_skip: int = 15             # empty-space skip radius (cells)
    cone_scale: int = 1                 # cone-trace at (W/s, H/s)
    # slab cone splatter
    cone_slabs: int = 16
    cone_znear: float = 0.25            # nearest slab boundary (meters)
    cone_max_scale: int = 4             # coarsest slab raster decimation
    # hybrid cone renderer
    cone_band_cap: int = 0              # marched band lanes (0 = pixels//4)
    cone_band_iters: int = 12           # march trip cap for band rays
    cone_band_sel_decimate: bool = False
    cone_band_crawl: int = 1            # leaf samples per march trip
    cone_band_depth_prio: float = 0.0
    cone_band_fused_dist: bool = True
    cone_band_compact_after: int = 999
    fov: float = 45.0                   # degrees (vertical)

    # --- relocalization ---
    relocalize: bool = True             # the driver runs loss recovery
    keypose_every: int = 10             # record an anchor every K frames
    reloc_candidates: int = 4           # most-recent keyposes per attempt
    reloc_min_inlier_frac: float = 0.05

    precompile_ahead: bool = True

    # --- host tiering ---
    host_spill: bool = False
    tier_level: int = 3
    spill_keep_radius: float = 12.0     # m
    restore_radius: float = 11.0        # m

    # --- multi-device map sharding ---
    map_split_level: int = 1

    # --- mesh voxelization ---
    vox_log_n: int = 8                  # grid is (1 << vox_log_n)^3 voxels
    vox_tri_budget: int = 512

    @property
    def recovery_enabled(self) -> bool:
        """Relocalization can run: the one condition the driver's recovery
        loop and the step's sticky fusion gate must agree on."""
        return self.relocalize and self.reloc_candidates > 0

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def level_shape(self, level: int) -> Tuple[int, int]:
        """(height, width) of pyramid level `level` (0 = full res)."""
        return (self.height >> level, self.width >> level)


DEFAULT_CONFIG = SLAMConfig()
