"""Core tensor types of the slice (counterpart: octree_slam_tpu/core/types.py).

`Frame`, `PyramidLevel`, `BoundingBox` and `VoxelGrid` are ported; the
mesh, camera and texture types wait for the offline paths that use them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Frame(NamedTuple):
    """Raw sensor frame (RawFrame, common_types.h).

    depth holds u16 millimetres as int32 (torch has no full uint16
    arithmetic); color is uint8 RGB."""

    depth: torch.Tensor      # i32[H, W] millimetres, 0 = no return
    color: torch.Tensor      # u8[H, W, 3]
    timestamp: torch.Tensor  # f32[] seconds


class PyramidLevel(NamedTuple):
    """Per-level ICP data (localization_kernels.h:17-33)."""

    vertex: torch.Tensor     # f32[h, w, 3] camera-frame points (INF invalid)
    normal: torch.Tensor     # f32[h, w, 3] unit normals (INF invalid)
    intensity: torch.Tensor  # f32[h, w]


class BoundingBox(NamedTuple):
    """Axis-aligned box (common_types.h:8-14: bbox0 = min, bbox1 = max)."""

    bbox0: torch.Tensor  # f32[3] min corner
    bbox1: torch.Tensor  # f32[3] max corner


class VoxelGrid(NamedTuple):
    """Compacted occupied-voxel list (common_types.h VoxelGrid), padded to
    a static capacity with `count` live rows."""

    centers: torch.Tensor  # f32[cap, 3]
    colors: torch.Tensor   # f32[cap, 4] rgba in [0, 1]
    count: torch.Tensor    # i32[]
    scale: torch.Tensor    # f32[] half voxel edge (voxelization.cu:78-80)
    bbox: BoundingBox
