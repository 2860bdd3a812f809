"""Core tensor types of the slice (counterpart: octree_slam_tpu/core/types.py).

Only `Frame` and `PyramidLevel` are ported; the mesh, camera and voxel-grid
types wait for the slices that use them.
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
