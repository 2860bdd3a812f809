"""Core tensor types (counterpart: octree_slam_tpu/core/types.py), the
POD structs of include/octree_slam/common_types.h:8-79 as NamedTuples of
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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

    def contains(self, other: "BoundingBox") -> torch.Tensor:
        """True if `other` lies wholly inside self (common_types.cu:8-18)."""
        return (torch.all(other.bbox0 >= self.bbox0)
                & torch.all(other.bbox1 <= self.bbox1))

    def distance_outside(self, other: "BoundingBox") -> torch.Tensor:
        """The largest distance, over the axes, by which `other` pokes out
        of self (common_types.cu:20-34)."""
        lo = torch.clamp(self.bbox0 - other.bbox0, min=0.0)
        hi = torch.clamp(other.bbox1 - self.bbox1, min=0.0)
        return torch.max(torch.maximum(lo, hi))

    @property
    def center(self) -> torch.Tensor:
        return 0.5 * (self.bbox0 + self.bbox1)


def bbox_of_points(points: torch.Tensor,
                   valid: torch.Tensor | None = None) -> BoundingBox:
    """Bounding box of a point cloud f32[N, 3], non-finite points (and
    those `valid` rules out) ignored; the min / max reductions of
    image_kernels.cu:60-102."""
    finite = torch.isfinite(points).all(dim=-1)
    if valid is not None:
        finite = finite & valid
    big = 3.0e38
    lo = torch.where(finite[:, None], points, big).amin(dim=0)
    hi = torch.where(finite[:, None], points, -big).amax(dim=0)
    return BoundingBox(bbox0=lo, bbox1=hi)


class Camera(NamedTuple):
    """Camera matrices (common_types.h Camera)."""

    model: torch.Tensor       # f32[4, 4]
    view: torch.Tensor        # f32[4, 4]
    projection: torch.Tensor  # f32[4, 4]
    fov: torch.Tensor         # f32[] vertical field of view, degrees

    @property
    def modelview(self) -> torch.Tensor:
        return self.view @ self.model

    @property
    def mvp(self) -> torch.Tensor:
        return self.projection @ self.modelview


class VoxelGrid(NamedTuple):
    """Compacted occupied-voxel list (common_types.h VoxelGrid), padded to
    a static capacity with `count` live rows."""

    centers: torch.Tensor  # f32[cap, 3]
    colors: torch.Tensor   # f32[cap, 4] rgba in [0, 1]
    count: torch.Tensor    # i32[]
    scale: torch.Tensor    # f32[] half voxel edge (voxelization.cu:78-80)
    bbox: BoundingBox


class Mesh(NamedTuple):
    """Triangle mesh (common_types.h Mesh: vbo / nbo / cbo / ibo / tbo and
    its box)."""

    vertices: torch.Tensor   # f32[V, 3]
    normals: torch.Tensor    # f32[V, 3]
    colors: torch.Tensor     # f32[V, 3]
    faces: torch.Tensor      # i32[F, 3]
    texcoords: torch.Tensor  # f32[F, 3, 2] per-corner uv (the tbo layout)
    bbox: BoundingBox

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


class Texture(NamedTuple):
    """RGB texture (bmp_texture, common_types.h)."""

    data: torch.Tensor  # f32[h, w, 3] in [0, 1]


def make_empty_mesh(device="cuda") -> Mesh:
    z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
    zero = torch.zeros(3, dtype=torch.float32, device=device)
    return Mesh(vertices=z3, normals=z3, colors=z3,
                faces=torch.zeros((0, 3), dtype=torch.int32, device=device),
                texcoords=torch.zeros((0, 3, 2), dtype=torch.float32,
                                      device=device),
                bbox=BoundingBox(zero, zero.clone()))


def np_bbox(lo, hi, device="cuda") -> BoundingBox:
    """A box from two host corners."""
    return BoundingBox(
        bbox0=torch.as_tensor(np.asarray(lo, np.float32), device=device),
        bbox1=torch.as_tensor(np.asarray(hi, np.float32), device=device))
