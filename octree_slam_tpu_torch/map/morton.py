"""Morton (octree) key encoding/decoding (counterpart:
octree_slam_tpu/map/morton.py).

A key of static depth D is D octant triples, most significant level first,
octant = (x > cx) + 2*(y > cy) + 4*(z > cz) against the running cell centre
(computeKey, svo.cu:34-66). Keys are plain int32 (depth <= 10).
"""

from __future__ import annotations

from typing import Tuple

import torch

# Sentinel for invalid points: sorts after every real key (max int32).
INVALID_KEY = 0x7FFFFFFF


def encode(points: torch.Tensor, center: torch.Tensor, half_size,
           depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Morton keys of points f32[N, 3] at a static depth.

    Returns (keys i32[N], valid bool[N]). Non-finite points get
    INVALID_KEY (svo.cu:37-40); out-of-volume points clamp into the
    nearest octant chain, like the reference's unbounded octant test."""
    n = points.shape[0]
    dev = points.device
    valid = torch.isfinite(points).all(dim=-1)
    p = torch.where(valid[:, None], points, 0.0)
    c = torch.as_tensor(center, dtype=torch.float32, device=dev).expand(n, 3)
    e = torch.as_tensor(half_size, dtype=torch.float32, device=dev)
    key = torch.zeros((n,), dtype=torch.int32, device=dev)
    for _ in range(depth):
        e = e * 0.5
        gt = p > c
        gi = gt.to(torch.int32)
        octant = gi[:, 0] + 2 * gi[:, 1] + 4 * gi[:, 2]
        key = (key << 3) | octant
        c = c + torch.where(gt, e, -e)
    key = torch.where(valid, key, INVALID_KEY)
    return key, valid


def decode_centers(keys: torch.Tensor, center: torch.Tensor, half_size,
                   depth: int) -> torch.Tensor:
    """Cell centres f32[N, 3] for keys of static depth (voxelGridFromKeys
    walk, svo.cu:553-571)."""
    n = keys.shape[0]
    dev = keys.device
    c = torch.as_tensor(center, dtype=torch.float32, device=dev).expand(n, 3)
    e = torch.as_tensor(half_size, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for level in range(depth):
        octant = (keys >> (3 * (depth - 1 - level))) & 7
        sx = torch.where((octant & 1) > 0, one, -one)
        sy = torch.where((octant & 2) > 0, one, -one)
        sz = torch.where((octant & 4) > 0, one, -one)
        e = e * 0.5
        c = c + e * torch.stack([sx, sy, sz], dim=-1)
    return c


def level_prefix(keys: torch.Tensor, depth: int, level: int) -> torch.Tensor:
    """Key prefix identifying the ancestor node at `level` (1..depth)."""
    return keys >> (3 * (depth - level))


def octant_at(keys: torch.Tensor, depth: int, level: int) -> torch.Tensor:
    """Octant digit consumed when descending from level-1 to `level`."""
    return (keys >> (3 * (depth - level))) & 7
