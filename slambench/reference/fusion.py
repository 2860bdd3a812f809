"""Reference map: every leaf the frames fuse, with its colour word, held in
a dense table indexed by the leaf's Morton key (2^(3 max_depth) int32
words, 512 MiB at depth 9).

The semantics are the program's insert (the reference system's
svoFromPointCloud with its pseudo low-pass blend): a frame's points go to
world space by the frame's pose, each point's leaf is its Morton key at
max_depth in the root cube (points outside clamp into the nearest octant
chain), and each leaf the frame reaches blends once with the mean of its
points' 8-bit colours: rgb = mean (1 - a/256) + old a/256, truncated,
alpha = min(255, a + 2), from an empty word of rgb 0, alpha 127. The
route is independent of the node pool: torch.unique and integer sums.
"""

from __future__ import annotations

import torch

from . import Arith

INVALID_KEY = 0x7FFFFFFF
EMPTY_VALUE = 127 << 24


def encode(points: torch.Tensor, center: torch.Tensor,
           half_size: torch.Tensor, depth: int):
    """Morton keys i32[N] of points f32[N, 3] at `depth` and whether each
    point is finite: octant = (x > cx) + 2 (y > cy) + 4 (z > cz) against
    the running cell centre, most significant level first."""
    n = points.shape[0]
    dev = points.device
    valid = torch.isfinite(points).all(dim=-1)
    p = torch.where(valid[:, None], points, 0.0)
    c = center.expand(n, 3)
    e = torch.as_tensor(half_size, dtype=torch.float32, device=dev)
    key = torch.zeros((n,), dtype=torch.int32, device=dev)
    for _ in range(depth):
        e = e * 0.5
        gt = p > c
        gi = gt.to(torch.int32)
        key = (key << 3) | (gi[:, 0] + 2 * gi[:, 1] + 4 * gi[:, 2])
        c = c + torch.where(gt, e, -e)
    return torch.where(valid, key, INVALID_KEY), valid


def decode_centers(keys: torch.Tensor, center: torch.Tensor,
                   half_size: torch.Tensor, depth: int) -> torch.Tensor:
    """Cell centres f32[N, 3] of keys at `depth`."""
    n = keys.shape[0]
    dev = keys.device
    c = center.expand(n, 3)
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


def unpack(word: torch.Tensor):
    return (word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF,
            (word >> 24) & 0xFF)


def blend(old: torch.Tensor, mean_rgb: torch.Tensor) -> torch.Tensor:
    """The low-pass blend of a leaf word with a mean colour in 0..255."""
    r, g, b, a = unpack(old)
    old_rgb = torch.stack([r, g, b], dim=-1).to(torch.float32)
    f2 = a.to(torch.float32)[..., None] / 256.0
    out = torch.clamp((mean_rgb * (1.0 - f2) + old_rgb * f2).to(torch.int32),
                      0, 255)
    new_a = torch.clamp(a + 2, max=255)
    return out[..., 0] | (out[..., 1] << 8) | (out[..., 2] << 16) \
        | (new_a << 24)


class MapTable:
    """The dense leaf table of one map."""

    def __init__(self, slam: dict, device):
        self.depth = slam["max_depth"]
        # a float32 scalar on the device, as the program's pool holds it:
        # the leaf cell and the march's steps are reckoned from it
        self.half_size = torch.as_tensor(
            slam["voxel_resolution"] * (2 ** (self.depth - 1)),
            dtype=torch.float32).to(device)
        self.center = torch.zeros(3, dtype=torch.float32, device=device)
        self.words = torch.full((1 << (3 * self.depth),), EMPTY_VALUE,
                                dtype=torch.int32, device=device)

    def world_points(self, vertex0: torch.Tensor, pose: torch.Tensor,
                     ar: Arith) -> torch.Tensor:
        """Level-0 camera points to world space, as the step forms them."""
        v = vertex0.reshape(-1, 3)
        return ar.mm(v, pose[:3, :3].T) + pose[:3, 3]

    def fuse(self, world: torch.Tensor, color: torch.Tensor) -> None:
        """Blend one frame's points (world f32[N, 3], colour u8[H, W, 3])
        into the table."""
        keys, valid = encode(world, self.center, self.half_size, self.depth)
        c01 = color.reshape(-1, 3).to(torch.float32) / 255.0
        c8 = torch.clamp(torch.round(c01 * 255.0), 0, 255).to(torch.int64)
        k = keys[valid]
        ukeys, inv = torch.unique(k, return_inverse=True)
        sums = torch.zeros((ukeys.shape[0], 3), dtype=torch.int64,
                           device=k.device)
        sums.index_add_(0, inv, c8[valid])
        cnt = torch.bincount(inv, minlength=ukeys.shape[0])
        mean = sums.to(torch.float32) / torch.clamp(
            cnt.to(torch.float32), min=1.0)[:, None]
        idx = ukeys.to(torch.int64)
        self.words[idx] = blend(self.words[idx], mean)

    def leaves(self):
        """(keys i32[L] ascending, words i32[L]) of every leaf written."""
        keys = torch.nonzero(self.words != EMPTY_VALUE).reshape(-1)
        return keys.to(torch.int32), self.words[keys]
