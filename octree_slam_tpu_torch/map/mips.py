"""Dense value-mip render cache and empty-space distance field
(counterpart: octree_slam_tpu/map/mips.py).

The acceleration structure of the exact cone march. Instead of descending
the pointer octree at every ray step it keeps:

  * `values`: one flat int32 buffer holding dense Morton-ordered RGBA8 mip
    grids for octree levels 1..max_depth, the mirror of the pool's interior
    and leaf values (same mipmap rule, svo.cu:417-439). Level l starts at
    offset (8^l - 8)/7 and a Morton key prefix is the level-l cell index,
    so a sample at any level of detail is one gather at
      flat_idx = ((1 << 3l) - 8) / 7 + (key >> 3(max_depth - l)).
  * `dist`: a Chebyshev distance-to-occupied field (in cells, saturated at
    `max_skip`) over the level `dist_level` grid, xyz-ordered so that 3-D
    min-pool windows build it. Rays step `dist - 1` cells through empty
    space.

Updates ride the eager insert, which emits (flat_idx, value) pairs
(InsertStats.mip_idx / mip_val); `update` scatters them here, in place.
`rebuild_from_pool` makes the whole mirror from the node pool after lazy
frames.

Memory: sum_{l=1..D} 8^l words of 4 bytes, 613 MB at D=9 and 9.6 MB at D=7
(SLAMConfig.use_dense_mips turns it off). Words are int32 bit patterns, as
everywhere in the port.

`encode_free_dist` stamps the mirror's free leaf cells with their covering
dist cell's distance, in place, for the hybrid renderer's one-gather band
march (render/hybrid.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.utils import compaction


def level_offset(level: int) -> int:
    """Start of the level-`level` grid in the flat values buffer (host)."""
    return ((1 << (3 * level)) - 8) // 7


def total_cells(max_depth: int) -> int:
    return level_offset(max_depth + 1)


def flat_index(keys: torch.Tensor, key_depth: int, level) -> torch.Tensor:
    """Flat values-buffer index of Morton keys of depth `key_depth` sampled
    at `level` (an int or an int32 tensor). Integer math only."""
    if isinstance(level, int):
        return level_offset(level) + (keys >> (3 * (key_depth - level)))
    return level_offsets(level) + (keys >> (3 * (key_depth - level)))


def level_offsets(level: torch.Tensor) -> torch.Tensor:
    """level_offset of every entry of an int32 tensor of levels."""
    return torch.div(torch.bitwise_left_shift(torch.ones_like(level),
                                              3 * level) - 8, 7,
                     rounding_mode="floor")


class RenderCache(NamedTuple):
    """Dense mips + distance field (the SLAMState render acceleration)."""

    values: torch.Tensor  # i32[total_cells(D)] RGBA8, EMPTY_VALUE = untouched
    occ: torch.Tensor     # bool[G^3] xyz-ordered occupancy at dist_level
    dist: torch.Tensor    # i32[G^3] xyz-ordered chebyshev distance in cells


def create(*, max_depth: int, dist_level: int, max_skip: int = 15,
           device="cuda") -> RenderCache:
    g3 = 1 << (3 * dist_level)
    return RenderCache(
        values=torch.full((total_cells(max_depth),), packing.EMPTY_VALUE,
                          dtype=torch.int32, device=device),
        occ=torch.zeros((g3,), dtype=torch.bool, device=device),
        dist=torch.full((g3,), max_skip, dtype=torch.int32, device=device),
    )


def apply_updates(values: torch.Tensor, mip_idx: torch.Tensor,
                  mip_val: torch.Tensor) -> torch.Tensor:
    """Scatter an insert's touched (flat_idx, value) pairs in place.
    Invalid entries carry idx == len(values) and drop."""
    return compaction.scatter_set_(values, mip_idx, mip_val)


def deinterleave3(m: torch.Tensor, bits: int):
    """Inverse of interleave3: Morton code -> (x, y, z) integer coords."""
    x = torch.zeros_like(m)
    y = torch.zeros_like(m)
    z = torch.zeros_like(m)
    for b in range(bits):
        x = x | (((m >> (3 * b)) & 1) << b)
        y = y | (((m >> (3 * b + 1)) & 1) << b)
        z = z | (((m >> (3 * b + 2)) & 1) << b)
    return x, y, z


def interleave3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                bits: int) -> torch.Tensor:
    """Morton code from integer coords: z gets bit 2, y bit 1, x bit 0 per
    level, matching morton.encode's octant = x + 2y + 4z (svo.cu:50-57)."""
    m = torch.zeros_like(x)
    for b in range(bits):
        m = m | (((x >> b) & 1) << (3 * b))
        m = m | (((y >> b) & 1) << (3 * b + 1))
        m = m | (((z >> b) & 1) << (3 * b + 2))
    return m


def update(cache: RenderCache, mip_idx: torch.Tensor, mip_val: torch.Tensor,
           *, max_depth: int, dist_level: int, max_skip: int = 15,
           with_dist: bool = True) -> RenderCache:
    """Per-frame refresh from an insert's (flat_idx, value) pairs: one
    value scatter, one occupancy scatter (xyz-ordered) and, with
    `with_dist`, the distance transform over the new occupancy. Only the
    marchers read `dist`, so other frames pass with_dist=False and leave it
    stale. `values` and `occ` are written in place."""
    g3 = 1 << (3 * dist_level)
    values = apply_updates(cache.values, mip_idx, mip_val)

    lo = level_offset(dist_level)
    hi = level_offset(dist_level + 1)
    in_level = (mip_idx >= lo) & (mip_idx < hi)
    x, y, z = deinterleave3(torch.where(in_level, mip_idx - lo, 0),
                            dist_level)
    xyz = (z << (2 * dist_level)) | (y << dist_level) | x
    occ = compaction.scatter_set_(cache.occ, torch.where(in_level, xyz, g3),
                                  packing.is_occupied(mip_val))
    cache = RenderCache(values=values, occ=occ, dist=cache.dist)
    return (refresh_dist(cache, dist_level=dist_level, max_skip=max_skip)
            if with_dist else cache)


def refresh_dist(cache: RenderCache, *, dist_level: int,
                 max_skip: int = 15) -> RenderCache:
    """Recompute only the distance field from the current occupancy."""
    g = 1 << dist_level
    return cache._replace(
        dist=_dist_from_occ(cache.occ.reshape(g, g, g), max_skip).reshape(-1))


def _dist_from_occ(occ3d: torch.Tensor, max_skip: int) -> torch.Tensor:
    """Log-round Chebyshev distance transform: round j takes the minimum
    over a 3^3 window with dilation 2^j (outside the grid counts as
    `max_skip`) and adds 2^j, which extends exact distances from 2^j - 1
    to 2^(j+1) - 1. The window minimum is separable: one pass of three
    shifted slices per axis."""
    dist = torch.where(occ3d, 0, max_skip).to(torch.int32)
    n = dist.shape
    j = 0
    while (1 << j) <= max_skip:
        w = 1 << j
        pooled = dist
        for axis in range(3):
            pad = [0, 0, 0, 0, 0, 0]
            pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = w
            p = F.pad(pooled, pad, value=max_skip)
            pooled = torch.minimum(
                torch.minimum(p.narrow(axis, 0, n[axis]),
                              p.narrow(axis, 2 * w, n[axis])), pooled)
        dist = torch.minimum(dist, pooled + w)
        j += 1
    return torch.clamp(dist, max=max_skip)


@functools.lru_cache(maxsize=4)
def _morton_to_xyz_perm(level: int) -> np.ndarray:
    """Permutation p with xyz_linear[i] = morton[p[i]] for a 2^level grid
    (a host-side constant)."""
    g = 1 << level
    lin = np.arange(g * g * g, dtype=np.int64)
    x = lin % g
    y = (lin // g) % g
    z = lin // (g * g)
    m = np.zeros_like(lin)
    for b in range(level):
        m |= ((x >> b) & 1) << (3 * b)
        m |= ((y >> b) & 1) << (3 * b + 1)
        m |= ((z >> b) & 1) << (3 * b + 2)
    return m


@functools.lru_cache(maxsize=4)
def _perm_on(level: int, device: str) -> torch.Tensor:
    """_morton_to_xyz_perm on a device, copied there once."""
    return torch.from_numpy(_morton_to_xyz_perm(level)).to(device)


@functools.lru_cache(maxsize=4)
def _xyz_of_morton_perm(level: int) -> np.ndarray:
    """Permutation q with morton_ordered[m] = xyz_linear[q[m]] for a
    2^level grid (a host-side constant)."""
    g = 1 << level
    m = np.arange(g * g * g, dtype=np.int64)
    x = np.zeros_like(m)
    y = np.zeros_like(m)
    z = np.zeros_like(m)
    for b in range(level):
        x |= ((m >> (3 * b)) & 1) << b
        y |= ((m >> (3 * b + 1)) & 1) << b
        z |= ((m >> (3 * b + 2)) & 1) << b
    return z * g * g + y * g + x


@functools.lru_cache(maxsize=4)
def _xyz_perm_on(level: int, device: str) -> torch.Tensor:
    """_xyz_of_morton_perm on a device, copied there once."""
    return torch.from_numpy(_xyz_of_morton_perm(level)).to(device)


def encode_free_dist(cache: RenderCache, *, max_depth: int,
                     dist_level: int) -> RenderCache:
    """Stamp each free leaf cell of the dense mirror with the Chebyshev
    distance of its covering dist cell: the contract of the one-gather band
    march (render/hybrid.py, fused_dist).

    A free cell's word becomes the plain distance (<= max_skip < 256, so it
    lies in the low byte and the alpha byte is 0): every reader of alpha or
    occupancy still sees the cell as unoccupied (alpha 0 against
    EMPTY_VALUE's 127, both <= OCCUPIED_ALPHA), and a renderer weights
    colour by alpha, so the payload is never shown. Occupied cells keep
    their word. Interior levels are never stamped.

    Each dist cell's 8^(max_depth - dist_level) leaves are contiguous in the
    Morton-ordered leaf level, so the stamp is one select over a
    [G^3, per_cell] view of the leaf region, written in place: the region
    is 2^27 words at depth 9, and a copy of it would double the mirror for
    a moment. An int32 word is occupied iff its alpha's top bit is set,
    i.e. iff it is negative, which keeps the only temporary a bool mask.
    Run again whenever `dist` is recomputed; between runs leaf scatters
    touch occupied cells only, so the stamps stay current. Idempotent."""
    lo = level_offset(max_depth)
    per_cell = 1 << (3 * (max_depth - dist_level))
    dist_m = cache.dist[_xyz_perm_on(dist_level, str(cache.dist.device))]
    lv = cache.values[lo:].view(-1, per_cell)
    torch.where(lv < 0, lv, dist_m[:, None], out=lv)
    return cache


def _occ_of_values(values: torch.Tensor, dist_level: int) -> torch.Tensor:
    """xyz-ordered occupancy bool[G^3] of the dense mip at dist_level
    (alpha is a subtree maximum, so alpha > 127 iff the subtree holds an
    occupied leaf)."""
    perm = _perm_on(dist_level, str(values.device))
    return packing.is_occupied(values[level_offset(dist_level) + perm])


def rebuild_from_pool(pool, *, max_depth: int, dist_level: int,
                      max_skip: int = 15) -> RenderCache:
    """The whole dense mirror (values, occupancy, distance field) from the
    node pool: the one-shot companion of the lazy insert. One pass of
    svo.tile_topology gives every allocated node its (level, key), so the
    mirror is one pool-sized scatter at flat = (8^level - 8)/7 + key into a
    fresh buffer."""
    from octree_slam_tpu_torch.map import svo

    dev = pool.value.device
    _, level, tkey = svo.tile_topology(pool, depth=max_depth)
    node_lvl = level.repeat_interleave(8)
    node_key = ((tkey[:, None] << 3)
                | torch.arange(8, dtype=torch.int32, device=dev)).reshape(-1)
    total = total_cells(max_depth)
    flat = torch.where(node_lvl > 0, level_offsets(node_lvl) + node_key,
                       total)
    values = torch.full((total,), packing.EMPTY_VALUE, dtype=torch.int32,
                        device=dev)
    compaction.scatter_set_(values, flat, pool.value)

    g = 1 << dist_level
    occ = _occ_of_values(values, dist_level)
    dist = _dist_from_occ(occ.reshape(g, g, g), max_skip).reshape(-1)
    return RenderCache(values=values, occ=occ, dist=dist)


def rebuild_dist(values: torch.Tensor, *, max_depth: int, dist_level: int,
                 max_skip: int = 7) -> torch.Tensor:
    """Chebyshev distance (cells, saturated at max_skip) to the nearest
    occupied level-`dist_level` cell of a dense mirror, xyz-ordered flat."""
    g = 1 << dist_level
    occ = _occ_of_values(values, dist_level)
    return _dist_from_occ(occ.reshape(g, g, g), max_skip).reshape(-1)
