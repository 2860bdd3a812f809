"""Map view by z-resolved splatting of a persistent leaf list (counterpart:
octree_slam_tpu/render/splat.py).

The pipeline keeps a registry of every leaf ever written (insert reports
first-seen leaves; leaf identities are write-once, so appends never
deduplicate) plus a mirror of their current values. A frame decodes the
leaf centres from their Morton keys, projects them, packs
quantized-depth<<16 | RGB565 into one int32 per leaf and resolves
visibility and colour together with one scatter-min, then fills 1-2 pixel
holes with a 3x3 min dilation.

Where the z-buffer is made (`leaf_zbuffer`, by what the call observes): on
a CUDA device it is one launch of the hand-written kernel
splat_ops.splat_zbuffer over the registry's live rows, equal word for word
to the plain version on the card; on the CPU it is the plain version
`splat_zbuffer`, ~160 PyTorch ops over the registry's whole capacity.
`leaf_zbuffer` counts the path it took (`splat_kernel` or `splat_eager`,
one a call) and, on the kernel path while the recorder is on, the live
rows and the rows that issued an atomicMin (`splat_live_rows`,
`splat_atomics`: device counters read at the recorder's stop()).

`leaf_list_from_extraction` rebuilds the registry from an extraction of
the pool (growth after an overflow, tiering, rebuilds across a prealloc
boundary); `pad_leaf_list` pads it to a larger capacity. The registry's
tensors are updated in place by `append_new_leaves` and
`append_new_leaves_cached`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.map.svo import InsertStats, SVONodePool
from octree_slam_tpu_torch.render import splat_ops
from octree_slam_tpu_torch.render.points import (DEPTH_INF, pack_rgb565,
                                                 unpack_rgb565)
from octree_slam_tpu_torch.utils import spans
from octree_slam_tpu_torch.utils.compaction import scatter_set_

EMPTY = DEPTH_INF  # no-hit sentinel: sorts after every packed depth word


class LeafList(NamedTuple):
    """Persistent append-only registry of written leaf voxels."""

    keys: torch.Tensor      # i32[LC] morton keys at map depth, -1 = free
    nodes: torch.Tensor     # i32[LC] node-pool indices
    vals: torch.Tensor      # i32[LC] current packed leaf values
    node2pos: torch.Tensor  # i32[node_capacity] node -> registry position
    count: torch.Tensor     # i32[]
    overflowed: torch.Tensor  # bool[]


def create_leaf_list(capacity: int, node_capacity: int,
                     device="cuda") -> LeafList:
    i32 = dict(dtype=torch.int32, device=device)
    return LeafList(
        keys=torch.full((capacity,), -1, **i32),
        nodes=torch.zeros((capacity,), **i32),
        vals=torch.zeros((capacity,), **i32),
        node2pos=torch.full((node_capacity,), -1, **i32),
        count=torch.zeros((), **i32),
        overflowed=torch.tensor(False, device=device),
    )


def leaf_list_from_extraction(ex, pool_value: torch.Tensor, *,
                              node_capacity: int) -> LeafList:
    """A whole registry from an svo.extract_all_leaves result, for when node
    indices changed or appends were dropped: the append-only registry is
    rebuilt from the pool itself."""
    capacity = ex.keys.shape[0]
    live = ex.nodes >= 0
    nodes = torch.where(live, ex.nodes, 0)
    node2pos = torch.full((node_capacity,), -1, dtype=torch.int32,
                          device=nodes.device)
    scatter_set_(node2pos, torch.where(live, nodes, node_capacity),
                 torch.arange(capacity, dtype=torch.int32,
                              device=nodes.device))
    return LeafList(keys=ex.keys, nodes=nodes,
                    vals=torch.where(live, pool_value[nodes], 0),
                    node2pos=node2pos, count=ex.count,
                    overflowed=ex.count >= capacity)


def pad_leaf_list(leaves: LeafList, capacity: int,
                  node_capacity: int) -> LeafList:
    """The registry at a larger leaf and node capacity (growth): free rows
    and node2pos entries appended, content kept."""
    lc_pad = capacity - leaves.keys.shape[0]
    nc_pad = node_capacity - leaves.node2pos.shape[0]
    if not (lc_pad or nc_pad):
        return leaves
    return leaves._replace(
        keys=torch.cat([leaves.keys, leaves.keys.new_full((lc_pad,), -1)]),
        nodes=torch.cat([leaves.nodes, leaves.nodes.new_zeros((lc_pad,))]),
        vals=torch.cat([leaves.vals, leaves.vals.new_zeros((lc_pad,))]),
        node2pos=torch.cat([leaves.node2pos,
                            leaves.node2pos.new_full((nc_pad,), -1)]))


def append_new_leaves(leaves: LeafList, stats: InsertStats) -> LeafList:
    """Append this insert's first-seen leaves at the cursor and refresh the
    value mirror of every leaf it touched."""
    return append_new_leaves_cached(leaves, stats)[0]


def append_new_leaves_cached(leaves: LeafList, stats: InsertStats):
    """append_new_leaves with the directory cache's contract: a row whose
    registry position is known already (stats.hit_aux, carried through
    svo.insert's dir_aux) keeps it, every other touched row reads
    node2pos. Returns (leaves, tpos): tpos i32[U] is every touched row's
    registry position, -1 where the row was not touched or was dropped,
    which the pipeline keeps as the next frame's dir_pos. The reference
    gathers node2pos on static miss lanes and falls back to a full-width
    gather when they overflow; both give this tpos while the directory is
    current, and here the one gather serves both."""
    lc = leaves.keys.shape[0]
    nc = leaves.node2pos.shape[0]
    u = stats.new_leaf_keys.shape[0]
    rows = torch.arange(u, dtype=torch.int32, device=leaves.keys.device)
    pos = leaves.count + rows
    ok = (rows < stats.new_leaf_count) & (pos < lc)
    idx = torch.where(ok, pos, lc)
    scatter_set_(leaves.keys, idx, stats.new_leaf_keys)
    scatter_set_(leaves.nodes, idx, stats.new_leaf_nodes)
    scatter_set_(leaves.node2pos, torch.where(ok, stats.new_leaf_nodes, nc),
                 pos)

    tn = stats.touched_leaf_nodes
    tpos = torch.where(stats.hit_aux >= 0, stats.hit_aux,
                       leaves.node2pos[torch.clamp(tn, 0, nc - 1)])
    t_ok = (tn >= 0) & (tn < nc) & (tpos >= 0)
    scatter_set_(leaves.vals, torch.where(t_ok, tpos, lc),
                 stats.touched_leaf_vals)

    total = leaves.count + stats.new_leaf_count
    return leaves._replace(count=torch.clamp(total, max=lc),
                           overflowed=leaves.overflowed | (total > lc)), \
        torch.where(t_ok, tpos, -1)


def splat_zbuffer(vals: torch.Tensor, keys: torch.Tensor, live: torch.Tensor,
                  center: torch.Tensor, half_size, world_T_cam: torch.Tensor,
                  fx, fy, *, width: int, height: int, depth: int,
                  max_range: float = 10.0) -> torch.Tensor:
    """Project a leaf set into a packed z-buffer: i32[H*W] words of
    quantized-depth<<16 | RGB565, EMPTY where nothing landed."""
    keys = torch.where(live, keys, 0)
    centers = morton.decode_centers(keys, center, half_size, depth)

    r, g, b, _ = packing.unpack_rgba8(vals)
    occupied = live & packing.is_occupied(vals)

    # world -> camera (camera looks down +z; pinhole as the sensor model,
    # image_kernels.cu:49-51)
    R = world_T_cam[:3, :3]
    t = world_T_cam[:3, 3]
    cam = (centers - t) @ R  # == R^T (p - t) row-wise
    z = cam[:, 2]
    in_front = occupied & (z > 1e-3) & (z < max_range)
    zs = torch.where(in_front, z, 1.0)
    px = torch.round(fx * cam[:, 0] / zs + width / 2.0).to(torch.int32)
    py = torch.round(height / 2.0 - fy * cam[:, 1] / zs).to(torch.int32)
    inb = in_front & (px >= 0) & (px < width) & (py >= 0) & (py < height)

    qz = torch.clamp(z * (32766.0 / max_range), 0, 32766).to(torch.int32)
    word = (qz << 16) | pack_rgb565(r, g, b)  # 15+16 bits, sign-safe
    num_pix = width * height
    idx = torch.where(inb, py * width + px, num_pix)
    # one guard slot past the image takes every dropped leaf
    buf = torch.full((num_pix + 1,), EMPTY, dtype=torch.int32,
                     device=vals.device)
    buf.scatter_reduce_(0, idx.to(torch.int64),
                        torch.where(inb, word, EMPTY), reduce="amin")
    return buf[:num_pix]


def _splat_kernel(device: torch.device) -> bool:
    """The z-buffer is made by splat_ops' CUDA kernel: on a CUDA device.
    The CPU runs the plain version."""
    return device.type == "cuda"


def leaf_zbuffer(vals: torch.Tensor, keys: torch.Tensor, count,
                 center: torch.Tensor, half_size, world_T_cam: torch.Tensor,
                 fx, fy, *, width: int, height: int, depth: int,
                 max_range: float = 10.0) -> torch.Tensor:
    """splat_zbuffer of a registry's rows [0, count) whose key is >= 0:
    count is the registry's i32[] counter, or None for every row (a shard's
    registry, whose free rows hold -1)."""
    dev = keys.device
    if _splat_kernel(dev):
        spans.count("splat_kernel")
        stats = spans.recording()
        buf, counts = splat_ops.splat_zbuffer(
            vals, keys, count, center,
            torch.as_tensor(half_size, dtype=torch.float32, device=dev),
            world_T_cam, fx, fy, width=width, height=height, depth=depth,
            max_range=max_range, count_stats=stats)
        if stats:
            spans.count_device("splat_live_rows", counts[0])
            spans.count_device("splat_atomics", counts[1])
        return buf
    spans.count("splat_eager")
    live = keys >= 0
    if count is not None:
        live &= torch.arange(keys.shape[0], device=dev) < count
    return splat_zbuffer(vals, keys, live, center, half_size, world_T_cam,
                         fx, fy, width=width, height=height, depth=depth,
                         max_range=max_range)


def dilate_zbuffer(buf: torch.Tensor, *, width: int, height: int,
                   rounds: int = 2) -> torch.Tensor:
    """Image-space hole filling: EMPTY pixels take the min (= nearest)
    packed word of their 3x3 neighbourhood, `rounds` times; outside the
    image counts as EMPTY. buf is [..., H*W]; returns [..., H, W]."""
    img = buf.reshape(buf.shape[:-1] + (height, width))
    for _ in range(rounds):
        pad = F.pad(img, (1, 1, 1, 1), value=EMPTY)
        best = img
        for dy in range(3):
            for dx in range(3):
                best = torch.minimum(
                    best, pad[..., dy:dy + height, dx:dx + width])
        img = torch.where(img == EMPTY, best, img)
    return img


def finish_zbuffer(buf: torch.Tensor, *, width: int, height: int,
                   dilate: int = 2) -> torch.Tensor:
    """Packed z-buffer -> f32[H, W, 4] framebuffer with hole dilation."""
    img = dilate_zbuffer(buf, width=width, height=height, rounds=dilate)
    hit = img != EMPTY
    rr, gg, bb = unpack_rgb565(torch.where(hit, img, 0) & 0xFFFF)
    rgb = torch.stack([rr, gg, bb], dim=-1).to(torch.float32) / 255.0
    a = hit.to(torch.float32)
    return torch.cat([rgb * a[..., None], a[..., None]], dim=-1)


def render_splat(pool: SVONodePool, leaves: LeafList,
                 world_T_cam: torch.Tensor, fx, fy, *, width: int,
                 height: int, depth: int, max_range: float = 10.0,
                 dilate: int = 2) -> torch.Tensor:
    """Render occupied leaf voxels to f32[height, width, 4]."""
    buf = leaf_zbuffer(leaves.vals, leaves.keys, leaves.count, pool.center,
                       pool.half_size, world_T_cam, fx, fy, width=width,
                       height=height, depth=depth, max_range=max_range)
    return finish_zbuffer(buf, width=width, height=height, dilate=dilate)
