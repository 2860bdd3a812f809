"""Triangle-mesh voxelization (counterpart: octree_slam_tpu/map/voxelization.py).

The reference replaces VoxelPipe (coarse tile binning, radix sort, per-tile
fine raster) with a data-parallel scatter: every triangle enumerates a
static budget of candidate voxels from its voxel-space box, each candidate
takes the 6-separating (THIN, the app's default) or 26-separating
(CONSERVATIVE) triangle/box test, and the fragments that pass scatter their
packed colour into a dense grid by max; occupied cells are compacted by a
prefix sum. The port keeps that design and its results word for word:

  * the candidates of a triangle are the reference's, in its order; the
    port enumerates them for a chunk of triangles at a time
    (utils/compaction.CHUNK_LANES candidates), which bounds the memory on
    the card (100k triangles at a budget of 512 are 51M lanes) and changes
    nothing: the scatter-max does not depend on order, and the A-buffer
    concatenates its chunks' fragments in triangle order before its stable
    sort;
  * the sums and products that decide a voxel's hit and its texel are
    evaluated as XLA fuses them (utils/fma.py);
  * grid words are int32 bit patterns of the reference's uint32: every
    fragment word has alpha 127, so bit 31 is 0 and the signed max picks
    the word the unsigned max does.

Grid semantics (the wrapper's, voxelization.cu:59-80,135,155): per-axis
cell = (bbox1 - bbox0) / N, centres at bbox0 + (i + 0.5) * cell, scale =
x-extent / N / 2, alpha 127 written, a cell occupied iff alpha > 0. Grids
are indexed [z, y, x].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.core.types import BoundingBox, Mesh, Texture, \
    VoxelGrid
from octree_slam_tpu_torch.utils import compaction
from octree_slam_tpu_torch.utils.fma import dot3, fma32, fms32

# the written alpha of a fragment (ColorShader, voxelization.cu:135)
FRAGMENT_ALPHA = 127
# the colour of an untextured mesh's fragments
DEFAULT_TEXEL = (0.0, 1.0, 0.0)


class TriangleSoup(NamedTuple):
    """Flat per-triangle arrays ready for the voxelizer."""

    v0: torch.Tensor     # f32[T, 3]
    v1: torch.Tensor     # f32[T, 3]
    v2: torch.Tensor     # f32[T, 3]
    uv: torch.Tensor     # f32[T, 3, 2] per-corner texcoords
    valid: torch.Tensor  # bool[T]


def _candidate_dims(a, b, c, lo, cell):
    """Voxel-space box extent of triangles (a, b, c) [..., 3], as
    floor((t - lo) / cell), the kernel's own expression (a different
    rounding path could under-estimate a box)."""
    tmin = np.minimum(np.minimum(a, b), c)
    tmax = np.maximum(np.maximum(a, b), c)
    return (np.floor((tmax - lo) / cell).astype(np.int64)
            - np.floor((tmin - lo) / cell).astype(np.int64) + 1)


def _bisect(tri, lo, cell, n, tri_budget):
    """The reference's subdivision of one over-budget triangle: a stack,
    each entry split at its longest edge until its box fits the budget.
    Returns the pieces in the reference's order."""
    tris = [tri]
    out = []
    while tris:
        a, b, c, ua, ub, uc = tris.pop()
        dims = _candidate_dims(a, b, c, lo, cell)
        if int(np.prod(np.clip(dims, 1, n))) <= tri_budget:
            out.append((a, b, c, ua, ub, uc))
            continue
        e = [np.linalg.norm(b - a), np.linalg.norm(c - b),
             np.linalg.norm(a - c)]
        k = int(np.argmax(e))
        if k == 0:
            m, um = (a + b) / 2, (ua + ub) / 2
            tris.append((a, m, c, ua, um, uc))
            tris.append((m, b, c, um, ub, uc))
        elif k == 1:
            m, um = (b + c) / 2, (ub + uc) / 2
            tris.append((a, b, m, ua, ub, um))
            tris.append((a, m, c, ua, um, uc))
        else:
            m, um = (c + a) / 2, (uc + ua) / 2
            tris.append((a, b, m, ua, ub, um))
            tris.append((m, b, c, um, ub, uc))
    return out


def prepare_mesh(mesh: Mesh, bbox: BoundingBox, log_n: int,
                 tri_budget: int, pad_to: int | None = None,
                 device=None) -> TriangleSoup:
    """Host preprocessing, once per mesh: gather the triangles' corners and
    bisect each triangle whose voxel-space box exceeds the candidate
    budget. The reference works a stack from the last triangle to the
    first; the triangles that fit are gathered at once here, and only the
    others go through its loop, so the soup comes out in the same order.
    The soup goes to `device` (default: the mesh's)."""
    device = mesh.vertices.device if device is None else device
    verts = mesh.vertices.detach().cpu().numpy().astype(np.float32)
    faces = mesh.faces.detach().cpu().numpy().astype(np.int64)
    uv = mesh.texcoords.detach().cpu().numpy().astype(np.float32)
    if uv.size == 0:
        uv = np.zeros((faces.shape[0], 3, 2), np.float32)
    n = 1 << log_n
    lo = bbox.bbox0.detach().cpu().numpy().astype(np.float32)
    hi = bbox.bbox1.detach().cpu().numpy().astype(np.float32)
    cell = np.maximum((hi - lo) / n, 1e-12)

    a, b, c = (verts[faces[:, j]] for j in range(3))
    dims = _candidate_dims(a, b, c, lo, cell)
    fits = np.prod(np.clip(dims, 1, n), axis=-1) <= tri_budget
    parts = []
    prev = faces.shape[0]

    def whole(rows):
        parts.append((a[rows], b[rows], c[rows], uv[rows]))

    for i in np.flatnonzero(~fits)[::-1]:
        whole(np.arange(prev - 1, i, -1))
        pieces = _bisect((a[i], b[i], c[i], uv[i, 0], uv[i, 1], uv[i, 2]),
                         lo, cell, n, tri_budget)
        parts.append(tuple(np.stack([p[j] for p in pieces]) for j in range(3))
                     + (np.stack([np.stack(p[3:]) for p in pieces]),))
        prev = i
    whole(np.arange(prev - 1, -1, -1))

    v0, v1, v2, uvs = (np.concatenate([p[j] for p in parts]).astype(
        np.float32) for j in range(4))
    t = v0.shape[0]
    size = pad_to if pad_to is not None else t
    assert size >= t, f"pad_to={size} < {t} triangles after subdivision"
    pad = size - t

    def dev(x, fill_shape):
        x = np.concatenate([x, np.zeros((pad,) + fill_shape, x.dtype)])
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    valid = np.arange(size) < t
    return TriangleSoup(v0=dev(v0, (3,)), v1=dev(v1, (3,)),
                        v2=dev(v2, (3,)), uv=dev(uvs, (3, 2)),
                        valid=torch.from_numpy(valid).to(device))


def _edge_ok(c, p0, p1, u, v, sgn, half):
    """2D edge function with the box's conservative offset in the (u, v)
    projection; c is (cx, cy, cz) [T, B], p0 / p1 [T, 3], u / v i64[T]
    (or ints), sgn f32[T]."""
    e = p1 - p0
    ne_u = (-_comp(e, v)) * sgn
    ne_v = _comp(e, u) * sgn
    ofs = fma32(ne_u.abs(), half[u], ne_v.abs() * half[v])
    cu = _comp(c, u) - _comp(p0, u)[:, None]
    cv = _comp(c, v) - _comp(p0, v)[:, None]
    d = fma32(cu, ne_u[:, None], cv * ne_v[:, None])
    return d + ofs[:, None] >= -1e-7


def _comp(x, i):
    """Component i of per-triangle vectors [T, 3] or of lane components
    (cx, cy, cz) [T, B]; i an int or, per triangle, i64[T]."""
    if isinstance(i, int):
        return x[i] if isinstance(x, tuple) else x[:, i]
    if isinstance(x, tuple):
        k = i[:, None]
        return torch.where(k == 0, x[0], torch.where(k == 1, x[1], x[2]))
    return x.gather(1, i[:, None]).squeeze(1)


def _plane_dist(c, a, n_hat):
    """|(c - a) . n_hat| per lane, as a fused chain."""
    rel = torch.stack([c[j] - a[:, j:j + 1] for j in range(3)], -1)
    return dot3(rel, n_hat[:, None, :]).abs()


def _tri_box_overlap_thin(c, half, a, b, cc, n_hat):
    """6-separating triangle/voxel overlap (THIN_RASTER, voxelpipe
    common.h:78-82): the plane within the thin criterion and the 2D
    footprint overlap in the dominant-axis projection. c = (cx, cy, cz)
    [T, B] voxel centres; half f32[3]; a / b / cc / n_hat [T, 3]."""
    dist = _plane_dist(c, a, n_hat)
    thin = (n_hat.abs() * half).amax(dim=-1)
    plane_ok = dist <= (thin + 1e-7)[:, None]

    # dominant axis; (u, v) is the CYCLIC pair ((k+1)%3, (k+2)%3), so the
    # 2D cross product in (u, v) order has the sign of n_hat[dom]
    dom = n_hat.abs().argmax(dim=-1)
    u = (dom + 1) % 3
    v = (dom + 2) % 3
    sgn = torch.sign(_comp(n_hat, dom))
    sgn = torch.where(sgn == 0, 1.0, sgn)
    return (plane_ok & _edge_ok(c, a, b, u, v, sgn, half)
            & _edge_ok(c, b, cc, u, v, sgn, half)
            & _edge_ok(c, cc, a, u, v, sgn, half))


def _tri_box_overlap_conservative(c, half, a, b, cc, n_hat):
    """26-separating triangle/voxel overlap (CONSERVATIVE_RASTER): the
    plane cuts the box (offset sum_k |n_k| h_k) and the 2D edge tests pass
    in all three axis projections (the 9 edge-cross separating axes)."""
    dist = _plane_dist(c, a, n_hat)
    reach = dot3(n_hat.abs(), half.expand_as(n_hat))
    ok = dist <= (reach + 1e-7)[:, None]
    for u, v, k in ((1, 2, 0), (2, 0, 1), (0, 1, 2)):
        sgn = torch.where(n_hat[:, k] >= 0, 1.0, -1.0)
        for p0, p1 in ((a, b), (b, cc), (cc, a)):
            ok = ok & _edge_ok(c, p0, p1, u, v, sgn, half)
    return ok


def _cross(x, y):
    """jnp.cross of [T, 3] rows as XLA fuses it."""
    return torch.stack([fms32(x[:, 1], y[:, 2], x[:, 2], y[:, 1]),
                        fms32(x[:, 2], y[:, 0], x[:, 0], y[:, 2]),
                        fms32(x[:, 0], y[:, 1], x[:, 1], y[:, 0])], -1)


def _barycentric(p, a, b, c):
    """Barycentric weights (w0, w1, w2) [T, B] of the lanes' points p =
    (px, py, pz) projected onto the plane of triangle (a, b, c) [T, 3],
    clipped to [0, 1]."""
    ab = (b - a)[:, None, :]
    ac = (c - a)[:, None, :]
    ap = torch.stack([p[j] - a[:, j:j + 1] for j in range(3)], -1)
    d00 = dot3(ab, ab)
    d01 = dot3(ab, ac)
    d11 = dot3(ac, ac)
    d20 = dot3(ap, ab)
    d21 = dot3(ap, ac)
    denom = fms32(d00, d11, d01, d01)
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    w1 = fms32(d11, d20, d01, d21) / denom
    w2 = fms32(d00, d21, d01, d20) / denom
    w0 = 1.0 - w1 - w2
    return [w.clamp(0.0, 1.0) for w in (w0, w1, w2)]


def _tri_fragments(v0, v1, v2, valid, lo, cell, half, n: int,
                   tri_budget: int, conservative: bool):
    """Candidate enumeration and overlap for triangles [T, 3]: each walks
    its voxel-space box up to tri_budget cells, x fastest. Returns (flat
    i32[T, B], hit bool[T, B], centres (cx, cy, cz) [T, B])."""
    dev = v0.device
    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    # clamped before the cast: XLA's float -> int32 convert saturates
    i_lo = torch.floor((tmin - lo) / cell).clamp(0, n - 1).to(torch.int32)
    i_hi = torch.floor((tmax - lo) / cell).clamp(0, n - 1).to(torch.int32)
    dims = i_hi - i_lo + 1

    k = torch.arange(tri_budget, dtype=torch.int32, device=dev)
    dx, dy, dz = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
    kx = k % dx
    ky = (k // dx) % dy
    kz = k // (dx * dy)
    in_budget = k < dx * dy * dz
    ix = i_lo[:, 0:1] + kx
    iy = i_lo[:, 1:2] + ky
    iz = i_lo[:, 2:3] + kz
    c = tuple(fma32(i.to(torch.float32) + 0.5, cell[j], lo[j])
              for j, i in enumerate((ix, iy, iz)))

    nrm = _cross(v1 - v0, v2 - v0)
    nl = torch.sqrt(dot3(nrm, nrm))
    n_hat = nrm / torch.where(nl < 1e-12, 1.0, nl)[:, None]
    overlap = (_tri_box_overlap_conservative if conservative
               else _tri_box_overlap_thin)
    hit = ((valid & (nl > 1e-12))[:, None] & in_budget
           & overlap(c, half, v0, v1, v2, n_hat))
    flat = (iz * n + iy) * n + ix
    return flat, hit, c


def _grid_params(bbox_lo, bbox_hi, n):
    cell = torch.clamp((bbox_hi - bbox_lo) / n, min=1e-12)
    return bbox_lo, cell, cell * 0.5


def voxelize(soup: TriangleSoup, texture: torch.Tensor,
             bbox_lo: torch.Tensor, bbox_hi: torch.Tensor, *, log_n: int,
             tri_budget: int, conservative: bool = False) -> torch.Tensor:
    """Rasterize triangles into a dense grid of packed RGBA8 words,
    i32[N, N, N] indexed [z, y, x], 0 where empty. texture f32[th, tw, 3]
    (a 1x1 texel for an untextured mesh). Colliding fragments resolve by
    the largest word (the reference's deterministic rule; VoxelPipe's
    NO_BLENDING winner depends on scheduling). conservative selects the
    26-separating test."""
    n = 1 << log_n
    n3 = n * n * n
    lo, cell, half = _grid_params(bbox_lo, bbox_hi, n)
    th, tw = texture.shape[0], texture.shape[1]
    # the last word takes every dropped lane and is cut off at the end
    grid = torch.zeros((n3 + 1,), dtype=torch.int32, device=soup.v0.device)
    for s, e in compaction.chunks(soup.v0.shape[0], tri_budget):
        v0, v1, v2 = soup.v0[s:e], soup.v1[s:e], soup.v2[s:e]
        flat, hit, c = _tri_fragments(v0, v1, v2, soup.valid[s:e], lo, cell,
                                      half, n, tri_budget, conservative)
        w = _barycentric(c, v0, v1, v2)
        uv = soup.uv[s:e]
        uvp = [fma32(w[2], uv[:, None, 2, j],
                     fma32(w[1], uv[:, None, 1, j], w[0] * uv[:, None, 0, j]))
               for j in range(2)]
        tx = (uvp[0] * tw).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(
            torch.int32).clamp(0, tw - 1)
        ty = (uvp[1] * th).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(
            torch.int32).clamp(0, th - 1)
        rgb = (texture[ty.long(), tx.long()] * 255).to(torch.int32)
        val = packing.pack_rgba8(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                                 torch.full_like(tx, FRAGMENT_ALPHA))
        idx = torch.where(hit, flat, n3)
        grid.scatter_reduce_(0, idx.reshape(-1).long(),
                             torch.where(hit, val, 0).reshape(-1),
                             reduce="amax")
    return grid[:n3].reshape(n, n, n)


class ABuffer(NamedTuple):
    """Fragment-list voxelization (VoxelPipe's A-buffer mode,
    voxelpipe.h:151-213): one record per overlapping (triangle, voxel)
    pair, sorted by voxel id."""

    frag_voxel: torch.Tensor  # i32[cap] flat voxel id (z*N + y)*N + x,
                              # ascending; N^3 past `count`
    frag_tri: torch.Tensor    # i32[cap] emitting triangle (soup order),
                              # ascending within a voxel's run
    count: torch.Tensor       # i32[] valid fragments
    overflowed: torch.Tensor  # bool[] fragments past `capacity` dropped


def voxelize_abuffer(soup: TriangleSoup, bbox_lo: torch.Tensor,
                     bbox_hi: torch.Tensor, *, log_n: int, tri_budget: int,
                     capacity: int, conservative: bool = False) -> ABuffer:
    """Emit every overlapping (triangle, voxel) pair (ABufferContext::run,
    voxelpipe.h:179-196): the candidates and tests of `voxelize`, the hits
    compacted in triangle-major order into `capacity` rows (each chunk's
    hits after the earlier chunks', so the order is the unchunked one),
    then a stable sort by voxel id, which leaves each voxel's fragments in
    ascending triangle order. No host read."""
    n = 1 << log_n
    n3 = n * n * n
    dev = soup.v0.device
    lo, cell, half = _grid_params(bbox_lo, bbox_hi, n)
    vox = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    tri = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for s, e in compaction.chunks(soup.v0.shape[0], tri_budget):
        flat, hit, _ = _tri_fragments(
            soup.v0[s:e], soup.v1[s:e], soup.v2[s:e], soup.valid[s:e], lo,
            cell, half, n, tri_budget, conservative)
        hit = hit.reshape(-1)
        ranks = torch.cumsum(hit, 0, dtype=torch.int64) - hit.long()
        idx = torch.where(hit, total + ranks, capacity)
        tri_ids = torch.arange(s, e, dtype=torch.int32,
                               device=dev).repeat_interleave(tri_budget)
        compaction.scatter_set_(vox, idx, flat.reshape(-1))
        compaction.scatter_set_(tri, idx, tri_ids)
        total = total + hit.sum()
    count = torch.clamp(total, max=capacity).to(torch.int32)
    lanes = torch.arange(capacity, dtype=torch.int32, device=dev)
    key = torch.where(lanes < count, vox, n3)
    key_s, order = torch.sort(key, stable=True)
    return ABuffer(frag_voxel=key_s, frag_tri=tri[order], count=count,
                   overflowed=total > capacity)


def grid_to_voxel_list(grid: torch.Tensor, bbox_lo: torch.Tensor,
                       bbox_hi: torch.Tensor, *, log_n: int, capacity: int):
    """Compact the occupied cells (alpha > 0, getOccupiedVoxels) into
    (centres f32[cap, 3], colours f32[cap, 4], count), zero past `count`:
    the thrust::copy_if at voxelization.cu:312. Centres and colours are
    computed for the compacted cells only, with the reference's arithmetic
    (the colour is a multiply by float32 1/255, which XLA makes of the
    reference's / 255)."""
    n = 1 << log_n
    dev = grid.device
    flat = grid.reshape(-1)
    occupied = packing.alpha_of(flat) > 0
    lin = torch.arange(n * n * n, dtype=torch.int32, device=dev)
    (lin_c, word_c), count = compaction.compact_multi(
        [lin, flat], occupied, capacity)
    live = torch.arange(capacity, device=dev) < count
    lo, cell, _ = _grid_params(bbox_lo, bbox_hi, n)
    ijk = (lin_c % n, (lin_c // n) % n, lin_c // (n * n))
    centers = torch.stack([fma32(i.to(torch.float32) + 0.5, cell[j], lo[j])
                           for j, i in enumerate(ijk)], -1)
    colors = torch.stack(packing.unpack_rgba8(word_c), -1).to(
        torch.float32) * (1.0 / 255.0)
    return (torch.where(live[:, None], centers, 0.0),
            torch.where(live[:, None], colors, 0.0), count)


def _default_texture(device):
    return torch.tensor(DEFAULT_TEXEL, dtype=torch.float32,
                        device=device).reshape(1, 1, 3)


def _scale(bbox: BoundingBox, n: int) -> torch.Tensor:
    return (bbox.bbox1[0] - bbox.bbox0[0]) / n / 2.0


def mesh_to_voxel_grid(mesh: Mesh, texture: Texture | None, *,
                       log_n: int = 8, tri_budget: int = 512,
                       capacity: int = 1 << 18,
                       conservative: bool = False) -> VoxelGrid:
    """meshToVoxelGrid (voxelization.cu:381-405): voxelize into the mesh's
    box and compact. conservative switches THIN to CONSERVATIVE."""
    bbox = mesh.bbox
    soup = prepare_mesh(mesh, bbox, log_n, tri_budget)
    tex = (texture.data if texture is not None
           else _default_texture(mesh.vertices.device))
    grid = voxelize(soup, tex, bbox.bbox0, bbox.bbox1, log_n=log_n,
                    tri_budget=tri_budget, conservative=conservative)
    centers, colors, count = grid_to_voxel_list(
        grid, bbox.bbox0, bbox.bbox1, log_n=log_n, capacity=capacity)
    return VoxelGrid(centers=centers, colors=colors, count=count,
                     scale=_scale(bbox, 1 << log_n), bbox=bbox)


def meshes_to_voxel_grid(meshes, textures, *, log_n: int = 8,
                         tri_budget: int = 512, capacity: int = 1 << 18,
                         conservative: bool = False) -> VoxelGrid:
    """Every mesh into one shared grid over the union of their boxes,
    padded to a cube about its centre (non-cubic cells would disagree with
    the scalar `scale` the octree and renderers use). Mesh i samples
    textures[i], the flat green texel past the list or at a None slot;
    meshes overlap by the largest word, as fragments of one mesh do."""
    assert meshes, "no meshes"
    dev = meshes[0].vertices.device
    lo = np.min([m.bbox.bbox0.cpu().numpy() for m in meshes], axis=0)
    hi = np.max([m.bbox.bbox1.cpu().numpy() for m in meshes], axis=0)
    c = 0.5 * (lo + hi)
    half = float(np.max(hi - lo)) * 0.5
    bbox = BoundingBox(
        bbox0=torch.from_numpy(np.asarray(c - half, np.float32)).to(dev),
        bbox1=torch.from_numpy(np.asarray(c + half, np.float32)).to(dev))
    n = 1 << log_n
    grid = torch.zeros((n, n, n), dtype=torch.int32, device=dev)
    for i, mesh in enumerate(meshes):
        soup = prepare_mesh(mesh, bbox, log_n, tri_budget, device=dev)
        tex = (textures[i].data if i < len(textures)
               and textures[i] is not None else _default_texture(dev))
        g = voxelize(soup, tex, bbox.bbox0, bbox.bbox1, log_n=log_n,
                     tri_budget=tri_budget, conservative=conservative)
        grid = torch.maximum(grid, g)
    centers, colors, count = grid_to_voxel_list(
        grid, bbox.bbox0, bbox.bbox1, log_n=log_n, capacity=capacity)
    return VoxelGrid(centers=centers, colors=colors, count=count,
                     scale=_scale(bbox, n), bbox=bbox)


def voxel_grid_to_mesh(grid: VoxelGrid, cube_scale: float = 1.0) -> Mesh:
    """A cube mesh per occupied voxel (voxelGridToMesh + createCubeMesh,
    voxelization.cu:184-217,325-379), built on the host and put on the
    grid's device; 8 vertices and 12 triangles a voxel."""
    dev = grid.centers.device
    k = int(grid.count)
    centers = grid.centers[:k].detach().cpu().numpy()
    colors = grid.colors[:k, :3].detach().cpu().numpy()
    s = float(grid.scale) * cube_scale
    corners = np.array(
        [[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)],
        np.float32) * s
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5),  # z- z+
        (0, 4, 5, 1), (2, 3, 7, 6),  # y- y+
        (0, 2, 6, 4), (1, 5, 7, 3),  # x- x+
    ]
    tris = np.array([t for q in quads for t in ((q[0], q[1], q[2]),
                                                (q[0], q[2], q[3]))],
                    np.int32)
    verts = (centers[:, None, :] + corners[None]).reshape(-1, 3)
    faces = (tris[None] + 8 * np.arange(k)[:, None, None]).reshape(-1, 3)
    vcols = np.repeat(colors, 8, axis=0)
    # per-vertex normals radial from the voxel centre
    nrm = np.tile(corners / np.linalg.norm(corners, axis=1, keepdims=True),
                  (k, 1))
    lo = centers.min(0) - s if k else np.zeros(3, np.float32)
    hi = centers.max(0) + s if k else np.zeros(3, np.float32)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return Mesh(vertices=t(verts), normals=t(nrm), colors=t(vcols),
                faces=t(faces, np.int32),
                texcoords=torch.zeros((faces.shape[0], 3, 2),
                                      dtype=torch.float32, device=dev),
                bbox=BoundingBox(t(lo), t(hi)))
