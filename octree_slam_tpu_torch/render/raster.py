"""Software triangle rasterizer (counterpart: octree_slam_tpu/render/raster.py).

The reference rebuilds the CUDA triangle pipeline
(src/rendering/rasterize_kernels.cu): vertex shade (:152-180), primitive
assembly (:182-213), the backface cull (:216-233), barycentric
rasterization with a depth test (:292-336) and the two fragment shaders
(bilinear texture and diffuse :412-433, Blinn-Phong :441-469). Each
triangle emits up to `frag_budget` candidate pixels from its screen box,
and the depth test is two passes: a scatter-min of the quantised depth,
then the fragments that equal it write.

The port keeps that design and adds:

  * one rule for the fragments that tie at a pixel's quantised depth
    (shared edges, the faces of voxel cubes): the one with the largest
    flat lane id (triangle * frag_budget + candidate) writes. The
    reference scatters every winner and XLA:CPU applies them in order, so
    its last lane writes; the port picks that lane with a scatter-max of
    the lane ids and writes it alone, the same on the card, where
    duplicate writes land in no fixed order;
  * chunked enumeration (utils/compaction.CHUNK_LANES candidates at a
    time): each pass recomputes its chunk's fragments, so the memory stays
    bounded at any mesh size; the min and the max do not depend on order;
  * the edge functions and the interpolations, which decide coverage and
    the winners, evaluated as XLA fuses the reference's (utils/fma.py);
    the projection as render/points.py evaluates it (the reference's is a
    matrix product whose order the port cannot follow, an ulp apart on
    some corners, which the barycentrics of thin triangles magnify in
    their colours).

The cull keeps triangles of negative signed screen area (counter-clockwise
in the world, as y grows downward; calculateSignedArea's convention).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from octree_slam_tpu_torch.core.types import Mesh
from octree_slam_tpu_torch.render.points import (DEPTH_INF, _DEPTH_SCALE,
                                                 project, project_clipless,
                                                 to_i32)
from octree_slam_tpu_torch.utils import compaction
from octree_slam_tpu_torch.utils.fma import chain, fma32, fms32



class RasterMesh(NamedTuple):
    """Per-face corner attributes (primitive assembly output)."""

    pos: torch.Tensor    # f32[F, 3, 3] world-space corners
    nrm: torch.Tensor    # f32[F, 3, 3]
    col: torch.Tensor    # f32[F, 3, 3]
    uv: torch.Tensor     # f32[F, 3, 2]
    valid: torch.Tensor  # bool[F]


def assemble(mesh: Mesh) -> RasterMesh:
    """Gather corner attributes per face (primitiveAssemblyKernel,
    rasterize_kernels.cu:182-213)."""
    f = mesh.faces.long()
    nf = f.shape[0]
    dev = mesh.vertices.device
    uv = mesh.texcoords
    if uv.shape[0] != nf:
        uv = torch.zeros((nf, 3, 2), dtype=torch.float32, device=dev)
    return RasterMesh(
        pos=mesh.vertices[f],
        nrm=(mesh.normals[f] if mesh.normals.shape[0]
             else torch.zeros((nf, 3, 3), device=dev)),
        col=(mesh.colors[f] if mesh.colors.shape[0]
             else torch.full((nf, 3, 3), 0.8, device=dev)),
        uv=uv,
        valid=torch.ones((nf,), dtype=torch.bool, device=dev))


class _Screen(NamedTuple):
    xy: torch.Tensor      # f32[F, 3, 2]
    z: torch.Tensor       # f32[F, 3] NDC depth
    alive: torch.Tensor   # bool[F]


def _screen(rm: RasterMesh, mvp, width, height, cull_backfaces) -> _Screen:
    """Vertex shade (clipless: a triangle partly off screen draws its
    on-screen part) and the cull on the signed screen area."""
    nf = rm.pos.shape[0]
    xy, z, ok = project_clipless(rm.pos.reshape(-1, 3), mvp, width, height)
    xy = xy.reshape(nf, 3, 2)
    alive = rm.valid & ok.reshape(nf, 3).all(dim=1)
    e1 = xy[:, 1] - xy[:, 0]
    e2 = xy[:, 2] - xy[:, 0]
    area2 = fms32(e1[:, 0], e2[:, 1], e1[:, 1], e2[:, 0])
    if cull_backfaces:
        alive = alive & (area2 < 0.0)  # y grows downward: CCW-world flips
    alive = alive & (area2.abs() > 1e-12)
    return _Screen(xy=xy, z=z.reshape(nf, 3), alive=alive)


class _Frags(NamedTuple):
    idx: torch.Tensor    # i32[T, B] pixel, num_pix where not a hit
    q: torch.Tensor      # i32[T, B] quantised depth
    hit: torch.Tensor    # bool[T, B]
    bary: tuple          # (w0, w1, w2) f32[T, B]


def _fragments(scr: _Screen, s: int, e: int, width: int, height: int,
               frag_budget: int) -> _Frags:
    """Candidates of triangles s..e: the screen box walked row-major up to
    frag_budget pixels, each tested by its edge-function barycentrics."""
    xy3, z3, alive = scr.xy[s:e], scr.z[s:e], scr.alive[s:e]
    # a culled triangle's corners may be non-finite; it emits no hit
    xy3 = torch.where(alive[:, None, None], xy3, 0.0)
    dev = xy3.device
    num_pix = width * height
    lim = torch.tensor([width - 1, height - 1], dtype=torch.int32,
                       device=dev)
    lo = to_i32(torch.floor(xy3.amin(dim=1)))
    hi = to_i32(torch.ceil(xy3.amax(dim=1)))
    lo = torch.minimum(torch.clamp(lo, min=0), lim)
    hi = torch.minimum(torch.clamp(hi, min=0), lim)
    dims = hi - lo + 1

    k = torch.arange(frag_budget, dtype=torch.int32, device=dev)
    px = lo[:, 0:1] + k % dims[:, 0:1]
    py = lo[:, 1:2] + k // dims[:, 0:1]
    in_box = (k < dims[:, 0:1] * dims[:, 1:2]) & (py <= hi[:, 1:2])
    p0 = px.to(torch.float32) + 0.5
    p1 = py.to(torch.float32) + 0.5

    # barycentrics by 2D edge functions
    d = xy3[:, 1:] - xy3[:, 0:1]
    det = fms32(d[:, 0, 0], d[:, 1, 1], d[:, 0, 1], d[:, 1, 0])
    det = torch.where(det.abs() < 1e-12, 1e-12, det)[:, None]
    r0 = p0 - xy3[:, 0, 0:1]
    r1 = p1 - xy3[:, 0, 1:2]
    w1 = fms32(r0, d[:, 1, 1:2], r1, d[:, 1, 0:1]) / det
    w2 = fms32(r1, d[:, 0, 0:1], r0, d[:, 0, 1:2]) / det
    w0 = 1.0 - w1 - w2
    inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)

    depth = chain((w0, w1, w2), (z3[:, 0:1], z3[:, 1:2], z3[:, 2:3]))
    hit = (alive[:, None] & in_box & inside & (depth >= -1.0)
           & (depth <= 1.0))
    q = torch.round(torch.where(hit, depth, 0.0) * _DEPTH_SCALE).to(
        torch.int32)
    return _Frags(idx=torch.where(hit, py * width + px, num_pix), q=q,
                  hit=hit, bary=(w0, w1, w2))


def _interp(bary, attr):
    """bary @ attr per lane, a fused chain: attr [T, 3, C] -> [T, B, C]."""
    return chain([w[..., None] for w in bary],
                 [attr[:, None, j] for j in range(3)])


def _bilinear(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    th, tw = texture.shape[0], texture.shape[1]
    u = torch.clamp(uv[..., 0], 0.0, 1.0) * (tw - 1)
    v = torch.clamp(uv[..., 1], 0.0, 1.0) * (th - 1)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, max=tw - 1)
    v1 = torch.clamp(v0 + 1, max=th - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return (texture[v0, u0] * (1 - fu) * (1 - fv)
            + texture[v0, u1] * fu * (1 - fv)
            + texture[v1, u0] * (1 - fu) * fv
            + texture[v1, u1] * fu * fv)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def _shade(rm: RasterMesh, s: int, e: int, bary, texture, light, eye,
           shading: str) -> torch.Tensor:
    """Fragment colours [T, B, 3] in [0, 1]."""
    fpos = _interp(bary, rm.pos[s:e])
    base = _interp(bary, rm.col[s:e])
    if texture is not None:
        base = _bilinear(texture, _interp(bary, rm.uv[s:e]))
    if shading in ("diffuse", "phong"):
        n = _normalize(_interp(bary, rm.nrm[s:e]))
        lv = _normalize(light - fpos)
        lam = torch.clamp((n * lv).sum(dim=-1), 0.0, 1.0)
        rgb = base * (0.2 + 0.8 * lam)[..., None]
        if shading == "phong":
            h = _normalize(lv + _normalize(eye - fpos))
            spec = torch.clamp((n * h).sum(dim=-1), 0.0, 1.0) ** 32
            rgb = rgb + 0.4 * spec[..., None]
    else:
        rgb = base
    return torch.clamp(rgb, 0.0, 1.0)


def rasterize(rm: RasterMesh, mvp: torch.Tensor, *, width: int,
              height: int, frag_budget: int = 256,
              texture: torch.Tensor | None = None,
              light_pos=(10.0, 10.0, 10.0), eye_pos=(0.0, 0.0, 0.0),
              shading: str = "diffuse",
              cull_backfaces: bool = True) -> torch.Tensor:
    """Render a triangle mesh to f32[height, width, 4] (rgb, coverage).
    shading: 'color' (the interpolated vertex colour), 'diffuse'
    (Lambertian, fragmentShadeKernel) or 'phong' (Blinn-Phong,
    fragmentShadePhongKernel); a texture f32[th, tw, 3] replaces the base
    colour by its bilinear sample.

    Three passes over the chunks: the scatter-min of the quantised depth,
    the scatter-max of the winners' lane ids, and the write of the chosen
    lane's shaded colour."""
    dev = rm.pos.device
    num_pix = width * height
    light = torch.as_tensor(light_pos, dtype=torch.float32, device=dev)
    eye = torch.as_tensor(eye_pos, dtype=torch.float32, device=dev)
    scr = _screen(rm, mvp, width, height, cull_backfaces)
    chunks = compaction.chunks(rm.pos.shape[0], frag_budget)
    # each buffer has a spare last word for the lanes that do not write
    zbuf = torch.full((num_pix + 1,), DEPTH_INF, dtype=torch.int32,
                      device=dev)
    for s, e in chunks:
        f = _fragments(scr, s, e, width, height, frag_budget)
        zbuf.scatter_reduce_(0, f.idx.reshape(-1).long(),
                             torch.where(f.hit, f.q, DEPTH_INF).reshape(-1),
                             reduce="amin")
    lanes = torch.arange(frag_budget, dtype=torch.int64, device=dev)
    owner = torch.full((num_pix + 1,), -1, dtype=torch.int64, device=dev)
    for s, e in chunks:
        f = _fragments(scr, s, e, width, height, frag_budget)
        won = f.hit & (zbuf[f.idx.long()] == f.q)
        lane = torch.arange(s, e, dtype=torch.int64,
                            device=dev)[:, None] * frag_budget + lanes
        owner.scatter_reduce_(0, torch.where(won, f.idx, num_pix)
                              .reshape(-1).long(),
                              torch.where(won, lane, -1).reshape(-1),
                              reduce="amax")
    fb = torch.zeros((num_pix + 1, 4), dtype=torch.float32, device=dev)
    for s, e in chunks:
        f = _fragments(scr, s, e, width, height, frag_budget)
        lane = torch.arange(s, e, dtype=torch.int64,
                            device=dev)[:, None] * frag_budget + lanes
        mine = f.hit & (owner[f.idx.long()] == lane)
        rgb = _shade(rm, s, e, f.bary, texture, light, eye, shading)
        rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)
        # a pixel has one owner, so the kept writes go to distinct pixels;
        # the others all write zeros to the spare word
        tgt = torch.where(mine, f.idx, num_pix).reshape(-1).long()
        fb[tgt] = torch.where(mine[..., None], rgba, 0.0).reshape(-1, 4)
    return fb[:num_pix].reshape(height, width, 4)


def _debug_resolve(idx, q, hit, num_pix, height, width, dev):
    """The debug passes' depth resolve: every winner writes white."""
    zbuf = torch.full((num_pix + 1,), DEPTH_INF, dtype=torch.int32,
                      device=dev)
    tgt = torch.where(hit, idx, num_pix).long()
    zbuf.scatter_reduce_(0, tgt, torch.where(hit, q, DEPTH_INF),
                         reduce="amin")
    won = hit & (zbuf[tgt] == q)
    fb = torch.zeros((num_pix + 1, 4), dtype=torch.float32, device=dev)
    fb[torch.where(won, idx, num_pix).long()] = 1.0
    return fb[:num_pix].reshape(height, width, 4)


def rasterize_wireframe(rm: RasterMesh, mvp: torch.Tensor, *, width: int,
                        height: int, samples: int = 64) -> torch.Tensor:
    """Debug wireframe (rasterizationKernelWire, rasterize_kernels.cu:
    340-377): each edge sampled at `samples` points with the two-pass
    depth resolve. White lines on black, coverage in alpha."""
    nf = rm.pos.shape[0]
    dev = rm.pos.device
    num_pix = width * height
    xy, z, ok = project_clipless(rm.pos.reshape(-1, 3), mvp, width, height)
    xy = xy.reshape(nf, 3, 2)
    z = z.reshape(nf, 3)
    alive = rm.valid & ok.reshape(nf, 3).all(dim=1)
    # jnp.linspace(0, 1, samples) as XLA evaluates it: i * f32(1/(S-1)),
    # the last sample exactly 1
    t = torch.arange(samples, dtype=torch.float32, device=dev)
    if samples > 1:
        t = t * (1.0 / (samples - 1))
        t[-1] = 1.0
    nxt = torch.tensor([1, 2, 0], device=dev)
    p0, p1 = xy[:, :, None, :], xy[:, nxt][:, :, None, :]
    tt = t[:, None]
    pts = fma32(p0, 1 - tt, p1 * tt)
    zs = fma32(z[:, :, None], 1 - t, z[:, nxt][:, :, None] * t)
    pts = torch.where(alive[:, None, None, None], pts, 0.0)
    px = to_i32(torch.round(pts[..., 0] - 0.5))
    py = to_i32(torch.round(pts[..., 1] - 0.5))
    hit = (alive[:, None, None] & (px >= 0) & (px < width) & (py >= 0)
           & (py < height) & (zs >= -1.0) & (zs <= 1.0))
    q = torch.round(torch.where(hit, zs, 0.0) * _DEPTH_SCALE).to(
        torch.int32)
    return _debug_resolve((py * width + px).reshape(-1), q.reshape(-1),
                          hit.reshape(-1), num_pix, height, width, dev)


def rasterize_vertices(rm: RasterMesh, mvp: torch.Tensor, *, width: int,
                       height: int) -> torch.Tensor:
    """Debug vertex cloud (rasterizationKernelVertices,
    rasterize_kernels.cu:380-410): projected corners as white pixels with
    the depth resolve."""
    dev = rm.pos.device
    num_pix = width * height
    xy, z, ok = project(rm.pos.reshape(-1, 3), mvp, width, height)
    ok = ok & rm.valid.repeat_interleave(3)
    xy = torch.where(ok[:, None], xy, 0.0)
    px = to_i32(torch.round(xy[:, 0] - 0.5))
    py = to_i32(torch.round(xy[:, 1] - 0.5))
    hit = ok & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    q = torch.round(torch.where(hit, z, 0.0) * _DEPTH_SCALE).to(torch.int32)
    return _debug_resolve(py * width + px, q, hit, num_pix, height, width,
                          dev)


def auto_frag_budget(num_faces: int, width: int, height: int) -> int:
    """A per-triangle budget that keeps the candidates near 4x the pixel
    count: a few big triangles can cover the screen, a dense mesh gets a
    small budget (a budget too small truncates large on-screen
    triangles)."""
    f = max(int(num_faces), 1)
    return int(min(max(256, 4 * width * height // f), 65536))


def rasterize_mesh(mesh: Mesh, camera, *, width: int, height: int,
                   frag_budget: int | None = None, texture=None,
                   shading: str = "diffuse", light_pos=(10.0, 10.0, 10.0),
                   cull_backfaces: bool = True) -> torch.Tensor:
    """assemble + rasterize with a core.types.Camera (the host API of
    CUDARenderer::rasterize, cuda_renderer.cpp:116-135); frag_budget None
    picks auto_frag_budget."""
    rm = assemble(mesh)
    if frag_budget is None:
        frag_budget = auto_frag_budget(mesh.faces.shape[0], width, height)
    rt = camera.view[:3, :3].T
    tv = camera.view[:3, 3]
    eye = -torch.stack([chain((rt[j, 0], rt[j, 1], rt[j, 2]),
                              (tv[0], tv[1], tv[2])) for j in range(3)])
    return rasterize(rm, camera.mvp, width=width, height=height,
                     frag_budget=frag_budget, texture=texture,
                     light_pos=light_pos,
                     eye_pos=tuple(float(x) for x in eye.tolist()),
                     shading=shading, cull_backfaces=cull_backfaces)
