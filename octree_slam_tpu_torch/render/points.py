"""Point-cloud and voxel-splat rendering with a packed z-buffer
(counterpart: octree_slam_tpu/render/points.py).

The GL_POINTS view of the vertex map (OpenGLRenderer::renderPoints,
opengl_renderer.cpp:174-221) and the instanced voxel cubes
(rasterizeVoxels, :101-172) as array programs: project, then resolve depth
and colour at once by a scatter-min of one (q15 NDC depth << 16 | rgb565)
word a fragment. The minimum does not depend on the order of the
fragments, so the result is deterministic where the reference's software
depth test races (rasterize_kernels.cu:327-330). The splat renderer shares
the no-hit sentinel and the RGB565 packing.

The projection's multiply-adds, which decide each point's pixel and
quantised depth, are forward chains of fused multiply-adds
(utils/fma.py). The reference projects all points in one [N, 4] x [4, 4]
matrix product, which XLA:CPU hands to an Eigen kernel whose summation
order depends on N, so a value can land an ulp apart; a pixel or a depth
word flips only where that ulp crosses a boundary, and the packed words
equal the reference's in every parity test.
"""

from __future__ import annotations

import torch

from octree_slam_tpu_torch.utils.fma import chain, fma32

DEPTH_INF = 0x7FFFFFFF   # no-hit sentinel: above every packed depth word
_DEPTH_SCALE = 1.0e4     # the triangle rasterizer's depth quantum (0.1 mm)
# float32 bounds inside which a float -> int32 cast is defined (XLA's
# convert saturates; a torch cast of a value outside is undefined)
_I32_LO, _I32_HI = -2.0 ** 31, 2.0 ** 31 - 128


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero and saturating, as XLA's
    convert does for finite values."""
    return x.clamp(_I32_LO, _I32_HI).to(torch.int32)


def pack_rgb565(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """8-bit channels -> one 5-6-5 16-bit word."""
    return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)


def unpack_rgb565(v: torch.Tensor):
    """5-6-5 word -> 8-bit channels, replicating the top bits into the low
    ones so full-scale values round-trip exactly (255 -> 255)."""
    r5 = (v >> 11) & 0x1F
    g6 = (v >> 5) & 0x3F
    b5 = v & 0x1F
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def _clip_coords(points: torch.Tensor, mvp: torch.Tensor):
    """[x, y, z, 1] @ mvp.T per point, each row a fused chain."""
    one = torch.ones_like(points[..., 0])
    ws = (points[..., 0], points[..., 1], points[..., 2], one)
    return [chain(ws, (mvp[j, 0], mvp[j, 1], mvp[j, 2], mvp[j, 3]))
            for j in range(4)]


def _viewport(points, mvp, width: int, height: int):
    clip = _clip_coords(points, mvp)
    w = clip[3]
    ok = (w > 1e-8) & torch.stack([torch.isfinite(c) for c in clip],
                                  -1).all(dim=-1)
    den = torch.where(ok, w, 1.0)
    ndc = [c / den for c in clip[:3]]
    px = fma32(ndc[0], 0.5, 0.5) * width
    py = (1.0 - fma32(ndc[1], 0.5, 0.5)) * height
    return torch.stack([px, py], -1), ndc, ok


def project(points: torch.Tensor, mvp: torch.Tensor, width: int,
            height: int):
    """Clip-space projection and viewport transform (vertexShadeKernel,
    rasterize_kernels.cu:152-180). Returns (xy f32[N, 2], depth f32[N],
    valid bool[N]): valid means in front of the camera and inside the
    frustum."""
    xy, ndc, ok = _viewport(points, mvp, width, height)
    inside = ok & torch.stack([c.abs() <= 1.0 for c in ndc], -1).all(dim=-1)
    return xy, ndc[2], inside


def project_clipless(points: torch.Tensor, mvp: torch.Tensor, width: int,
                     height: int):
    """project() with valid only requiring the point to be in front of the
    camera, so that triangles partly off screen still draw their on-screen
    part (the reference clamps the scan box to the viewport instead,
    rasterize_kernels.cu:300-310)."""
    xy, ndc, ok = _viewport(points, mvp, width, height)
    return xy, ndc[2], ok


def _pack_zrgb(ndc_z: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """(q15 depth << 16) | rgb565, one int32 a fragment."""
    q = torch.round((ndc_z + 1.0) * 16383.0).clamp(0, 32766).to(torch.int32)
    c8 = torch.round(colors[..., :3] * 255.0).clamp(0, 255).to(torch.int32)
    return (q << 16) | pack_rgb565(c8[..., 0], c8[..., 1], c8[..., 2])


def _unpack_fb(buf: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Packed z-buffer -> f32[H, W, 4] (alpha = hit mask)."""
    occ = buf != DEPTH_INF
    rr, gg, bb = unpack_rgb565(buf & 0xFFFF)
    rgb = torch.stack([rr, gg, bb], -1).to(torch.float32)
    # XLA evaluates the reference's / 255 as a multiply by float32 1/255
    rgb = torch.where(occ[..., None], rgb * (1.0 / 255.0), 0.0)
    out = torch.cat([rgb, occ[..., None].to(torch.float32)], -1)
    return out.reshape(height, width, 4)


def _scatter_min(buf: torch.Tensor, idx: torch.Tensor, word: torch.Tensor,
                 ok: torch.Tensor) -> None:
    """buf[idx] = min(buf[idx], word) where ok, in place; buf has one
    spare word at its end that takes the dropped lanes."""
    spare = buf.shape[0] - 1
    buf.scatter_reduce_(0, torch.where(ok, idx, spare).reshape(-1).long(),
                        torch.where(ok, word, DEPTH_INF).reshape(-1),
                        reduce="amin")


def render_points(points: torch.Tensor, colors: torch.Tensor,
                  mvp: torch.Tensor, *, width: int,
                  height: int) -> torch.Tensor:
    """1-pixel point splats with a depth test; points f32[N, 3], colours
    f32[N, 3] in [0, 1]. Returns f32[height, width, 4]."""
    return _unpack_fb(points_zbuffer(points, colors, mvp, width=width,
                                     height=height), height, width)


def points_zbuffer(points: torch.Tensor, colors: torch.Tensor,
                   mvp: torch.Tensor, *, width: int,
                   height: int) -> torch.Tensor:
    """The packed z-buffer i32[H*W] of render_points."""
    xy, z, valid = project(points, mvp, width, height)
    xy = torch.where(valid[:, None], xy, 0.0)
    xi = torch.floor(xy[:, 0]).to(torch.int32)
    yi = torch.floor(xy[:, 1]).to(torch.int32)
    inb = valid & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    buf = torch.full((width * height + 1,), DEPTH_INF, dtype=torch.int32,
                     device=points.device)
    _scatter_min(buf, yi * width + xi, _pack_zrgb(z, colors), inb)
    return buf[:-1]


def render_voxels(centers: torch.Tensor, colors: torch.Tensor, scale,
                  live: torch.Tensor, view: torch.Tensor, mvp: torch.Tensor,
                  *, width: int, height: int, max_splat: int = 4,
                  proj_focal=None) -> torch.Tensor:
    """Voxel cubes as depth-tested square splats sized by the projected
    footprint (the stand-in for instanced cube rasterization; exact cubes
    come from the triangle rasterizer through voxel_grid_to_mesh).
    centers f32[N, 3]; colours f32[N, 3|4]; scale = half voxel edge; live
    bool[N]; max_splat bounds the splat radius in pixels. Returns
    f32[height, width, 4]."""
    return _unpack_fb(voxels_zbuffer(
        centers, colors, scale, live, view, mvp, width=width, height=height,
        max_splat=max_splat, proj_focal=proj_focal), height, width)


def voxels_zbuffer(centers: torch.Tensor, colors: torch.Tensor, scale,
                   live: torch.Tensor, view: torch.Tensor, mvp: torch.Tensor,
                   *, width: int, height: int, max_splat: int = 4,
                   proj_focal=None) -> torch.Tensor:
    """The packed z-buffer i32[H*W] of render_voxels: one packed
    scatter-min per footprint offset."""
    xy, z, valid = project(centers, mvp, width, height)
    valid = valid & live
    # camera-space z, the third row of view as a fused chain (the camera
    # looks down -z in the GL view)
    cam_z = chain((centers[:, 0], centers[:, 1], centers[:, 2],
                   torch.ones_like(centers[:, 0])),
                  (view[2, 0], view[2, 1], view[2, 2], view[2, 3]))
    dist = torch.clamp(-cam_z, min=1e-4)
    # projected half size in pixels: scale / dist * P[1, 1] * (H / 2); the
    # focal term must come from the projection matrix (mvp[1, 1] folds in
    # the view's rotation)
    focal_px = mvp[1, 1] if proj_focal is None else proj_focal
    r_px = torch.clamp(scale / dist * torch.as_tensor(focal_px).abs()
                       * (height / 2.0), 0.0, float(max_splat))
    xy = torch.where(valid[:, None], xy, 0.0)
    xi = torch.floor(xy[:, 0]).to(torch.int32)
    yi = torch.floor(xy[:, 1]).to(torch.int32)
    word = _pack_zrgb(z, colors)
    buf = torch.full((width * height + 1,), DEPTH_INF, dtype=torch.int32,
                     device=centers.device)
    for dy in range(-max_splat, max_splat + 1):
        for dx in range(-max_splat, max_splat + 1):
            covered = max(abs(dx), abs(dy)) <= r_px + 0.5
            x2 = xi + dx
            y2 = yi + dy
            ok = (valid & covered & (x2 >= 0) & (x2 < width) & (y2 >= 0)
                  & (y2 < height))
            _scatter_min(buf, y2 * width + x2, word, ok)
    return buf[:-1]
