"""Renderer facade (counterpart: octree_slam_tpu/render/renderer.py).

CUDARenderer (cuda_renderer.h:22-26: rasterize / pixelPassthrough /
coneTraceSVO) and OpenGLRenderer (opengl_renderer.h:22-26: rasterize /
rasterizeVoxels / renderPoints) as one class. Where the reference maps a
GL PBO and blits it, every method returns an f32[H, W, 4] framebuffer on
the inputs' device; callers save it (io/bmp.save_image) or stream it.
"""

from __future__ import annotations

import torch

from octree_slam_tpu_torch.core.types import Camera, Mesh, Texture, VoxelGrid
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.map.voxelization import voxel_grid_to_mesh
from octree_slam_tpu_torch.render import points as points_mod
from octree_slam_tpu_torch.render import raster, raycast
from octree_slam_tpu_torch.render.splat import LeafList, render_splat


class Renderer:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height

    # --- the CUDARenderer surface ---

    def rasterize(self, mesh: Mesh, camera: Camera,
                  texture: Texture | None = None,
                  light_pos=(10.0, 10.0, 10.0), shading: str = "phong",
                  frag_budget: int | None = None) -> torch.Tensor:
        """The software triangle pipeline (CUDARenderer::rasterize ->
        rasterizeMesh, rasterize_kernels.cu:484-613)."""
        return raster.rasterize_mesh(
            mesh, camera, width=self.width, height=self.height,
            frag_budget=frag_budget,
            texture=texture.data if texture is not None else None,
            shading=shading, light_pos=light_pos)

    def rasterize_wireframe(self, mesh: Mesh, camera: Camera,
                            samples: int = 64) -> torch.Tensor:
        """Edge view (rasterizationKernelWire, rasterize_kernels.cu:
        340-377)."""
        return raster.rasterize_wireframe(
            raster.assemble(mesh), camera.mvp, width=self.width,
            height=self.height, samples=samples)

    def rasterize_vertices(self, mesh: Mesh, camera: Camera) -> torch.Tensor:
        """Vertex-cloud view (rasterize_kernels.cu:380-410)."""
        return raster.rasterize_vertices(
            raster.assemble(mesh), camera.mvp, width=self.width,
            height=self.height)

    def pixel_passthrough(self, color: torch.Tensor) -> torch.Tensor:
        """The raw camera stream u8[H, W, 3] (writeColorToPBO,
        rasterize_kernels.cu:626-649)."""
        rgb = color.to(torch.float32) / 255.0
        return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)

    def cone_trace_svo(self, pool: SVONodePool, camera_pose: torch.Tensor,
                       fx, fy, max_depth: int, **kw) -> torch.Tensor:
        """Voxel cone tracing of the node pool (CUDARenderer::coneTraceSVO,
        cuda_renderer.cpp:158-171)."""
        return raycast.cone_trace(pool, camera_pose, fx, fy,
                                  width=self.width, height=self.height,
                                  max_depth=max_depth, **kw)

    # --- the OpenGLRenderer surface ---

    def rasterize_voxels(self, grid: VoxelGrid, camera: Camera,
                         use_cubes: bool = False,
                         frag_budget: int = 64) -> torch.Tensor:
        """Voxel display (OpenGLRenderer::rasterizeVoxels,
        opengl_renderer.cpp:101-172): use_cubes rasterizes a cube mesh per
        voxel (the GL instancing), else footprint splats."""
        if use_cubes:
            return raster.rasterize_mesh(
                voxel_grid_to_mesh(grid), camera, width=self.width,
                height=self.height, frag_budget=frag_budget,
                shading="diffuse", cull_backfaces=False)
        live = torch.arange(grid.centers.shape[0],
                            device=grid.centers.device) < grid.count
        return points_mod.render_voxels(
            grid.centers, grid.colors, grid.scale, live, camera.view,
            camera.mvp, width=self.width, height=self.height,
            proj_focal=camera.projection[1, 1])

    def render_points(self, vertex_map: torch.Tensor, color: torch.Tensor,
                      camera: Camera) -> torch.Tensor:
        """Point-cloud display (OpenGLRenderer::renderPoints,
        opengl_renderer.cpp:174-221); colours u8 or float in [0, 1]."""
        pts = vertex_map.reshape(-1, 3)
        scale = 255.0 if color.dtype == torch.uint8 else 1.0
        cols = torch.clamp(color.reshape(-1, 3).to(torch.float32) / scale,
                           0.0, 1.0)
        return points_mod.render_points(pts, cols, camera.mvp,
                                        width=self.width, height=self.height)

    # --- the SLAM map view ---

    def splat_map(self, pool: SVONodePool, leaves: LeafList,
                  camera_pose: torch.Tensor, fx, fy, depth: int,
                  **kw) -> torch.Tensor:
        return render_splat(pool, leaves, camera_pose, fx, fy,
                            width=self.width, height=self.height,
                            depth=depth, **kw)
