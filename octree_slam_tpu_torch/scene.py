"""Scene facade (counterpart: octree_slam_tpu/scene.py), the reference's
world-state API (scene.h:30-53): the loaded meshes and textures, the octree
map and the latest extracted voxel grid.

  loadObjFile                -> load_obj_file (io/obj.py)
  loadBMP                    -> load_texture (io/bmp.py; PNG through
                                io/png.py; any other format through PIL)
  voxelizeMeshes             -> voxelize_meshes (map/voxelization.py)
  extractVoxelGridFromOctree -> extract_voxel_grid_from_octree
  addPointCloudToOctree      -> add_point_cloud_to_octree (the octree is
                                made at the first cloud and expanded when
                                a cloud's box escapes it, scene.cpp:98-113)
  svo(bbox)                  -> svo

Everything lives on `device`. Textures are read as the reference reads
them: BMP by io/bmp.py, every other format through PIL's
convert("RGB"). The port reads PNG with its own codec, equal to PIL's
result for every PNG kind, so that a machine without PIL reads them
too; any other format needs PIL, as it does in the reference.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import (BoundingBox, Mesh, Texture,
                                              VoxelGrid, bbox_of_points)
from octree_slam_tpu_torch.io import bmp as bmp_io
from octree_slam_tpu_torch.io import obj as obj_io
from octree_slam_tpu_torch.io import png
from octree_slam_tpu_torch.map import voxelization
from octree_slam_tpu_torch.map.octree import Octree
from octree_slam_tpu_torch.map.svo import SVONodePool


def _texture(rgb8: np.ndarray, device) -> Texture:
    rgb = np.asarray(rgb8, np.float32) / 255.0
    return Texture(data=torch.from_numpy(rgb).to(device))


def _load_pil_texture(path: str, ext: str, device) -> Texture:
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: texture format {ext or '(none)'!r} is read through "
            "PIL, which is not installed (BMP and PNG read without it)"
        ) from None
    return _texture(Image.open(path).convert("RGB"), device)


class Scene:
    def __init__(self, cfg: SLAMConfig | None = None, device="cuda"):
        self.cfg = cfg or SLAMConfig()
        self.device = device
        self.meshes: List[Mesh] = []
        self.textures: List[Optional[Texture]] = []
        self.tree: Optional[Octree] = None
        self.voxel_grid: Optional[VoxelGrid] = None

    # --- assets ---

    def load_obj_file(self, filename: str) -> Mesh:
        mesh = obj_io.load_obj(filename, device=self.device)
        self.meshes.append(mesh)
        return mesh

    def load_texture(self, filename: str) -> Texture:
        """Load a texture and pair it with the most recently
        loaded mesh (slot len(meshes) - 1, earlier slots padded with None),
        so that the load-obj-then-texture order pairs them even when an
        earlier mesh has no texture. The reference pairs by list index
        (textures_[0] with meshes_[0], scene.cpp:70). A format other than
        BMP and PNG needs PIL; without it the ValueError names the
        format."""
        ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
        if ext == "bmp":
            tex = bmp_io.load_bmp(filename, device=self.device)
        elif ext == "png":
            tex = _texture(png.to_rgb8(png.read_png(filename)), self.device)
        else:
            tex = _load_pil_texture(filename, ext, self.device)
        slot = max(0, len(self.meshes) - 1)
        while len(self.textures) < slot:
            self.textures.append(None)
        if len(self.textures) == slot:
            self.textures.append(tex)
        else:
            self.textures[slot] = tex
        return tex

    # --- voxelization (Scene::voxelizeMeshes, scene.cpp:64-85) ---

    def voxelize_meshes(self, octree: bool = False,
                        conservative: bool = False) -> VoxelGrid:
        """One mesh into its own box, or every mesh into one cubic grid
        over their union (the reference's TODO, scene.cpp:65). With
        octree=True the grid also goes into the octree (made to fit it if
        there is none) and the grid returned is the octree's extraction."""
        if not self.meshes:
            raise ValueError("no meshes loaded")
        kw = dict(log_n=self.cfg.vox_log_n, tri_budget=self.cfg.vox_tri_budget,
                  capacity=self.cfg.extract_capacity,
                  conservative=conservative)
        if len(self.meshes) == 1:
            grid = voxelization.mesh_to_voxel_grid(
                self.meshes[0], self.textures[0] if self.textures else None,
                **kw)
        else:
            grid = voxelization.meshes_to_voxel_grid(self.meshes,
                                                     self.textures, **kw)
        if octree:
            scale = float(grid.scale)
            if self.tree is None:
                lo = grid.bbox.bbox0.cpu().numpy()
                hi = grid.bbox.bbox1.cpu().numpy()
                center = 0.5 * (lo + hi)
                half = float(np.max(hi - center))
                self.tree = Octree(scale, center, half,
                                   capacity=self.cfg.node_capacity,
                                   extract_capacity=self.cfg.extract_capacity,
                                   device=self.device)
            self.tree.add_voxel_grid(grid)
            # mesh voxels carry alpha 127, not yet occupied: the second
            # observation lifts them over it (the fusion's alpha rule)
            self.tree.add_voxel_grid(grid)
            self.voxel_grid = self.tree.extract_voxel_grid()
        else:
            self.voxel_grid = grid
        return self.voxel_grid

    def extract_voxel_grid_from_octree(self) -> VoxelGrid:
        if self.tree is None:
            raise ValueError("no octree")
        self.voxel_grid = self.tree.extract_voxel_grid()
        return self.voxel_grid

    # --- SLAM fusion (Scene::addPointCloudToOctree, scene.cpp:98-113) ---

    def add_point_cloud_to_octree(self, origin, points, colors,
                                  bbox: BoundingBox | None = None,
                                  valid=None) -> None:
        if bbox is None:
            bbox = bbox_of_points(points, valid)
        lo = bbox.bbox0.cpu().numpy()
        hi = bbox.bbox1.cpu().numpy()
        if self.tree is None:
            center = 0.5 * (lo + hi)
            half = float(np.max(hi - center)) + 1e-3
            self.tree = Octree(self.cfg.voxel_resolution, center, half,
                               capacity=self.cfg.node_capacity,
                               extract_capacity=self.cfg.extract_capacity,
                               device=self.device)
        elif not self.tree.contains(bbox):
            outside = float(self.tree.bounding_box().distance_outside(bbox))
            self.tree.expand_by_size(outside)
        self.tree.add_cloud(points, colors, valid)

    # --- accessors ---

    def svo(self, bbox: BoundingBox | None = None) -> SVONodePool:
        """Scene::svo (scene.h:53): the renderable node pool."""
        if self.tree is None:
            raise ValueError("no octree")
        return self.tree.extract_svo()
