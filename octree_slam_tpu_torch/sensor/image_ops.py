"""Depth/colour frame preprocessing (counterpart:
octree_slam_tpu/sensor/image_ops.py).

Images are row-major [H, W(, C)] tensors; invalid vertices and normals are
INF like the reference. The two window stencils run through
sensor/cuda_ops (a CUDA kernel on a CUDA tensor, the plain version on a CPU
tensor). Divergences from the CUDA reference are the JAX package's:
colorToIntensity uses (r, g, b) (image_kernels.cu:196-197) and the windows
are full and clipped to the image (image_kernels.cu:155-156, 252-253).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from octree_slam_tpu_torch.sensor import cuda_ops

INVALID_DEPTH_MAX_MM = 15000  # image_kernels.cu:40


def generate_vertex_map(depth_mm: torch.Tensor, fx, fy,
                        img_size: Tuple[int, int], row0: int = 0,
                        level_height: int | None = None) -> torch.Tensor:
    """Pinhole backprojection of an integer depth image [..., h, w] (a
    pyramid level of the (full_W, full_H) = img_size sensor image,
    generateVertexMapKernel image_kernels.cu:24-53). Returns
    f32[..., h, w, 3], INF where depth is 0 or beyond 15 m.

    A row slab of a level passes its first row `row0` in the level and
    the level's `level_height` (the slab's own height otherwise)."""
    h, w = depth_mm.shape[-2:]
    lh = h if level_height is None else level_height
    img_w, img_h = img_size
    dev = depth_mm.device
    d = depth_mm.to(torch.float32)
    x = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    y = torch.arange(row0, row0 + h, dtype=torch.float32,
                     device=dev)[:, None].expand(h, w)
    milli = 1e-3
    vx = ((img_w / w) * x - img_w / 2.0) * d / fx * milli
    vy = (img_h / 2.0 - (img_h / lh) * y) * d / fy * milli
    vz = d * milli
    v = torch.stack([vx, vy, vz], dim=-1)
    invalid = (depth_mm == 0) | (depth_mm > INVALID_DEPTH_MAX_MM)
    return torch.where(invalid[..., None], torch.inf, v)


def generate_normal_map(vertex: torch.Tensor) -> torch.Tensor:
    """n = normalize(-cross(v[x+1]-v, v[y+1]-v)) of a vertex map
    [..., h, w, 3]; right/bottom edges invalid (generateNormalMapKernel,
    image_kernels.cu:104-134)."""
    h, w, _ = vertex.shape[-3:]
    v1 = torch.roll(vertex, -1, dims=-2) - vertex
    v2 = torch.roll(vertex, -1, dims=-3) - vertex
    n = -torch.linalg.cross(v1, v2, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    edge = torch.zeros((h, w), dtype=torch.bool, device=vertex.device)
    edge[:, w - 1] = True
    edge[h - 1, :] = True
    bad = edge | ~torch.isfinite(n).all(dim=-1)
    return torch.where(bad[..., None], torch.inf, n)


def bilateral_filter(depth_mm: torch.Tensor, kernel_size: int = 7,
                     sigma_spatial: float = 4.5,
                     sigma_depth: float = 40.0) -> torch.Tensor:
    """Depth-preserving smoothing (bilateralKernel,
    image_kernels.cu:142-177) of int32 depth [H, W] or [B, H, W] over the
    window of radius kernel_size // 2, as the reference takes it (an even
    size is the next odd one; 1 leaves the depth as it is)."""
    return cuda_ops.bilateral(depth_mm, sigma_spatial, sigma_depth,
                              kernel_size)


def color_to_intensity(color: torch.Tensor,
                       ratio=(0.299, 0.587, 0.114)) -> torch.Tensor:
    """u8[h,w,3] -> f32[h,w] luminance (colorToIntensityKernel,
    image_kernels.cu:188-198, with the channel bug fixed)."""
    c = color.to(torch.float32) / 255.0
    return c[..., 0] * ratio[0] + c[..., 1] * ratio[1] + c[..., 2] * ratio[2]


def subsample_depth(depth_mm: torch.Tensor,
                    sigma_depth: float = 40.0) -> torch.Tensor:
    """Depth-aware 2x downsample (subsampleDepthKernel,
    image_kernels.cu:237-269): mean of the 5x5 window around (2y, 2x)
    gated to +-3 sigma of the centre sample; [.., H//2, W//2]."""
    return cuda_ops.gated_subsample(depth_mm, 3.0 * sigma_depth)


def subsample_depth_levels(depth_mm: torch.Tensor, levels: int,
                           sigma_depth: float = 40.0) -> List[torch.Tensor]:
    """`levels` successive subsample_depth results, coarser each time, made
    up to cuda_ops.MAX_PYRAMID_LEVELS at a time by one gated_pyramid
    launch."""
    out: List[torch.Tensor] = []
    while len(out) < levels:
        out += cuda_ops.gated_pyramid(
            out[-1] if out else depth_mm, 3.0 * sigma_depth,
            min(levels - len(out), cuda_ops.MAX_PYRAMID_LEVELS))
    return out


def subsample(img: torch.Tensor) -> torch.Tensor:
    """Plain 2x decimation of [..., h, w] (subsampleKernel,
    image_kernels.cu:291-306)."""
    return img[..., ::2, ::2]


def transform_vertex_map(vertex: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform with w=1 (transformVertexMapKernel,
    image_kernels.cu:206-215). INF rows propagate to non-finite."""
    return vertex @ T[:3, :3].T + T[:3, 3]


def transform_normal_map(normal: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform with w=0 (transformNormalMapKernel,
    image_kernels.cu:221-230)."""
    return normal @ T[:3, :3].T
