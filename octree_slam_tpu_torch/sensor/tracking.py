"""Point-to-plane ICP camera tracking over an image pyramid (counterpart:
octree_slam_tpu/sensor/tracking.py).

Same estimator as the reference package: projective association by pixel
index, the symmetric point-to-plane residual with Huber IRLS weights (the
config defaults), a 6x6 normal-equation solve by Cholesky and an SE(3)
exponential update, coarse to fine with cfg.pyramid_iters. The Gram
products are strict float32 (the JAX code's Precision.HIGHEST): callers on
a GPU keep torch.backends.cuda.matmul.allow_tf32 False, its default.

Divergence handling: torch.linalg.cholesky_ex reports a matrix that is not
positive definite through `info` instead of NaNs, so the solve maps
info > 0 to NaN and the update is frozen exactly as in the JAX code. The
Gauss-Newton loop reads nothing back to the host.

Left for later: the photometric term (`rgbd_normal_equations`,
cfg.w_rgbd > 0) and the keyframe seed (`init_T`); pipeline.check_supported
rejects both configurations.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu_torch.core import se3
from octree_slam_tpu_torch.core.types import PyramidLevel
from octree_slam_tpu_torch.sensor import image_ops


class TrackStats(NamedTuple):
    inliers: torch.Tensor    # i32[levels] inlier count at final iter per level
    residual: torch.Tensor   # f32[levels] mean |r| at final iter per level
    diverged: torch.Tensor   # bool[] any failed solve


def build_pyramid(depth_mm: torch.Tensor, color: torch.Tensor,
                  cfg: SLAMConfig) -> List[PyramidLevel]:
    """Bilateral filter + intensity + per-level vertex/normal maps
    (rgbd_camera.cpp:61-93). Level 0 is full resolution; levels finer than
    every consumer (track_finest_level, fuse_level) carry 1x1 INF
    placeholders like the reference package."""
    filtered = image_ops.bilateral_filter(
        depth_mm, kernel_size=cfg.bilateral_kernel_size,
        sigma_spatial=cfg.bilateral_sigma_spatial,
        sigma_depth=cfg.bilateral_sigma_depth)
    intensity = image_ops.color_to_intensity(color, cfg.intensity_ratio)
    levels = []
    d, inten = filtered, intensity
    min_map_level = min(cfg.track_finest_level, cfg.fuse_level)
    for i in range(cfg.pyramid_depth):
        if i >= min_map_level:
            vertex = image_ops.generate_vertex_map(
                d, cfg.focal_x, cfg.focal_y, (cfg.width, cfg.height))
            normal = image_ops.generate_normal_map(vertex)
        else:
            vertex = torch.full((1, 1, 3), torch.inf, device=d.device)
            normal = torch.full((1, 1, 3), torch.inf, device=d.device)
        levels.append(PyramidLevel(vertex=vertex, normal=normal,
                                   intensity=inten))
        if i != cfg.pyramid_depth - 1:
            d = image_ops.subsample_depth(d, cfg.bilateral_sigma_depth)
            inten = image_ops.subsample(inten)
    return levels


def icp_normal_equations(v1: torch.Tensor, n1: torch.Tensor,
                         v2: torch.Tensor, n2: torch.Tensor,
                         cfg: SLAMConfig):
    """Build (A = sum w J J^T, b = sum w r J) over same-index
    correspondences. v1/n1: last-frame maps, v2/n2: current maps already
    in the last frame. Gates per localization_kernels.cu:186-204.
    Returns (A f32[6,6], b f32[6], inlier_count i32[], mean_abs_residual)."""
    v1 = v1.reshape(-1, 3)
    n1 = n1.reshape(-1, 3)
    v2 = v2.reshape(-1, 3)
    n2 = n2.reshape(-1, 3)

    finite = (torch.isfinite(v1).all(-1) & torch.isfinite(v2).all(-1)
              & torch.isfinite(n1).all(-1) & torch.isfinite(n2).all(-1))
    fm = finite[:, None]
    v1c = torch.where(fm, v1, 0.0)
    v2c = torch.where(fm, v2, 0.0)
    n1c = torch.where(fm, n1, 0.0)
    n2c = torch.where(fm, n2, 0.0)

    z_ok = ((v1c[:, 2] > cfg.icp_z_min) & (v2c[:, 2] > cfg.icp_z_min)
            & (v1c[:, 2] < cfg.icp_z_max) & (v2c[:, 2] < cfg.icp_z_max))
    diff = v2c - v1c
    dist_ok = torch.sum(diff * diff, dim=-1) <= cfg.icp_dist_thresh ** 2
    norm_ok = torch.sum(n2c * n1c, dim=-1) >= cfg.icp_norm_thresh
    mask = finite & z_ok & dist_ok & norm_ok

    # symmetric point-to-plane (Rusinkiewicz 2019) projects the residual on
    # both normals; the one-sided form is the reference estimator
    ns = n1c + n2c if cfg.icp_symmetric else n1c
    J = torch.cat([torch.linalg.cross(v2c, ns, dim=-1), ns], dim=-1)
    r = torch.sum(ns * (v1c - v2c), dim=-1)
    w = mask.to(torch.float32)
    if cfg.icp_huber_k > 0.0:
        w = w * torch.clamp(
            cfg.icp_huber_k / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
    A = (J * w[:, None]).T @ J
    b = (r * w) @ J
    count = mask.sum(dtype=torch.int32)
    mean_res = torch.sum(torch.abs(r) * w) / torch.clamp(
        count.to(torch.float32), min=1.0)
    return A, b, count, mean_res


def solve_normal_equations(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b by Cholesky with tiny Tikhonov damping. A matrix that
    is not positive definite yields NaN, as jax.scipy's cho_factor does."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    damped = A + 1e-6 * torch.trace(A) * eye + 1e-12 * eye
    L, info = torch.linalg.cholesky_ex(damped)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info > 0, torch.nan, x)


def _track_level(last: PyramidLevel, cur: PyramidLevel, update_T,
                 iters: int, cfg: SLAMConfig):
    """`iters` Gauss-Newton iterations at one pyramid level."""
    v1, n1 = last.vertex, last.normal
    v2, n2 = cur.vertex, cur.normal
    T = update_T
    diverged = torch.zeros((), dtype=torch.bool, device=T.device)
    zero = torch.zeros(6, dtype=T.dtype, device=T.device)
    count = res = None
    for _ in range(iters):
        v2t = image_ops.transform_vertex_map(v2, T)
        n2t = image_ops.transform_normal_map(n2, T)
        A, b, count, res = icp_normal_equations(v1, n1, v2t, n2t, cfg)
        x = solve_normal_equations(A, b)
        bad = ~torch.isfinite(x).all() | (count < 6)
        # twist is [omega, v] = [x[:3], x[3:]] by the Jacobian layout
        T = se3.exp_se3(torch.where(bad, zero, x)) @ T
        diverged = diverged | bad
    return T, diverged, count, res


def track(last_pyramid: List[PyramidLevel],
          current_pyramid: List[PyramidLevel],
          cfg: SLAMConfig) -> Tuple[torch.Tensor, TrackStats]:
    """Coarse-to-fine ICP: returns cam_{t-1}_T_cam_t (the transform
    aligning the current camera frame onto the last one) and health stats
    (rgbd_camera.cpp:102-170 schedule)."""
    dev = current_pyramid[0].intensity.device
    update_T = torch.eye(4, dtype=torch.float32, device=dev)
    diverged = torch.zeros((), dtype=torch.bool, device=dev)
    inliers, residuals = [], []
    tfl = cfg.track_finest_level
    if len(cfg.pyramid_iters) < cfg.pyramid_depth - tfl:
        raise ValueError(
            f"pyramid_iters needs {cfg.pyramid_depth - tfl} entries for "
            f"pyramid_depth={cfg.pyramid_depth}, track_finest_level={tfl}")
    for level in range(cfg.pyramid_depth - 1, tfl - 1, -1):
        update_T, div, count, res = _track_level(
            last_pyramid[level], current_pyramid[level], update_T,
            cfg.pyramid_iters[level - tfl], cfg)
        diverged = diverged | div
        inliers.append(count)
        residuals.append(res)
    # skipped finer levels report the finest tracked level's stats
    for _ in range(tfl):
        inliers.append(inliers[-1])
        residuals.append(residuals[-1])
    return update_T, TrackStats(inliers=torch.stack(inliers),
                                residual=torch.stack(residuals),
                                diverged=diverged)
