"""Tracking-loss recovery: relocalize the camera against renders of the map
(counterpart: octree_slam_tpu/relocalize.py).

The reference prints "Camera tracking is lost" and gives up
(rgbd_camera.cpp:148-151). Here, as in the reference package:

  1. the app keeps a small ring of keyposes while tracking is healthy
     (every cfg.keypose_every frames);
  2. on divergence each recent keypose is a candidate: the leaf registry
     is splatted into a packed z-buffer at that pose, a vertex/normal
     pyramid is built from it, and the live frame is tracked against that
     rendered view with the production coarse-to-fine ICP;
  3. the accepted candidate with the most full-resolution inliers
     (at least cfg.reloc_min_inlier_frac of the tracked pixels) re-anchors
     the pose.

One attempt splats the K candidates' z-buffers, builds their K pyramids as
one batch (one bilateral launch and one gated-pyramid launch over
[K, H, W], where the reference package maps a per-candidate build without
its TPU kernels), tracks the K candidates one after another, and reads the
packed [K, 19] scores back once.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import PyramidLevel
from octree_slam_tpu_torch.render.splat import (EMPTY, LeafList,
                                                dilate_zbuffer, leaf_zbuffer)
from octree_slam_tpu_torch.sensor import tracking


def _depth_from_zbuffer(buf: torch.Tensor, cfg: SLAMConfig) -> torch.Tensor:
    """Packed splat z-buffer(s) i32[..., H*W] -> the quantised depth as
    integer millimetres i32[..., H, W], holes closed first: a leaf centre
    splats one point, and a sparse view gives no normals. The cast
    truncates toward zero and saturates at 65,535 mm, as the reference's
    float32 -> uint16 convert does on XLA (a cast through torch.uint16
    would wrap instead)."""
    img = dilate_zbuffer(buf, width=cfg.width, height=cfg.height, rounds=3)
    qz = torch.where(img != EMPTY, img >> 16, 0)
    mm = qz.to(torch.float32) * (cfg.max_range / 32766.0) * 1e3
    return mm.clamp(max=65535.0).to(torch.int32)


def pyramid_from_zbuffer(buf: torch.Tensor, cfg: SLAMConfig):
    """Packed splat z-buffer(s) i32[..., H*W] (depth << 16 | rgb565) ->
    synthetic vertex/normal pyramid with the same leading batch: the
    sensor preprocessing on the unpacked depth."""
    depth_mm = _depth_from_zbuffer(buf, cfg)
    color = torch.zeros(depth_mm.shape + (3,), dtype=torch.uint8,
                        device=buf.device)
    return tracking.build_pyramid(depth_mm, color, cfg)


def _zbuffer(leaves: LeafList, center, half_size, pose,
             cfg: SLAMConfig) -> torch.Tensor:
    return leaf_zbuffer(leaves.vals, leaves.keys, leaves.count, center,
                        half_size, pose, cfg.focal_x, cfg.focal_y,
                        width=cfg.width, height=cfg.height,
                        depth=cfg.max_depth, max_range=cfg.max_range)


def model_pyramid(leaves: LeafList, center: torch.Tensor, half_size,
                  pose: torch.Tensor, cfg: SLAMConfig):
    """The map's synthetic vertex/normal pyramid as seen from `pose`. Good
    for coarse alignment only: leaves render blocky and the dilation biases
    depth toward the camera."""
    return pyramid_from_zbuffer(_zbuffer(leaves, center, half_size, pose,
                                         cfg), cfg)


def _score_pyramid(model_pyr, candidate: torch.Tensor, live_pyramid,
                   cfg: SLAMConfig) -> torch.Tensor:
    """ICP the live pyramid against one model pyramid. Returns one packed
    f32[19] row: pose.ravel() ++ [inliers, residual, ok], with
    pose = candidate @ update."""
    update_T, stats = tracking.track(list(model_pyr), list(live_pyramid),
                                     cfg)
    pose = candidate @ update_T
    # rows run coarse -> fine; the last is the finest tracked level, whose
    # num_pixels >> 2*track_finest_level pixels the inlier share is of
    inliers = stats.inliers[-1]
    n_px_tracked = cfg.num_pixels >> (2 * cfg.track_finest_level)
    min_inl = int(cfg.reloc_min_inlier_frac * n_px_tracked)
    ok = ~stats.diverged & (inliers >= min_inl) & torch.isfinite(pose).all()
    return torch.cat([pose.reshape(-1),
                      torch.stack([inliers.to(torch.float32),
                                   stats.residual[-1],
                                   ok.to(torch.float32)])])


def score_zbuffer(buf: torch.Tensor, candidate: torch.Tensor, live_pyramid,
                  cfg: SLAMConfig) -> torch.Tensor:
    """Score one candidate from a pre-rendered packed z-buffer: the same
    f32[19] row as score_candidates."""
    return _score_pyramid(pyramid_from_zbuffer(buf, cfg), candidate,
                          live_pyramid, cfg)


def score_candidates(leaves: LeafList, center: torch.Tensor, half_size,
                     candidates: torch.Tensor, live_pyramid,
                     cfg: SLAMConfig) -> torch.Tensor:
    """All K candidates f32[K, 4, 4] -> packed scores f32[K, 19] on the
    device: K splats, one batched pyramid build, K trackings."""
    bufs = torch.stack([_zbuffer(leaves, center, half_size, c, cfg)
                        for c in candidates])
    batch = pyramid_from_zbuffer(bufs, cfg)
    return torch.stack([
        _score_pyramid([PyramidLevel(*(x[k] for x in lvl)) for lvl in batch],
                       candidates[k], live_pyramid, cfg)
        for k in range(candidates.shape[0])])


def relocalize(state, cfg: SLAMConfig, keyposes: List[np.ndarray]
               ) -> Tuple[np.ndarray | None, bool, dict]:
    """Try the most recent cfg.reloc_candidates keyposes against the live
    frame (state.last_pyramid), padded to K with the oldest of them.
    Returns (pose, ok, diagnostics); the accepted candidate with the most
    inliers wins."""
    cands = [np.asarray(c, np.float32)
             for c in keyposes[::-1][:cfg.reloc_candidates]]
    if not cands:
        return None, False, {"candidates_tried": 0, "inliers": -1,
                             "residual": None}
    tried = len(cands)
    while len(cands) < cfg.reloc_candidates:
        cands.append(cands[-1])
    dev = state.pose.device
    host = score_candidates(
        state.leaves, state.pool.center, state.pool.half_size,
        torch.from_numpy(np.stack(cands)).to(dev), state.last_pyramid,
        cfg).cpu().numpy()
    ok = host[:, 18] > 0
    best_pose, best_inl, best_res = None, -1, None
    if ok.any():
        k = int(np.argmax(np.where(ok, host[:, 16], -1)))
        best_pose = host[k, :16].reshape(4, 4)
        best_inl = int(host[k, 16])
        best_res = float(host[k, 17])
    return best_pose, best_pose is not None, {
        "candidates_tried": tried, "inliers": best_inl,
        "residual": best_res}
