"""The per-frame SLAM pipeline: track -> fuse -> render (counterpart:
octree_slam_tpu/pipeline.py).

`step` runs one frame as plain eager PyTorch on whatever device the state
lives on: the depth pyramid (one bilateral launch + one gated-pyramid
launch for both subsampled levels), 19 Gauss-Newton ICP iterations against the previous frame, the
lazy SVO insert with its unique-cap remainder pages, the leaf-registry
append, and the splat render. Map state is updated in place where the JAX
step donates its buffers, so the state passed in must not be reused.

Its four stages run under torch.profiler ranges ("step.pyramid",
"step.track", "step.fuse", "step.render"), which cost nothing measurable
when no profiler is active.

The reference's on-device `lax.while_loop` remainder pager becomes a Python
loop that reads `unique_overflow` back once per page: that `.item()` is the
step's one host sync (one per frame when nothing overflows).

This slice leaves for later, and `check_supported` rejects: keyframe
tracking, the saturation gate, the insert directory cache, the photometric
term (w_rgbd > 0), eager interiors (lazy_interior=False), the host-driven
pager (device_remainder=False) and every render mode but "splat" and
"none". The dense-mip mirror is not allocated (`accel` is None); the splat
path never reads it, and the staleness flags a later slice needs to heal
it are computed exactly as the reference computes them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import Frame, PyramidLevel
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.render.splat import (LeafList, append_new_leaves,
                                                create_leaf_list,
                                                render_splat)
from octree_slam_tpu_torch.sensor import tracking

RENDER_MODES = ("splat", "none")


class SLAMState(NamedTuple):
    pool: SVONodePool
    leaves: LeafList
    accel: object              # dense-mip render cache: None in this slice
    pose: torch.Tensor         # f32[4,4] world_T_cam
    last_pyramid: Tuple[PyramidLevel, ...]
    initialized: torch.Tensor  # bool[] at least one frame ingested
    frame_idx: torch.Tensor    # i32[]
    diverged: torch.Tensor     # bool[] tracking lost at some frame
    interior_stale: torch.Tensor  # bool[] lazy frames deferred the mipmap
    mirror_stale: torch.Tensor    # bool[] dense mirror behind the leaves
    stamps_stale: torch.Tensor    # bool[] fused-dist stamps behind


class StepOutput(NamedTuple):
    framebuffer: torch.Tensor   # f32[H, W, 4]
    pose: torch.Tensor          # f32[4,4]
    track_inliers: torch.Tensor
    track_residual: torch.Tensor
    map_nodes: torch.Tensor     # i32[] total allocated nodes
    map_leaves: torch.Tensor    # i32[] leaf voxels registered
    map_overflowed: torch.Tensor  # bool[] any static capacity exceeded
    diverged: torch.Tensor
    unique_overflow: torch.Tensor  # bool[] False once the pages finished
    last_insert_key: torch.Tensor  # i32[] last page's resume cursor


def check_supported(cfg: SLAMConfig, render: str = "splat") -> None:
    """Raise NotImplementedError for a configuration outside this slice."""
    unported = {
        "track_keyframe": cfg.track_keyframe,
        "saturation_gate": cfg.saturation_gate,
        "insert_dircache": cfg.insert_dircache,
        "w_rgbd > 0": cfg.w_rgbd > 0.0,
        "lazy_interior=False": not cfg.lazy_interior,
        "device_remainder=False": not cfg.device_remainder,
        f"render={render!r}": render not in RENDER_MODES,
    }
    bad = [name for name, hit in unported.items() if hit]
    if bad:
        raise NotImplementedError(
            f"not ported to octree_slam_tpu_torch yet: {', '.join(bad)}")


def _accel_level(cfg: SLAMConfig) -> int:
    return max(1, min(cfg.accel_level, cfg.max_depth - 2))


def _fuse_colors(frame: Frame, cfg: SLAMConfig) -> torch.Tensor:
    """Frame colours on cfg.fuse_level's pixel grid, f32[N, 3] in [0,1]
    (the depth pyramid keeps the (2y, 2x) sample, so plain decimation keeps
    colours registered with the fused vertex map)."""
    colors = frame.color
    for _ in range(cfg.fuse_level):
        colors = colors[::2, ::2]
    return colors.reshape(-1, 3).to(torch.float32) / 255.0


def _empty_pyramid(cfg: SLAMConfig, device) -> Tuple[PyramidLevel, ...]:
    """INF maps with the shapes tracking.build_pyramid gives."""
    min_map_level = min(cfg.track_finest_level, cfg.fuse_level)
    levels = []
    for i in range(cfg.pyramid_depth):
        h, w = cfg.level_shape(i) if i >= min_map_level else (1, 1)
        levels.append(PyramidLevel(
            vertex=torch.full((h, w, 3), torch.inf, device=device),
            normal=torch.full((h, w, 3), torch.inf, device=device),
            intensity=torch.zeros(cfg.level_shape(i), device=device)))
    return tuple(levels)


def init_state(cfg: SLAMConfig, map_center=(0.0, 0.0, 0.0),
               initial_pose: torch.Tensor | None = None,
               device="cuda") -> SLAMState:
    """Empty map and identity (or `initial_pose`) camera on `device`. The
    root cell spans voxel_resolution * 2^(max_depth-1) around map_center,
    so leaves are exactly voxel_resolution."""
    check_supported(cfg)
    half_size = cfg.voxel_resolution * (2 ** (cfg.max_depth - 1))
    pool = svo.create(cfg.node_capacity, map_center, half_size, device=device)
    pose = (torch.eye(4, dtype=torch.float32, device=device)
            if initial_pose is None
            else torch.as_tensor(initial_pose, dtype=torch.float32)
            .to(device).clone())
    false = torch.tensor(False, device=device)
    return SLAMState(
        pool=pool,
        leaves=create_leaf_list(cfg.leaf_capacity, cfg.node_capacity,
                                device=device),
        accel=None,
        pose=pose,
        last_pyramid=_empty_pyramid(cfg, device),
        initialized=false,
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        diverged=false,
        interior_stale=false,
        mirror_stale=false,
        stamps_stale=false,
    )


def _fuse_once(pool, leaves, world_pts, colors, valid, cfg: SLAMConfig,
               min_key=None):
    """One lazy insert pass plus the registry append."""
    pool, st = svo.insert(pool, world_pts, colors, valid=valid,
                          depth=cfg.max_depth,
                          unique_cap=cfg.insert_unique_cap,
                          shallow_level=_accel_level(cfg), min_key=min_key)
    return pool, append_new_leaves(leaves, st), st


def step(state: SLAMState, frame: Frame, cfg: SLAMConfig,
         render: str = "splat") -> Tuple[SLAMState, StepOutput]:
    """One SLAM frame: preprocess -> ICP track -> fuse -> render
    (mainLoop, main.cpp:31-64, with RGBDCamera::update enabled)."""
    check_supported(cfg, render)
    dev = state.pose.device
    with record_function("step.pyramid"):
        pyramid = tracking.build_pyramid(frame.depth, frame.color, cfg)

    # track against the previous FRAME (rgbd_camera.cpp semantics)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    with record_function("step.track"):
        update_T, tstats = tracking.track(list(state.last_pyramid), pyramid,
                                          cfg)
    update_T = torch.where(state.initialized, update_T, eye)
    pose = state.pose @ update_T
    diverged = state.diverged | (state.initialized & tstats.diverged)

    # fuse: fuse-level camera points -> world -> lazy SVO insert. Lost
    # tracking gates fusion (rgbd_camera.cpp:148-151): the sticky flag when
    # a recovery loop can clear it, else this frame's flag alone.
    v = pyramid[cfg.fuse_level].vertex.reshape(-1, 3)
    world_pts = v @ pose[:3, :3].T + pose[:3, 3]
    colors = _fuse_colors(frame, cfg)
    gate = diverged if cfg.recovery_enabled \
        else (state.initialized & tstats.diverged)
    fuse_ok = (~gate).expand(world_pts.shape[0])
    with record_function("step.fuse"):
        pool, leaves, istats = _fuse_once(state.pool, state.leaves,
                                          world_pts, colors, fuse_ok, cfg)
        # unique-cap remainder pages, in sorted key order: each leaf still
        # blends once. The one host read of the step.
        uo, lk = istats.unique_overflow, istats.last_key
        while uo.item():
            pool, leaves, st = _fuse_once(pool, leaves, world_pts, colors,
                                          fuse_ok, cfg, min_key=lk)
            uo, lk = st.unique_overflow, st.last_key

    if render == "splat":
        with record_function("step.render"):
            fb = render_splat(pool, leaves, pose, cfg.focal_x, cfg.focal_y,
                              width=cfg.width, height=cfg.height,
                              depth=cfg.max_depth, max_range=cfg.max_range)
    else:
        fb = torch.zeros((cfg.height, cfg.width, 4), device=dev)

    # flags made on the device: torch.tensor(True, device=...) would be a
    # synchronising host-to-device copy
    true = torch.ones((), dtype=torch.bool, device=dev)
    new_state = SLAMState(
        pool=pool,
        leaves=leaves,
        accel=state.accel,
        pose=pose,
        last_pyramid=tuple(pyramid),
        initialized=true,
        frame_idx=state.frame_idx + 1,
        diverged=diverged,
        # every frame of this slice is lazy: interiors and the dense mirror
        # fall behind, and a splat/none frame never re-stamps
        interior_stale=true,
        mirror_stale=true if cfg.use_dense_mips else state.mirror_stale,
        stamps_stale=(true if cfg.use_dense_mips and cfg.cone_band_fused_dist
                      else ~true),
    )
    out = StepOutput(
        framebuffer=fb,
        pose=pose,
        track_inliers=tstats.inliers,
        track_residual=tstats.residual,
        map_nodes=pool.n_nodes,
        map_leaves=leaves.count,
        map_overflowed=pool.overflowed | leaves.overflowed,
        diverged=diverged,
        unique_overflow=uo,
        last_insert_key=lk,
    )
    return new_state, out
