"""The per-frame SLAM pipeline: track -> fuse -> render (counterpart:
octree_slam_tpu/pipeline.py).

`step` runs one frame as plain eager PyTorch on whatever device the state
lives on: the depth pyramid (one bilateral launch + one gated-pyramid
launch for both subsampled levels), 19 Gauss-Newton ICP iterations against
the previous frame, the SVO insert with its unique-cap remainder pages, the
leaf-registry append, and the render: "splat" (z-resolved leaf splat),
"cone" (slab cone, render/conesplat.py), "cone_march" (the exact march of
render/raycast.py) or "none". Map state is updated in place where the JAX
step donates its buffers, so a state passed in must not be reused;
`convert.clone_state` copies one that has to be.

Splat, slab-cone and "none" frames are lazy when cfg.lazy_interior: the
insert blends leaves only, and the interior values and the dense mirror
(`accel`, a mips.RenderCache when cfg.use_dense_mips, else a raycast
AccelGrid) fall behind, which the three staleness flags record exactly as
the reference does. A "cone_march" frame, and every frame when
lazy_interior is off, is eager: it first heals what lazy frames left
behind (svo.refresh_interior + mips.rebuild_from_pool), then re-mipmaps
along the touched paths and updates the mirror with the insert.

The step's stages run under torch.profiler ranges ("step.pyramid",
"step.track", "step.heal", "step.fuse", "step.render"), which cost nothing
measurable when no profiler is active.

Host reads per frame. The reference's on-device `lax.while_loop` remainder
pager is a Python loop that reads `unique_overflow` back once per page
(one read when nothing overflows). Its `lax.cond` heal is a read of
`interior_stale | mirror_stale`, once per eager frame under lazy_interior.
The marches read their exit tests every raycast.EXIT_CHECK_EVERY trips.
The splat, slab-cone and "none" frames keep one read per frame.

`check_supported` rejects what is left for later slices: keyframe
tracking, the saturation gate, the insert directory cache, the photometric
term (w_rgbd > 0), the host-driven pager (device_remainder=False) and the
hybrid renderer ("cone_hybrid") with its leaf-level mirror upkeep.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import Frame, PyramidLevel
from octree_slam_tpu_torch.map import mips, svo
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.render import conesplat, raycast
from octree_slam_tpu_torch.render.splat import (LeafList, append_new_leaves,
                                                create_leaf_list,
                                                render_splat)
from octree_slam_tpu_torch.sensor import tracking

RENDER_MODES = ("splat", "none", "cone", "cone_march")


class SLAMState(NamedTuple):
    pool: SVONodePool
    leaves: LeafList
    accel: object              # mips.RenderCache if cfg.use_dense_mips,
                               # else raycast.AccelGrid
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
    lvl = _accel_level(cfg)
    pose = (torch.eye(4, dtype=torch.float32, device=device)
            if initial_pose is None
            else torch.as_tensor(initial_pose, dtype=torch.float32)
            .to(device).clone())
    false = torch.tensor(False, device=device)
    return SLAMState(
        pool=pool,
        leaves=create_leaf_list(cfg.leaf_capacity, cfg.node_capacity,
                                device=device),
        accel=(mips.create(max_depth=cfg.max_depth, dist_level=lvl,
                           max_skip=cfg.dist_max_skip, device=device)
               if cfg.use_dense_mips else raycast.build_accel(pool, level=lvl)),
        pose=pose,
        last_pyramid=_empty_pyramid(cfg, device),
        initialized=false,
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        diverged=false,
        interior_stale=false,
        mirror_stale=false,
        stamps_stale=false,
    )


def heal_for_march(state: SLAMState, cfg: SLAMConfig):
    """Heal lazy-interior staleness for a direct marcher call: lazy frames
    leave the interior node values and the dense mirror stale, and whatever
    calls raycast.cone_trace_dense outside `step` must refresh both first
    (`step` heals itself, and only for render="cone_march"). The pool's
    values are refreshed in place; the mirror is a new one. Returns (pool,
    cache) ready for the marcher. Idempotent."""
    pool = svo.refresh_interior(state.pool, depth=cfg.max_depth)
    cache = mips.rebuild_from_pool(pool, max_depth=cfg.max_depth,
                                   dist_level=_accel_level(cfg),
                                   max_skip=cfg.dist_max_skip)
    return pool, cache


def _fuse_once(pool, leaves, accel, world_pts, colors, valid,
               cfg: SLAMConfig, *, eager: bool, with_dist: bool,
               min_key=None):
    """One insert pass, the registry append and the dense mirror's upkeep:
    the one definition behind the step's first insert and its remainder
    pages. Without dense mips the AccelGrid is not kept up here: only the
    exact march reads it, and the step's cone_march branch rebuilds it."""
    lvl = _accel_level(cfg)
    mirror = cfg.use_dense_mips and eager
    pool, st = svo.insert(pool, world_pts, colors, valid=valid,
                          depth=cfg.max_depth,
                          unique_cap=cfg.insert_unique_cap,
                          shallow_level=lvl, min_key=min_key,
                          update_interior=eager, emit_mips=mirror)
    leaves = append_new_leaves(leaves, st)
    if mirror:
        # mirror this insert's touched values and occupancy; the distance
        # field only when the exact march reads it this frame
        accel = mips.update(accel, st.mip_idx, st.mip_val,
                            max_depth=cfg.max_depth, dist_level=lvl,
                            max_skip=cfg.dist_max_skip, with_dist=with_dist)
    return pool, leaves, accel, st


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

    # fuse: fuse-level camera points -> world -> SVO insert. Lost
    # tracking gates fusion (rgbd_camera.cpp:148-151): the sticky flag when
    # a recovery loop can clear it, else this frame's flag alone.
    v = pyramid[cfg.fuse_level].vertex.reshape(-1, 3)
    world_pts = v @ pose[:3, :3].T + pose[:3, 3]
    colors = _fuse_colors(frame, cfg)
    gate = diverged if cfg.recovery_enabled \
        else (state.initialized & tstats.diverged)
    fuse_ok = (~gate).expand(world_pts.shape[0])
    # An eager frame (the exact march, or lazy_interior off) updates the
    # mirror incrementally, so it first heals what earlier lazy frames left
    # behind: the interior values, or a mirror that other renders skipped.
    eager = (not cfg.lazy_interior) or render == "cone_march"
    lvl = _accel_level(cfg)
    pool, accel = state.pool, state.accel
    if eager and cfg.lazy_interior:
        with record_function("step.heal"):
            if (state.interior_stale | state.mirror_stale).item():
                pool = svo.refresh_interior(pool, depth=cfg.max_depth)
                if cfg.use_dense_mips:
                    accel = mips.rebuild_from_pool(
                        pool, max_depth=cfg.max_depth, dist_level=lvl,
                        max_skip=cfg.dist_max_skip)

    with record_function("step.fuse"):
        pool, leaves, accel, istats = _fuse_once(
            pool, state.leaves, accel, world_pts, colors, fuse_ok, cfg,
            eager=eager, with_dist=(render == "cone_march"))
        # unique-cap remainder pages, in sorted key order: each leaf still
        # blends once. One host read per page.
        uo, lk = istats.unique_overflow, istats.last_key
        paged = False
        while uo.item():
            pool, leaves, accel, st = _fuse_once(
                pool, leaves, accel, world_pts, colors, fuse_ok, cfg,
                eager=eager, with_dist=False, min_key=lk)
            uo, lk = st.unique_overflow, st.last_key
            paged = True
        if paged and cfg.use_dense_mips and render == "cone_march":
            # the pages updated the occupancy without the distance field:
            # redo it, or this frame's march would skip through the
            # geometry they inserted
            accel = mips.refresh_dist(accel, dist_level=lvl,
                                      max_skip=cfg.dist_max_skip)

    with record_function("step.render"):
        if render == "cone":
            spec = conesplat.make_slab_spec(
                width=cfg.width, height=cfg.height, fx=cfg.focal_x,
                leaf_size=cfg.voxel_resolution, z_near=cfg.cone_znear,
                z_far=cfg.max_range, n_slabs=cfg.cone_slabs,
                max_scale=cfg.cone_max_scale)
            fb = conesplat.render_cone_splat(
                leaves, pool.center, pool.half_size, pose, cfg.focal_x,
                cfg.focal_y, spec=spec, depth=cfg.max_depth)
        elif render == "cone_march" and cfg.use_dense_mips:
            s = max(1, cfg.cone_scale)
            if cfg.width % s or cfg.height % s:
                raise ValueError("cone_scale must divide the frame size")
            fb = raycast.cone_trace_dense(
                accel, pool.center, pool.half_size, pose, cfg.focal_x / s,
                cfg.focal_y / s, width=cfg.width // s,
                height=cfg.height // s, max_depth=cfg.max_depth,
                dist_level=lvl, max_iters=cfg.max_march_iters,
                max_range=cfg.max_range, start_dist=cfg.start_dist,
                max_skip=cfg.dist_max_skip)
            # nearest upsample back to the display resolution
            fb = conesplat._upsample(fb, s)
        elif render == "cone_march":
            # the fuse path does not keep the entry grid up (_fuse_once):
            # rebuild it for this march frame
            accel = raycast.build_accel(pool, level=lvl)
            fb = raycast.cone_trace(
                pool, pose, cfg.focal_x, cfg.focal_y, width=cfg.width,
                height=cfg.height, max_depth=cfg.max_depth,
                max_iters=cfg.max_march_iters, max_range=cfg.max_range,
                start_dist=cfg.start_dist, accel=accel, accel_level=lvl)
        elif render == "splat":
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
        accel=accel,
        pose=pose,
        last_pyramid=tuple(pyramid),
        initialized=true,
        frame_idx=state.frame_idx + 1,
        diverged=diverged,
        # an eager frame healed and updated interiors and mirror; a lazy
        # one leaves both behind. None of these renders stamps the
        # mirror's free cells (the hybrid's, a later slice).
        interior_stale=~true if eager else true,
        mirror_stale=((~true if eager else true) if cfg.use_dense_mips
                      else state.mirror_stale),
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
