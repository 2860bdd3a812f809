"""The per-frame SLAM pipeline: track -> fuse -> render (counterpart:
octree_slam_tpu/pipeline.py).

`step` runs one frame as plain eager PyTorch on whatever device the state
lives on: the depth pyramid (one bilateral launch, bilateral7x7 or at
another cfg.bilateral_kernel_size bilateral_window, + one gated-pyramid
launch for both subsampled levels), 19 Gauss-Newton ICP iterations against
the previous frame (or, with cfg.track_keyframe, against the keyframe
anchor), the SVO insert with its unique-cap remainder pages, the
leaf-registry append, and the render: "splat" (z-resolved leaf splat),
"cone" (slab cone, render/conesplat.py), "cone_hybrid" (the slab cone with
its edge band re-rendered by a seeded exact march, render/hybrid.py),
"cone_march" (the exact march of render/raycast.py) or "none". Map state
is updated in place where the JAX step donates its buffers, so a state
passed in must not be reused; `convert.clone_state` copies one that has to
be.

Splat, slab-cone, hybrid and "none" frames are lazy when
cfg.lazy_interior: the insert blends leaves only, and the interior values
and the dense mirror (`accel`, a mips.RenderCache when cfg.use_dense_mips,
else a raycast.AccelGrid) fall behind, which the three staleness flags
record exactly as the reference does. A "cone_march" frame, and every frame
when lazy_interior is off, is eager: it first heals what lazy frames left
behind (svo.refresh_interior + mips.rebuild_from_pool), then re-mipmaps
along the touched paths and updates the mirror with the insert. A lazy
hybrid frame keeps the part of the mirror its band march reads: the leaf
level (one scatter of the touched leaves' words), the occupancy (one
scatter of the first-seen leaves), and, only when leaves were created or
a flag says so, the distance field and the free cells' distance stamps
(mips.encode_free_dist).

Optional branches, all off by default: the keyframe anchor
(cfg.track_keyframe), the saturation gate (cfg.saturation_gate: a bitmask
of leaves at alpha 255 whose points are dropped before the insert's sort),
the photometric term (cfg.w_rgbd > 0), the insert's directory cache
(cfg.insert_dircache) and the host-driven pager
(cfg.device_remainder=False: `step` returns unique_overflow and
last_insert_key, and the caller finishes the frame with
`insert_remainder`).

The step's stages are spans (utils/spans.py): "step.pyramid",
"step.track" (a "track.level<L>" span a pyramid level), "step.heal"
(counter `mirror_rebuilds`), "step.fuse" (a "fuse.pass" span an insert
pass, which counts the pass and its distinct and first-seen leaves),
"step.render" and, on a hybrid frame, "step.band": the band march and
merge (render/hybrid.band_march_merge, its "band.*" spans) after
"step.render"'s distance refresh, stamps and slab cone. "step.band" is a
sibling of "step.render", not inside it, so that a profiler trace that
credits a kernel to the latest-started "step.*" range still credits the
slab cone's kernels to "step.render". `dist_refreshes` and `dist_stamps`
count the step's mips.refresh_dist and mips.encode_free_dist calls. The
host reads below are "sync.heal" and "sync.pager" spans. Off, with no
profiler running, a span is a flag check that returns one shared object:
0.24-0.62 us on the H100 machine's host, under 10 us of a 60-90 ms frame
at its 13.4 spans a frame (the idle record_function ranges it replaces
cost 6.7-12.3 us each); with a profiler running it is a record_function
range as before. Recording, a span costs 2.4-3.3 us there, about 38 us a frame
(0.05%).

Host reads per frame. The reference's on-device `lax.while_loop` remainder
pager is a Python loop that reads `unique_overflow` back once per page
(one read when nothing overflows; none with device_remainder=False). Its
`lax.cond` heal is a read of the stale flags, once per eager frame under
lazy_interior and once per lazy hybrid frame. A lazy hybrid frame's
re-stamp trigger rides the pager's first read. The exact march reads its
exit tests every raycast.EXIT_CHECK_EVERY trips (from compact_after trips
on, the live count, which also decides the compaction: no read more); the
hybrid's band march has a fixed trip count and reads nothing (but with
cfg.cone_band_compact_after < cfg.cone_band_iters, whose march tests its
exit as the exact march does). So splat, slab-cone and "none" frames take
one read, a lazy hybrid frame two.

`grow_state` doubles the node pool and/or the leaf registry between
frames (the app loop's growth policy).

`check_supported` raises where the reference raises (the hybrid without
the dense mirror) or would silently render black (an unknown render);
every band knob of the hybrid (render/hybrid.py) and every
bilateral_kernel_size runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import Frame, PyramidLevel
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import mips, morton, svo
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.render import conesplat, hybrid, raycast
from octree_slam_tpu_torch.render.splat import (LeafList,
                                                append_new_leaves_cached,
                                                create_leaf_list,
                                                leaf_list_from_extraction,
                                                pad_leaf_list, render_splat)
from octree_slam_tpu_torch.sensor import tracking
from octree_slam_tpu_torch.utils import compaction, spans

RENDER_MODES = ("splat", "none", "cone", "cone_hybrid", "cone_march")


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
    # keyframe anchor (cfg.track_keyframe; empty when off)
    key_pyramid: Tuple[PyramidLevel, ...]  # the anchor frame's maps
    key_pose: torch.Tensor     # f32[4,4] world_T_key ((0,) when off)
    key_T_cam: torch.Tensor    # f32[4,4] key_T_cam of the previous frame,
                               # the Gauss-Newton seed ((0,) when off)
    # insert directory cache (cfg.insert_dircache; (0,) when off): the last
    # primary insert's leaf key -> (node, post-blend word, registry
    # position). reset_dircache clears it whenever node indices, leaf
    # values or registry positions change under the map.
    dir_keys: torch.Tensor     # i32[U] morton keys, INVALID_KEY = dead row
    dir_nodes: torch.Tensor    # i32[U] leaf node indices, -1 = dead row
    dir_vals: torch.Tensor     # i32[U] the keys' current packed words
    dir_pos: torch.Tensor      # i32[U] registry positions, -1 = unknown
    # saturation-gate bitmask (cfg.saturation_gate; (0,) when off): bit
    # (key & 31) of word (key >> 5) is set iff the leaf at that key has
    # reached alpha 255, where a blend moves a channel only for a
    # difference of 128 levels or more. Bits are set by an integer add on
    # the once-in-a-lifetime transition (InsertStats.sat_transition), an
    # exact OR; bit 31 is the int32 sign bit, so readers mask with & 1
    # after the (arithmetic) shift. A pool rebuild that changes the key
    # space or drops leaves must call rebuild_sat_mask.
    sat_mask: torch.Tensor     # i32[2^(3*max_depth) / 32]
    # True when a lazy frame since the last rebuild did not keep the
    # mirror's leaf level and occupancy (splat / cone / none frames)
    mirror_stale: torch.Tensor    # bool[]
    # True when the mirror's free leaf cells lack current distance stamps
    # although its content may be current (eager frames that are not
    # hybrid update content and never stamp)
    stamps_stale: torch.Tensor    # bool[]


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
    """Raise ValueError for a (cfg, render) pair `step` cannot run: an
    unknown render, or the hybrid without the dense mirror its band march
    samples (the reference's assert)."""
    if render not in RENDER_MODES:
        raise ValueError(f"render={render!r} is none of {RENDER_MODES}")
    if render == "cone_hybrid" and not cfg.use_dense_mips:
        raise ValueError("render='cone_hybrid' needs cfg.use_dense_mips "
                         "(the band march samples the dense leaf mip)")


def _accel_level(cfg: SLAMConfig) -> int:
    return max(1, min(cfg.accel_level, cfg.max_depth - 2))


def _miss_cap(cfg: SLAMConfig) -> int:
    """Lanes of the directory cache's miss descent: cfg.insert_miss_cap,
    or a quarter of the unique cap (camera motion between two frames
    first-sees a few percent of a frame's leaves)."""
    if cfg.insert_miss_cap > 0:
        return min(cfg.insert_miss_cap, cfg.insert_unique_cap)
    return min(max(1024, cfg.insert_unique_cap // 4), cfg.insert_unique_cap)


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
    half_size = cfg.voxel_resolution * (2 ** (cfg.max_depth - 1))
    pool = svo.create(cfg.node_capacity, map_center, half_size, device=device)
    lvl = _accel_level(cfg)
    pose = (torch.eye(4, dtype=torch.float32, device=device)
            if initial_pose is None
            else torch.as_tensor(initial_pose, dtype=torch.float32)
            .to(device).clone())
    false = torch.tensor(False, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    empty_f = torch.zeros((0,), dtype=torch.float32, device=device)
    U = cfg.insert_unique_cap if cfg.insert_dircache else 0
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
        key_pyramid=(_empty_pyramid(cfg, device) if cfg.track_keyframe
                     else ()),
        key_pose=pose.clone() if cfg.track_keyframe else empty_f,
        key_T_cam=(torch.eye(4, dtype=torch.float32, device=device)
                   if cfg.track_keyframe else empty_f),
        dir_keys=torch.full((U,), morton.INVALID_KEY, **i32),
        dir_nodes=torch.full((U,), -1, **i32),
        dir_vals=torch.zeros((U,), **i32),
        dir_pos=torch.full((U,), -1, **i32),
        sat_mask=torch.zeros(
            ((1 << (3 * cfg.max_depth)) // 32 if cfg.saturation_gate else 0,),
            **i32),
        mirror_stale=false,
        stamps_stale=false,
    )


def _add_sat_bits(mask: torch.Tensor, keys: torch.Tensor,
                  on: torch.Tensor) -> torch.Tensor:
    """Set the bit of every key whose `on` is true, in place. Each such
    key sets its bit once in its life, so the integer add is an exact OR
    even where several rows share a word (1 << 31 wraps to the sign bit,
    as it must)."""
    k = torch.where(on, keys, 0)
    bits = torch.where(on, torch.bitwise_left_shift(torch.ones_like(k),
                                                    k & 31), 0)
    return mask.index_add_(0, (k >> 5).to(torch.int64), bits)


def _saturated(mask: torch.Tensor, world_pts: torch.Tensor, pool,
               cfg: SLAMConfig) -> torch.Tensor:
    """bool[N]: the point's leaf has its bit set in the saturation mask."""
    keys, valid = morton.encode(world_pts, pool.center, pool.half_size,
                                cfg.max_depth)
    word = mask[torch.where(valid, keys >> 5, 0).to(torch.int64)]
    return valid & (((word >> (keys & 31)) & 1) == 1)


def rebuild_sat_mask(state: SLAMState, cfg: SLAMConfig) -> SLAMState:
    """The saturation mask anew from the live leaf registry (leaves at
    alpha 255 only): required after any operation that changes the key
    space or removes leaves from the pool, since a stale bit of a live
    unsaturated key would drop its observations. Registry keys are unique,
    so one add of each key's bit is an exact OR."""
    if state.sat_mask.shape[0] == 0:
        return state
    lv = state.leaves
    sat = (lv.keys >= 0) & (packing.alpha_of(lv.vals) == 255)
    return state._replace(sat_mask=_add_sat_bits(
        torch.zeros_like(state.sat_mask), lv.keys, sat))


def reset_dircache(state: SLAMState) -> SLAMState:
    """Clear the insert directory cache: required after any operation that
    changes leaf keys, node indices or registry positions under the map. A
    stale entry would blend a leaf into the wrong node; a cleared cache
    costs one frame of full descents."""
    if state.dir_keys.shape[0] == 0:
        return state
    return state._replace(
        dir_keys=torch.full_like(state.dir_keys, morton.INVALID_KEY),
        dir_nodes=torch.full_like(state.dir_nodes, -1),
        dir_vals=torch.zeros_like(state.dir_vals),
        dir_pos=torch.full_like(state.dir_pos, -1))


def grow_state(state: SLAMState, cfg: SLAMConfig, *,
               grow_nodes: bool = True,
               grow_leaves: bool = False) -> Tuple[SLAMState, SLAMConfig]:
    """Double the node pool and/or the leaf registry, keeping all content
    (the reference reallocs per insert, svo.cu:609-614). Three ways:
    within one prealloc schedule the pool pads (node indices are
    absolute); a node doubling that crosses a prealloc boundary rebuilds
    the pool from its exact leaf set (map/tiering); a registry that
    overflowed is rebuilt from an extraction of the pool, so that the
    leaves its appends dropped are registered. Returns (state, cfg)."""
    from octree_slam_tpu_torch.map import tiering
    new_cfg = dataclasses.replace(
        cfg,
        node_capacity=cfg.node_capacity * (2 if grow_nodes else 1),
        leaf_capacity=cfg.leaf_capacity * (2 if grow_leaves else 1))
    if grow_nodes and (svo.prealloc_levels(new_cfg.node_capacity)
                       != svo.prealloc_levels(cfg.node_capacity)):
        # a pad cannot keep the shallow dense layout: rebuild the pool from
        # the exact leaf words (insert_exact reproduces every one)
        pool0, keys, vals = tiering._leaf_snapshot(state, cfg)
        state = state._replace(pool=pool0, interior_stale=_flag(
            False, pool0.child.device))
        fresh = svo.create(new_cfg.node_capacity, pool0.center,
                           pool0.half_size, device=pool0.child.device)
        fresh, _ = tiering._insert_all_exact(fresh, keys, vals, new_cfg,
                                             overwrite=True)
        return tiering._rebuild_derived(state, new_cfg, fresh)
    pool = (svo.grow_capacity(state.pool, new_cfg.node_capacity)
            if grow_nodes else state.pool)

    leaves = state.leaves
    if bool(leaves.overflowed):
        # the extraction's BFS reads interior occupancy: refresh first if
        # lazy frames deferred it
        if bool(state.interior_stale):
            pool = svo.refresh_interior(pool, depth=cfg.max_depth)
        ex, cap = svo.extract_all_leaves(
            pool, depth=new_cfg.max_depth,
            start_capacity=new_cfg.leaf_capacity)
        new_cfg = dataclasses.replace(new_cfg, leaf_capacity=cap)
        leaves = leaf_list_from_extraction(
            ex, pool.value, node_capacity=new_cfg.node_capacity)
        # registry positions just changed under the directory's dir_pos
        state = reset_dircache(state)
    else:
        leaves = pad_leaf_list(leaves, new_cfg.leaf_capacity,
                               new_cfg.node_capacity)
    # the render cache does not depend on capacity: the mirror is sized by
    # max_depth, and an entry grid holds node indices, which a pad keeps
    return state._replace(pool=pool, leaves=leaves), new_cfg


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
               min_key=None, dircache=None, leaf_mirror: bool = False,
               sat_mask=None):
    """One insert pass, the registry append and the upkeep of the dense
    mirror and the saturation mask: the one definition behind the step's
    first insert, its remainder pages and insert_remainder. Without dense
    mips the AccelGrid is not kept up here: only the exact march reads it,
    and the step's cone_march branch rebuilds it.
    Returns (pool, leaves, accel, sat_mask, stats, tpos); tpos, every
    touched row's registry position, is the next frame's dir_pos. Each call
    is one `fuse.pass` span and counts insert_passes, and the pass's
    distinct leaves (unique_leaves) and first-seen leaves (new_leaves)."""
    with spans.span("fuse.pass"):
        lvl = _accel_level(cfg)
        mirror = cfg.use_dense_mips and eager
        dk, dn, dv, dp = dircache if dircache is not None else (None,) * 4
        pool, st = svo.insert(pool, world_pts, colors, valid=valid,
                              depth=cfg.max_depth,
                              unique_cap=cfg.insert_unique_cap,
                              shallow_level=lvl, min_key=min_key,
                              update_interior=eager, emit_mips=mirror,
                              dir_keys=dk, dir_nodes=dn, dir_vals=dv,
                              dir_aux=dp,
                              miss_cap=(_miss_cap(cfg) if dircache is not None
                                        else 0))
        leaves, tpos = append_new_leaves_cached(leaves, st)
        spans.count("insert_passes")
        spans.count_device("unique_leaves", st.n_unique)
        spans.count_device("new_leaves", st.new_leaf_count)
        if mirror:
            # mirror this insert's touched values and occupancy; the distance
            # field only when a march reads it this frame
            accel = mips.update(accel, st.mip_idx, st.mip_val,
                                max_depth=cfg.max_depth, dist_level=lvl,
                                max_skip=cfg.dist_max_skip,
                                with_dist=with_dist)
        elif leaf_mirror and cfg.use_dense_mips:
            # The hybrid's lazy upkeep: its band march samples only the leaf
            # level and the dist field's occupancy, so one scatter of the
            # touched leaves' words and one of the first-seen leaves' dist
            # cells (nothing else newly occupies a cell) keep it current
            # without the interior mipmap. The distance transform is the
            # step's, once a frame; interior levels stay stale.
            tkeys = st.touched_leaf_keys
            compaction.scatter_set_(
                accel.values,
                torch.where(tkeys != morton.INVALID_KEY,
                            mips.flat_index(tkeys, cfg.max_depth,
                                            cfg.max_depth),
                            -1),
                st.touched_leaf_vals)
            nk = st.new_leaf_keys
            x, y, z = mips.deinterleave3(
                torch.where(nk >= 0, nk >> (3 * (cfg.max_depth - lvl)), 0),
                lvl)
            compaction.scatter_set_(
                accel.occ,
                torch.where(nk >= 0, (z << (2 * lvl)) | (y << lvl) | x, -1),
                torch.ones_like(nk, dtype=torch.bool))
        if sat_mask is not None and sat_mask.shape[0] > 0:
            sat_mask = _add_sat_bits(sat_mask, st.touched_leaf_keys,
                                     st.sat_transition)
    return pool, leaves, accel, sat_mask, st, tpos


def _slab_spec(cfg: SLAMConfig) -> conesplat.SlabSpec:
    return conesplat.make_slab_spec(
        width=cfg.width, height=cfg.height, fx=cfg.focal_x,
        leaf_size=cfg.voxel_resolution, z_near=cfg.cone_znear,
        z_far=cfg.max_range, n_slabs=cfg.cone_slabs,
        max_scale=cfg.cone_max_scale)


def _track(state, pyramid, cfg: SLAMConfig, track=tracking.track):
    """The frame's pose: ICP against the previous frame, or with
    cfg.track_keyframe against the anchor frame's maps (drift then accrues
    per keyframe, not per frame), seeded by the previous frame's transform
    against the anchor. The anchor moves to this frame once the camera is
    keyframe_max_dist or keyframe_max_angle_deg away from it, never on a
    diverged solve, and by torch.where on a 0-d flag: no host read.
    `state` needs the SLAMState fields pose, initialized, diverged,
    last_pyramid and the key_* ones; `track` is tracking.track or the
    row-sharded tracker of parallel/distributed.py, which takes the same
    arguments. Returns (pose, tstats, diverged, key_pyramid, key_pose,
    key_T_cam)."""
    eye = torch.eye(4, dtype=torch.float32, device=state.pose.device)
    if not cfg.track_keyframe:
        update_T, tstats = track(list(state.last_pyramid), pyramid, cfg)
        update_T = torch.where(state.initialized, update_T, eye)
        diverged = state.diverged | (state.initialized & tstats.diverged)
        return (state.pose @ update_T, tstats, diverged, state.key_pyramid,
                state.key_pose, state.key_T_cam)
    update_T, tstats = track(list(state.key_pyramid), pyramid, cfg,
                             init_T=state.key_T_cam)
    update_T = torch.where(state.initialized, update_T, eye)
    pose = torch.where(state.initialized, state.key_pose @ update_T,
                       state.pose)
    diverged = state.diverged | (state.initialized & tstats.diverged)
    t_dist = torch.linalg.norm(update_T[:3, 3])
    cos_ang = torch.clamp((torch.trace(update_T[:3, :3]) - 1.0) * 0.5,
                          -1.0, 1.0)
    far = (t_dist > cfg.keyframe_max_dist) | (
        cos_ang < math.cos(math.radians(cfg.keyframe_max_angle_deg)))
    re_anchor = ~state.initialized | (far & ~tstats.diverged)
    key_pyramid = tuple(
        PyramidLevel(*(torch.where(re_anchor, new, old)
                       for new, old in zip(lvl_new, lvl_old)))
        for lvl_new, lvl_old in zip(pyramid, state.key_pyramid))
    return (pose, tstats, diverged, key_pyramid,
            torch.where(re_anchor, pose, state.key_pose),
            torch.where(re_anchor, eye, update_T))


def step(state: SLAMState, frame: Frame, cfg: SLAMConfig,
         render: str = "splat", *, sensor=None
         ) -> Tuple[SLAMState, StepOutput]:
    """One SLAM frame: preprocess -> ICP track -> fuse -> render
    (mainLoop, main.cpp:31-64, with RGBDCamera::update enabled).
    `sensor(frame, cfg) -> (pyramid, tracker)` replaces the pyramid build
    and tracking.track (parallel/distributed.py's row-sharded front end)."""
    check_supported(cfg, render)
    dev = state.pose.device
    with spans.span("step.pyramid"):
        if sensor is None:
            pyramid = tracking.build_pyramid(frame.depth, frame.color, cfg)
            track = tracking.track
        else:
            pyramid, track = sensor(frame, cfg)
    with spans.span("step.track"):
        pose, tstats, diverged, key_pyramid, key_pose, key_T_cam = _track(
            state, pyramid, cfg, track)

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
    # A lazy hybrid frame keeps the mirror's leaf level itself, but only on
    # top of a current mirror: it heals after splat / cone / none frames.
    eager = (not cfg.lazy_interior) or render == "cone_march"
    needs_mirror = render == "cone_hybrid" and not eager
    lvl = _accel_level(cfg)
    pool, accel = state.pool, state.accel
    restamp = False
    with spans.span("step.heal"):
        if eager and cfg.lazy_interior:
            with spans.span("sync.heal"):
                heal = (state.interior_stale | state.mirror_stale).item()
        elif needs_mirror:
            # one read for the heal and for the stamps' share of the
            # re-stamp trigger below
            with spans.span("sync.heal"):
                heal, stamps_stale = torch.stack(
                    [state.mirror_stale, state.stamps_stale]).tolist()
            restamp = cfg.cone_band_fused_dist and (heal or stamps_stale)
        else:
            heal = False
        if heal:
            pool = svo.refresh_interior(pool, depth=cfg.max_depth)
            if cfg.use_dense_mips:
                accel = mips.rebuild_from_pool(
                    pool, max_depth=cfg.max_depth, dist_level=lvl,
                    max_skip=cfg.dist_max_skip)
                spans.count("mirror_rebuilds")

    with spans.span("step.fuse"):
        if cfg.saturation_gate:
            # points of a saturated leaf are dropped before the sort, so
            # that the frame's new uniques, not its whole re-observation
            # load, size the per-unique work
            fuse_ok = fuse_ok & ~_saturated(state.sat_mask, world_pts, pool,
                                            cfg)
        # The directory serves the primary insert of lazy frames only (the
        # eager mipmap needs the per-level paths, and the pages' key ranges
        # barely meet it); tpos is kept whenever the cache exists, eager
        # frames included, so that the next lazy frame starts warm.
        have_dir = state.dir_keys.shape[0] > 0
        dircache = ((state.dir_keys, state.dir_nodes, state.dir_vals,
                     state.dir_pos) if have_dir and not eager else None)
        march_reads_dist = render in ("cone_march", "cone_hybrid")
        pool, leaves, accel, sat_mask, istats, tpos = _fuse_once(
            pool, state.leaves, accel, world_pts, colors, fuse_ok, cfg,
            eager=eager, with_dist=march_reads_dist, dircache=dircache,
            leaf_mirror=needs_mirror, sat_mask=state.sat_mask)
        uo, lk = istats.unique_overflow, istats.last_key
        if needs_mirror:
            # the pager's first read also says whether leaves were created
            with spans.span("sync.pager"):
                more, had_new = torch.stack(
                    [uo, (istats.new_leaf_count > 0) | uo]).tolist()
        else:
            had_new = more = False
            if cfg.device_remainder:
                with spans.span("sync.pager"):
                    more = uo.item()
        # unique-cap remainder pages, in sorted key order: each leaf still
        # blends once. One host read per page. With device_remainder off
        # the caller pages through insert_remainder.
        paged = False
        while cfg.device_remainder and more:
            pool, leaves, accel, sat_mask, st, _ = _fuse_once(
                pool, leaves, accel, world_pts, colors, fuse_ok, cfg,
                eager=eager, with_dist=False, min_key=lk,
                leaf_mirror=needs_mirror, sat_mask=sat_mask)
            uo, lk = st.unique_overflow, st.last_key
            with spans.span("sync.pager"):
                more = uo.item()
            paged = True
        if paged and cfg.use_dense_mips and eager and march_reads_dist:
            # the pages updated the occupancy without the distance field:
            # redo it, or this frame's march would skip through the
            # geometry they inserted
            accel = mips.refresh_dist(accel, dist_level=lvl,
                                      max_skip=cfg.dist_max_skip)
            spans.count("dist_refreshes")

    with spans.span("step.render"):
        if render == "cone":
            fb = conesplat.render_cone_splat(
                leaves, pool.center, pool.half_size, pose, cfg.focal_x,
                cfg.focal_y, spec=_slab_spec(cfg), depth=cfg.max_depth)
        elif render == "cone_hybrid":
            if needs_mirror and (had_new or restamp):
                # the distance transform runs only when this frame created
                # leaves; the stamps go stale exactly when `dist` does, and
                # also after a heal (a rebuilt mirror has none) or after
                # frames that do not stamp, so they ride the same trigger
                accel = mips.refresh_dist(accel, dist_level=lvl,
                                          max_skip=cfg.dist_max_skip)
                spans.count("dist_refreshes")
            if cfg.cone_band_fused_dist and (
                    not needs_mirror or had_new or restamp):
                # an eager hybrid frame recomputed `dist` in mips.update,
                # so it stamps on every frame
                accel = mips.encode_free_dist(accel, max_depth=cfg.max_depth,
                                              dist_level=lvl)
                spans.count("dist_stamps")
            # hybrid.render_cone_hybrid's first half; step.band below does
            # the rest
            fb, _, z_first = conesplat.render_cone_splat(
                leaves, pool.center, pool.half_size, pose, cfg.focal_x,
                cfg.focal_y, spec=_slab_spec(cfg), depth=cfg.max_depth,
                want_aux=True)
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
    if render == "cone_hybrid":
        with spans.span("step.band"):
            fb = hybrid.band_march_merge(
                fb, z_first, accel, pool.center, pool.half_size, pose,
                cfg.focal_x, cfg.focal_y, spec=_slab_spec(cfg),
                depth=cfg.max_depth, dist_level=lvl, max_range=cfg.max_range,
                start_dist=cfg.start_dist, band_cap=cfg.cone_band_cap,
                band_iters=cfg.cone_band_iters, crawl=cfg.cone_band_crawl,
                fused_dist=cfg.cone_band_fused_dist,
                depth_prio=cfg.cone_band_depth_prio,
                compact_after=cfg.cone_band_compact_after,
                sel_decimate=cfg.cone_band_sel_decimate)

    new_state = SLAMState(
        pool=pool,
        leaves=leaves,
        accel=accel,
        pose=pose,
        last_pyramid=tuple(pyramid),
        initialized=_flag(True, dev),
        frame_idx=state.frame_idx + 1,
        diverged=diverged,
        interior_stale=_flag(not eager, dev),
        key_pyramid=key_pyramid,
        key_pose=key_pose,
        key_T_cam=key_T_cam,
        # the next frame's directory: every leaf this primary insert
        # blended, hits and misses alike (a gated frame blends nothing and
        # so empties the cache)
        dir_keys=istats.touched_leaf_keys if have_dir else state.dir_keys,
        dir_nodes=istats.touched_leaf_nodes if have_dir else state.dir_nodes,
        dir_vals=istats.touched_leaf_vals if have_dir else state.dir_vals,
        dir_pos=tpos if have_dir else state.dir_pos,
        sat_mask=sat_mask,
        # An eager frame healed and updated the mirror, a lazy hybrid frame
        # healed it and kept its leaf level, every other lazy frame leaves
        # it behind. That is content only: an eager frame that is not
        # hybrid leaves a current mirror without stamps, which the second
        # flag records, so that the next hybrid frame stamps it without the
        # eager path healing a current mirror on every frame.
        mirror_stale=(_flag(not (eager or needs_mirror), dev)
                      if cfg.use_dense_mips else state.mirror_stale),
        stamps_stale=_flag(cfg.use_dense_mips and cfg.cone_band_fused_dist
                           and render != "cone_hybrid", dev),
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


def _flag(value: bool, device) -> torch.Tensor:
    """A 0-d bool made on the device: torch.tensor(value, device=...) would
    be a synchronising host-to-device copy."""
    return torch.full((), bool(value), dtype=torch.bool, device=device)


def insert_remainder(state: SLAMState, frame: Frame, cfg: SLAMConfig,
                     min_key: torch.Tensor):
    """Fuse the unique-cap remainder of the frame `step` has just consumed
    (cfg.device_remainder=False): its fused vertex map is
    state.last_pyramid[fuse_level] and its pose state.pose. Uniques are
    processed in sorted key order, so masking to keys > min_key goes on
    exactly where the step's insert stopped, and each leaf blends once in
    all. Returns (state, (unique_overflow, last_key)) to drive the
    caller's loop:

        state, out = step(state, frame, cfg)
        uo, lk = out.unique_overflow, out.last_insert_key
        while bool(uo):
            state, (uo, lk) = insert_remainder(state, frame, cfg, lk)
    """
    v = state.last_pyramid[cfg.fuse_level].vertex.reshape(-1, 3)
    world_pts = v @ state.pose[:3, :3].T + state.pose[:3, 3]
    # the same pre-gate as the step's: keys > min_key were not touched by
    # the earlier passes, so their bits are unchanged and the probe exact
    valid = (~_saturated(state.sat_mask, world_pts, state.pool, cfg)
             if cfg.saturation_gate else None)
    eager = not cfg.lazy_interior
    pool, leaves, accel, sat_mask, istats, _ = _fuse_once(
        state.pool, state.leaves, state.accel, world_pts,
        _fuse_colors(frame, cfg), valid, cfg, eager=eager, min_key=min_key,
        with_dist=False, sat_mask=state.sat_mask)
    dev = state.pose.device
    new_state = state._replace(
        pool=pool, leaves=leaves, accel=accel, sat_mask=sat_mask,
        # a lazy remainder skips the interior mipmap and the mirror: the
        # flags must say so even if the step that consumed the frame was
        # eager and had cleared them
        interior_stale=state.interior_stale | _flag(not eager, dev),
        mirror_stale=state.mirror_stale
        | _flag(cfg.use_dense_mips and not eager, dev),
        stamps_stale=state.stamps_stale
        | _flag(cfg.use_dense_mips and cfg.cone_band_fused_dist, dev))
    return new_state, (istats.unique_overflow, istats.last_key)
