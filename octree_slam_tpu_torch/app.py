"""Application loop and CLI (counterpart: octree_slam_tpu/app.py, the
reference's mainLoop, main.cpp:31-84).

`run_slam` drives `pipeline.step` over a frame stream on one device and
runs the host-side policy between frames: map growth (`grow_state`), host
tiering (map/tiering.py), tracking-loss recovery (relocalize.py), the
directory-cache check, trajectory and ATE bookkeeping, and saving renders.

Host reads. Everything the loop needs from a frame is packed into one
float32 vector on the device (`_pack_signals`) and read once. With
cfg.device_remainder (the default) that read trails one frame, exactly as
in the reference package: frame j's vector is copied, non-blocking, into a
pinned host buffer of its own with a CUDA event behind it while frame j+1
is issued, and `consume` waits on that event. Growth, spill, restore and
recovery therefore land on the same frames as in the reference package.
Beyond that vector the loop reads only what the reference package reads:
`state.diverged` on frames that diverged, and the capacity and extraction
reads of growth and tiering. `pipeline.step` adds its own pager read.

Spans (utils/spans.py): each loop iteration is an `app.frame` span, and
each `consume` an `app.consume` span charged to the frame whose vector it
reads, with `sync.slot` (the event wait), `app.reloc`, `app.grow` and
`app.tier` inside it.

The reference package's compile-ahead of the grown step
(`precompile_step`, `_aot_cache`, `_donated_step`) and its runtime set-up
exist for its TPU and compile tunnel only; eager PyTorch compiles nothing,
so cfg.precompile_ahead is accepted and ignored here.

`save_state` / `load_state` checkpoint a state in the reference package's
file, so that a map saved by either package resumes in the other: an npz
of `n`, the state's leaves as arrays a0 .. a{n-1} in the reference's
tree_flatten order (convert.slam_state_leaf_names, packed words as
uint32) and its 15 stamps. The reader also takes the reference's legacy
files (no prealloc stamp; a short tail) and the port's earlier
`field:<name>` files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np
import torch

from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import Frame
from octree_slam_tpu_torch.utils import metrics, spans

# _pack_signals' layout; consume() reads by these offsets
_SIG_POSE = slice(0, 16)
_SIG_UO, _SIG_NODES, _SIG_LEAVES, _SIG_OVF, _SIG_DIV = 16, 17, 18, 19, 20
_SIG_STATS = 21  # then pyramid_depth inlier counts and residuals


def _pack_signals(o: "pipeline.StepOutput") -> torch.Tensor:
    """Everything the host loop reads of a frame, as one float32 vector."""
    return torch.cat([
        o.pose.reshape(-1),
        torch.stack([o.unique_overflow.to(torch.float32),
                     o.map_nodes.to(torch.float32),
                     o.map_leaves.to(torch.float32),
                     o.map_overflowed.to(torch.float32),
                     o.diverged.to(torch.float32)]),
        o.track_inliers.to(torch.float32),
        o.track_residual.to(torch.float32)])


def _to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class SignalSlots:
    """One host buffer and one event per frame in flight: the trailing read
    holds frame j's vector while frame j+1 copies its own, so they must
    not share a buffer. On the CPU the copy is synchronous."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.n = n
        self.bufs: list = [None] * n
        self.events: list = [None] * n

    def put(self, i: int, vec: torch.Tensor):
        """Start frame i's copy; returns the slot to read it from."""
        k = i % self.n
        if not self.cuda:
            self.bufs[k] = vec.clone()
            return k
        if self.bufs[k] is None or self.bufs[k].numel() != vec.numel():
            self.bufs[k] = torch.empty(vec.numel(), dtype=vec.dtype,
                                       pin_memory=True)
        self.bufs[k].copy_(vec, non_blocking=True)
        self.events[k] = torch.cuda.Event()
        self.events[k].record()
        return k

    def read(self, k: int) -> np.ndarray:
        with spans.span("sync.slot"):
            if self.cuda:
                self.events[k].synchronize()
            return self.bufs[k].numpy().copy()


@dataclass
class RunResult:
    poses: List[np.ndarray] = field(default_factory=list)
    gt_poses: List[np.ndarray] = field(default_factory=list)
    fps: float = 0.0
    steady_fps: float = 0.0     # 1 / median frame time
    ate_rmse: Optional[float] = None
    diverged: bool = False
    map_nodes: int = 0
    frames: int = 0
    spilled_leaves: int = 0     # host-tier traffic (cfg.host_spill)
    restored_leaves: int = 0
    archived_cells: int = 0     # cells still in host RAM at the end
    relocalizations: int = 0    # successful recoveries
    max_frame_s: float = 0.0    # worst frame after frame 0
    archive: Optional[object] = None  # the HostArchive with cfg.host_spill
    growth_frame_s: Optional[float] = None  # the first growth's frame
    final_cfg: Optional[SLAMConfig] = None  # cfg after growth: save_state's


def _validate_dircache(pre: "pipeline.SLAMState", post: "pipeline.SLAMState",
                       frame: Frame, cfg: SLAMConfig, j: int) -> None:
    """The directory cache's contract, executed: frame j again without the
    cache from a copy of the state before it must give the same leaf
    content, compared as the sorted (key, word) set (row order may differ:
    a miss overflow defers keys to the pager). Raises RuntimeError at the
    first divergence."""
    empty = pre.dir_keys.new_zeros((0,))
    pre_uc = pre._replace(dir_keys=empty, dir_nodes=empty, dir_vals=empty,
                          dir_pos=empty)
    ref, _ = pipeline.step(pre_uc, frame, cfg, render="none")

    def canon(s):
        k = _to_np(s.leaves.keys)
        v = _to_np(s.leaves.vals)
        live = k >= 0
        o = np.argsort(k[live], kind="stable")
        return k[live][o], v[live][o]

    kc, vc = canon(post)
    kr, vr = canon(ref)
    if kc.shape != kr.shape or not (np.array_equal(kc, kr)
                                    and np.array_equal(vc, vr)):
        bad = (np.flatnonzero((kc != kr) | (vc != vr))[:8].tolist()
               if kc.size == kr.size else [])
        raise RuntimeError(
            f"dircache validation FAILED at frame {j}: cached map holds "
            f"{kc.size} leaves vs {kr.size} uncached; first divergent "
            f"sorted rows {bad}. A pool/registry/value mutation bypassed "
            f"pipeline.reset_dircache.")
    print(json.dumps({"frame": j, "event": "dircache_validated",
                      "leaves": int(kc.size)}), flush=True)


def run_slam(frame_fn: Callable[[int], Frame], n_frames: int,
             cfg: SLAMConfig, initial_pose=None, gt_fn=None,
             render_every: int = 1, render_mode: str = "splat",
             save_dir: str | None = None, log_every: int = 0,
             initial_state: "pipeline.SLAMState | None" = None,
             state_out: list | None = None, auto_grow: bool = True,
             map_center=(0.0, 0.0, 0.0),
             stop_fn: Callable[[int], bool] | None = None,
             device="cuda") -> RunResult:
    """Drive the SLAM pipeline over a frame stream on `device`.

    frame_fn(i) -> Frame on that device; gt_fn(i) -> ground-truth
    world_T_cam or None; stop_fn(i) -> True ends the run before frame i.
    initial_state resumes a state (load_state; it is copied, since the
    step writes the map in place); a list passed as state_out receives the
    final state. With auto_grow the node pool and the leaf registry double
    when 3/4 full; with cfg.host_spill a filling pool first archives cold
    regions in host RAM and grows only when everything is hot, and
    archived regions come back as the camera nears them. A diverged camera
    is relocalized against recent keyposes (cfg.recovery_enabled).
    cfg.precompile_ahead is ignored (see the module docstring)."""
    dev = torch.device(device)
    if initial_state is not None:
        state = convert.clone_state(initial_state)
    else:
        state = pipeline.init_state(cfg, map_center=map_center,
                                    initial_pose=initial_pose, device=dev)
    archive = None
    if cfg.host_spill:
        from octree_slam_tpu_torch.map import tiering
        if cfg.restore_radius >= cfg.spill_keep_radius:
            # inverted hysteresis: a spilled cell would be inside the
            # restore radius at once, a spill and a restore every frame
            raise ValueError(
                f"host_spill needs restore_radius < spill_keep_radius "
                f"(got restore {cfg.restore_radius} >= keep "
                f"{cfg.spill_keep_radius}): spilled cells would restore "
                f"immediately, thrashing the host tier every frame")
        archive = tiering.HostArchive(cfg.tier_level)
    keyposes: list = []  # relocalization anchors
    # frames stepped before a growth still carry the old sticky overflow
    # flag in their trailing vectors: ignore it for them, or one overflow
    # would double the capacity twice
    ovf_ignore_until = [-1]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    result = RunResult()

    def consume(item, state, cfg):
        """`handle` in the `app.consume` span of the frame it reads."""
        with spans.span("app.consume", frame=item[0]):
            return handle(item, state, cfg)

    def handle(item, state, cfg):
        """Host handling of one stepped frame: read its vector, page the
        remainder (device_remainder off), record poses, save the render,
        recover a lost camera, grow and tier. Returns (state, cfg)."""
        j, slot, fb, frame, last_key = item
        host = slots.read(slot)
        pose_np = host[_SIG_POSE].reshape(4, 4)
        n_lvl = cfg.pyramid_depth
        map_nodes, map_leaves = host[_SIG_NODES], host[_SIG_LEAVES]
        if host[_SIG_UO] > 0 and not cfg.device_remainder:
            # the caller's pager needs frame j's maps in state.last_pyramid,
            # which holds because this mode consumes without lag
            more = True
            while more:
                state, (uo, last_key) = pipeline.insert_remainder(
                    state, frame, cfg, last_key)
                with spans.span("sync.pager"):
                    more = bool(uo)
        result.poses.append(pose_np)
        if gt_fn is not None:
            gt = gt_fn(j)
            if gt is not None:
                result.gt_poses.append(_to_np(gt))
        if bool(host[_SIG_DIV]):
            # the vector is frame j's; the live state may already have been
            # recovered by an earlier consume (the lag), so read its flag
            if cfg.recovery_enabled and bool(state.diverged):
                from octree_slam_tpu_torch import relocalize as reloc
                with spans.span("app.reloc"):
                    pose_new, ok, diag = reloc.relocalize(
                        state, cfg, keyposes or [pose_np])
                if ok:
                    pose_t = torch.from_numpy(
                        np.asarray(pose_new, np.float32)).to(dev)
                    state = state._replace(
                        pose=pose_t,
                        diverged=torch.zeros((), dtype=torch.bool,
                                             device=dev))
                    if cfg.track_keyframe:
                        # re-seed the anchor at the recovered pose with the
                        # latest frame's maps
                        state = state._replace(
                            key_pyramid=state.last_pyramid,
                            key_pose=pose_t.clone(),
                            key_T_cam=torch.eye(4, dtype=torch.float32,
                                                device=dev))
                    result.relocalizations += 1
                print(json.dumps({
                    "frame": j,
                    "event": "relocalize" if ok else "relocalize_failed",
                    **diag}), flush=True)
        elif cfg.recovery_enabled and j % cfg.keypose_every == 0:
            keyposes.append(pose_np)
            del keyposes[:-cfg.reloc_candidates]
        if fb is not None:
            from octree_slam_tpu_torch.io.bmp import save_image
            save_image(f"{save_dir}/frame_{j:05d}.png", _to_np(fb))
        if log_every and j % log_every == 0:
            print(json.dumps({
                "frame": j,
                "inliers": host[_SIG_STATS:_SIG_STATS + n_lvl]
                .astype(int).tolist(),
                "residual":
                host[_SIG_STATS + n_lvl:_SIG_STATS + 2 * n_lvl].tolist(),
                "map_nodes": int(map_nodes),
                "diverged": bool(host[_SIG_DIV]),
            }), flush=True)
        if archive is not None and len(archive):
            from octree_slam_tpu_torch.map import tiering
            with spans.span("app.tier"):
                state, cfg, n_rest = tiering.restore_due(
                    state, cfg, archive, camera_pos=pose_np[:3, 3])
            if n_rest:
                result.restored_leaves += n_rest
                print(json.dumps({
                    "frame": j, "event": "map_restore", "leaves": n_rest,
                    "archived_cells": len(archive)}), flush=True)
        if auto_grow:
            grow_nodes = bool(map_nodes > cfg.node_capacity * 3 // 4
                              or (host[_SIG_OVF] > 0
                                  and j > ovf_ignore_until[0]))
            grow_leaves = bool(map_leaves > cfg.leaf_capacity * 3 // 4)
            if grow_nodes and archive is not None:
                # archive cold regions before growing the device's share
                from octree_slam_tpu_torch.map import tiering
                with spans.span("app.tier"):
                    state, cfg, n_spill = tiering.spill_cold(
                        state, cfg, archive, camera_pos=pose_np[:3, 3])
                if n_spill:
                    result.spilled_leaves += n_spill
                    n_nodes, n_leaves = torch.stack(
                        [state.pool.n_nodes, state.leaves.count]).tolist()
                    grow_nodes = n_nodes > cfg.node_capacity * 3 // 4
                    grow_leaves = n_leaves > cfg.leaf_capacity * 3 // 4
                    print(json.dumps({
                        "frame": j, "event": "map_spill",
                        "leaves": n_spill, "archived_cells": len(archive),
                        "map_nodes": n_nodes}), flush=True)
            if grow_nodes or grow_leaves:
                with spans.span("app.grow"):
                    state, cfg = pipeline.grow_state(
                        state, cfg, grow_nodes=grow_nodes,
                        grow_leaves=grow_leaves)
                ovf_ignore_until[0] = j + lag
                # the next loop iteration's frame is the first on the grown
                # map: growth_frame_s reports it
                growth_at.append(len(frame_s) + 1)
                print(json.dumps({
                    "frame": j, "event": "map_grow",
                    "node_capacity": cfg.node_capacity,
                    "leaf_capacity": cfg.leaf_capacity}), flush=True)
        return state, cfg

    # With the remainder paged inside the step, the read can trail a frame:
    # frame j's vector copies while frame j+1 is issued. The 3/4 growth
    # thresholds absorb the one frame of lag.
    lag = 1 if cfg.device_remainder else 0
    slots = SignalSlots(lag + 1, dev)
    queue: list = []
    frame_s: list = []    # per-frame wall time: median -> steady fps
    growth_at: list = []  # frame_s indices of a growth's frame
    t_start = time.perf_counter()
    t_prev = t_start
    out = None
    n_run = n_frames
    for i in range(n_frames):
        if stop_fn is not None and stop_fn(i):
            n_run = i
            break
        with spans.frame(i):
            frame = frame_fn(i)
            render = (render_mode if render_every > 0 and i % render_every == 0
                      else "none")
            check = (cfg.insert_dircache and cfg.debug_validate_dircache > 0
                     and i > 0 and i % cfg.debug_validate_dircache == 0)
            if check:
                # the step writes the map in place: snapshot it first
                pre_state = convert.clone_state(state)
            state, out = pipeline.step(state, frame, cfg, render=render)
            if check:
                _validate_dircache(pre_state, state, frame, cfg, i)
                del pre_state
            slot = slots.put(i, _pack_signals(out))
            # a saved render is copied: no later step may write its memory
            fb = (out.framebuffer.clone() if save_dir and render != "none"
                  else None)
            queue.append((i, slot, fb, frame, out.last_insert_key))
            while len(queue) > lag:
                state, cfg = consume(queue.pop(0), state, cfg)
        t_now = time.perf_counter()
        frame_s.append(t_now - t_prev)
        t_prev = t_now
    while queue:
        state, cfg = consume(queue.pop(0), state, cfg)
    dt = time.perf_counter() - t_start
    result.fps = n_run / dt if n_run else 0.0
    if frame_s:
        result.steady_fps = 1.0 / max(float(np.median(frame_s)), 1e-9)
        if len(frame_s) > 1:
            result.max_frame_s = float(np.max(frame_s[1:]))
        if growth_at and growth_at[0] < len(frame_s):
            result.growth_frame_s = float(frame_s[growth_at[0]])
    result.frames = n_run
    # the live flag: a recovery in the final drain clears it after the
    # last step ran
    result.diverged = bool(state.diverged) if n_run else False
    result.map_nodes = int(out.map_nodes) if out is not None else 0
    if archive is not None:
        result.archived_cells = len(archive)
        result.archive = archive
    if result.gt_poses and len(result.gt_poses) == len(result.poses):
        result.ate_rmse = metrics.ate_rmse(np.stack(result.poses),
                                           np.stack(result.gt_poses))
    result.final_cfg = cfg
    if state_out is not None:
        state_out.append(state)
    return result


# the stamps a checkpoint carries beside the arrays: every shape- or
# meaning-bearing knob, so that a reader rebuilds the exact layout (with
# node_capacity, leaf_capacity and prealloc, the reference's 15)
_STAMPS = (("width", int), ("height", int), ("pyramid_depth", int),
           ("track_finest_level", int), ("fuse_level", int),
           ("max_depth", int), ("use_dense_mips", lambda v: bool(int(v))),
           ("track_keyframe", lambda v: bool(int(v))),
           ("insert_dircache", lambda v: bool(int(v))),
           ("saturation_gate", lambda v: bool(int(v))),
           ("insert_unique_cap", int), ("voxel_resolution", float))
_FIELD = "field:"   # a field's key in the port's earlier files


def _flatten(tree, prefix=""):
    """Nested dicts / lists of numpy arrays -> {"pool.child": array, ...}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def _unflatten(flat: dict, template):
    """The inverse of _flatten on `template`'s structure, as attribute
    namespaces (what convert.state_from_numpy reads)."""
    def build(t, prefix):
        if isinstance(t, dict):
            return SimpleNamespace(**{
                k: build(v, f"{prefix}.{k}" if prefix else k)
                for k, v in t.items()})
        if isinstance(t, (list, tuple)):
            return [build(v, f"{prefix}.{i}") for i, v in enumerate(t)]
        return flat[prefix]
    return build(template, "")


def _check_leaf(path: str, name: str, a: np.ndarray, want: np.ndarray,
                where: str = "") -> None:
    if a.dtype != want.dtype or a.shape != want.shape:
        raise ValueError(
            f"checkpoint {path!r} field {name}: stored "
            f"{a.dtype}{list(a.shape)} vs expected "
            f"{want.dtype}{list(want.shape)} for this config{where}")


def is_reference_file(data) -> bool:
    """Whether a checkpoint's keys are the reference package's layout
    (`n` and the arrays a0 .. a{n-1}) rather than the port's earlier
    `field:<name>` one."""
    return "n" in data and "a0" in data


def write_leaves(path: str, tree, names, stamps: dict) -> None:
    """The reference package's checkpoint: a compressed npz of `n`, the
    stamps, and the arrays of `tree` (nested dicts and lists of numpy
    arrays) as a0 .. a{n-1} in the order of `names`, the reference's
    tree_flatten order (convert.slam_state_leaf_names /
    state2d_leaf_names)."""
    flat = _flatten(tree)
    if sorted(flat) != sorted(names):
        raise ValueError(
            f"the state's fields do not fit the config's layout: "
            f"{sorted(set(flat) ^ set(names))}")
    np.savez_compressed(path, n=len(names), **stamps,
                        **{f"a{i}": flat[k] for i, k in enumerate(names)})


def read_leaves(path: str, data: dict, tree, names, tails=()):
    """The arrays of a write_leaves file (`data`, its arrays by key) in the
    structure of `tree`, the numpy tree of a template state, as attribute
    namespaces; `names` is the template's leaf order. A file short of its
    last k arrays for k in `tails` (a legacy layout) gets zeros of the
    template's dtype and shape in their place. Returns (tree, k). Any
    other count, or a leaf of another dtype or shape than the template's,
    raises and names it."""
    expect = _flatten(tree)
    n = int(data["n"])
    missing = len(names) - n
    if missing and missing not in tails:
        raise ValueError(
            f"checkpoint {path!r} has {n} arrays but the current config "
            f"expects {len(names)}: it was written under a different "
            f"SLAMConfig (capacities / pyramid_depth / use_dense_mips)")
    flat = {}
    for i, name in enumerate(names):
        want = expect[name]
        if i >= n:
            flat[name] = np.zeros(want.shape, want.dtype)
            continue
        if f"a{i}" not in data:
            raise ValueError(f"checkpoint {path!r} lacks array a{i} "
                             f"(field {name})")
        a = data[f"a{i}"]
        _check_leaf(path, name, a, want, f" (array a{i})")
        flat[name] = a
    return _unflatten(flat, tree), missing


def read_fields(path: str, data: dict, tree):
    """The fields of one of the port's earlier `field:<name>` files
    (`data`, its arrays by key) in the structure of `tree`, the numpy tree
    of a template state that the file's stamps describe, as attribute
    namespaces. A field missing, extra or of another dtype or shape than
    the template's raises and names it."""
    expect = _flatten(tree)
    flat = {}
    for name, want in expect.items():
        key = _FIELD + name
        if key not in data:
            raise ValueError(f"checkpoint {path!r} lacks field {name}")
        _check_leaf(path, name, data[key], want)
        flat[name] = data[key]
    extra = sorted(k[len(_FIELD):] for k in data
                   if k.startswith(_FIELD) and k[len(_FIELD):] not in expect)
    if extra:
        raise ValueError(f"checkpoint {path!r} has fields this config does "
                         f"not: {extra}")
    return _unflatten(flat, tree)


def save_state(path: str, state: pipeline.SLAMState,
               cfg: SLAMConfig | None = None) -> None:
    """Checkpoint the whole SLAM state (map, pose, pyramids, caches) in the
    reference package's file (its app.save_state): a compressed npz of `n`,
    every leaf as a{i} in the reference's order (packed words as uint32)
    and the 15 stamps, which its load_state reads unchanged. Pass the
    run's final cfg (RunResult.final_cfg): growth changes capacities, and
    load_state rebuilds the layout from the stamps. Without a cfg the file
    holds `n` and the arrays alone, as the reference writes it."""
    from octree_slam_tpu_torch.map import svo
    from octree_slam_tpu_torch.map.mips import RenderCache
    stamps = {}
    if cfg is not None:
        stamps = dict(node_capacity=cfg.node_capacity,
                      leaf_capacity=cfg.leaf_capacity,
                      prealloc=svo.prealloc_levels(cfg.node_capacity),
                      **{k: (int(v) if isinstance(v, bool) else v)
                         for k, v in ((k, getattr(cfg, k))
                                      for k, _ in _STAMPS)})
    # the leaf order follows the state's own structure
    layout = SimpleNamespace(
        pyramid_depth=len(state.last_pyramid),
        use_dense_mips=isinstance(state.accel, RenderCache),
        track_keyframe=bool(state.key_pyramid))
    write_leaves(path, convert.state_to_numpy(state),
                 convert.slam_state_leaf_names(layout), stamps)


def load_state(path: str, cfg: SLAMConfig, device="cuda"):
    """Returns (state on `device`, cfg) of a checkpoint in the reference
    package's file (its app.load_state) or in the port's earlier
    `field:<name>` one. The file's stamps override the caller's cfg (a
    checkpoint written after growth has other capacities than the command
    line). A file without the prealloc stamp was laid out under the legacy
    schedule (svo.prealloc_levels_legacy); another schedule than this
    build's raises. A reference file short of its last 1 or 2 arrays (3 to
    6 with the directory cache) is a legacy layout: the tail comes from
    the template and the directory cache and the saturation mask are
    rebuilt. Any other array count, or a field missing or of another dtype
    or shape than the stamped config makes, raises and names it."""
    from octree_slam_tpu_torch.map import svo
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    if "node_capacity" in data:
        cfg = dataclasses.replace(
            cfg, node_capacity=int(data["node_capacity"]),
            leaf_capacity=int(data["leaf_capacity"]))
    overrides = {k: cast(data[k]) for k, cast in _STAMPS if k in data}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        # pyramid_iters must still cover the tracked sub-pyramid
        need = cfg.pyramid_depth - cfg.track_finest_level
        if len(cfg.pyramid_iters) < need:
            cfg = dataclasses.replace(
                cfg, pyramid_iters=cfg.pyramid_iters
                + (4,) * (need - len(cfg.pyramid_iters)))
    cur = svo.prealloc_levels(cfg.node_capacity)
    # no stamp: written before the stamp, so under the legacy schedule
    # (never "unchecked": those are the files a schedule change corrupts)
    stored = (int(data["prealloc"]) if "prealloc" in data
              else svo.prealloc_levels_legacy(cfg.node_capacity))
    if stored != cur:
        raise ValueError(
            f"checkpoint {path!r} was written with {stored} "
            f"dense-preallocated octree levels but this build uses {cur} "
            f"for capacity {cfg.node_capacity}: the pool layout is "
            f"incompatible (re-map from the source data or use the "
            f"writing build)")
    # the expected fields, from a template that allocates nothing
    tree = convert.state_to_numpy(pipeline.init_state(cfg, device="meta"))
    tail = 0
    if is_reference_file(data):
        # the reference's SLAMState appends fields last: a file of an
        # older build lacks mirror_stale / stamps_stale (1, 2) and, with
        # the directory cache, its dir_* arrays and sat_mask too (3-6)
        tree, tail = read_leaves(
            path, data, tree, convert.slam_state_leaf_names(cfg),
            tails=(1, 2, 3, 4, 5, 6) if cfg.insert_dircache else (1, 2))
    else:
        tree = read_fields(path, data, tree)
    state = convert.state_from_numpy(tree, cfg, device=device)
    if tail:
        # every tail field is a flag the template starts False or a cache
        # that these rebuild (a partial directory must never be used; a
        # cold saturation mask is right but slow, so it is warmed from the
        # registry)
        state = pipeline.rebuild_sat_mask(pipeline.reset_dircache(state),
                                          cfg)
    return state, cfg


def export_mesh(path: str, state: "pipeline.SLAMState", cfg: SLAMConfig,
                archive=None) -> int:
    """Write the final map as an OBJ of voxel cubes (the JAX CLI's
    --save-mesh): every occupied leaf on the device, interiors refreshed
    first where lazy frames left them stale (the extraction descends
    them), plus the leaves the host archive holds (the archive is emptied
    into the export). Cubes at scale voxel_resolution / 2. Returns the
    number of voxels written."""
    from octree_slam_tpu_torch.core import packing
    from octree_slam_tpu_torch.core.types import BoundingBox, VoxelGrid
    from octree_slam_tpu_torch.io.obj import save_obj
    from octree_slam_tpu_torch.map import morton, svo, voxelization

    pool = (svo.refresh_interior(state.pool, depth=cfg.max_depth)
            if bool(state.interior_stale) else state.pool)
    # doubled until the whole map fits (a fixed capacity would truncate)
    ex, _ = svo.extract_all_leaves(pool, depth=cfg.max_depth,
                                   start_capacity=cfg.extract_capacity)
    n_live = int(ex.count)
    centers, colors = ex.centers[:n_live], ex.colors[:n_live]
    if archive is not None and len(archive):
        keys, vals = archive.take(list(archive.cells.keys()))
        dev = pool.center.device
        centers = torch.cat([centers, morton.decode_centers(
            torch.from_numpy(keys).to(dev), pool.center, pool.half_size,
            cfg.max_depth)])
        colors = torch.cat([colors, packing.unpack_rgba_unit(
            torch.from_numpy(vals.view(np.int32)).to(dev))])
    count = centers.shape[0]
    grid = VoxelGrid(
        centers=centers, colors=colors,
        count=torch.tensor(count, dtype=torch.int32),
        scale=torch.tensor(cfg.voxel_resolution / 2.0),
        bbox=BoundingBox(pool.center - pool.half_size,
                         pool.center + pool.half_size))
    save_obj(path, voxelization.voxel_grid_to_mesh(grid))
    return count


def resolve_device(name: str) -> torch.device:
    """The torch device of a CLI's --device; cuda without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def main(argv=None):
    p = argparse.ArgumentParser(
        description="octree-slam on PyTorch (the port's runner)")
    p.add_argument("--source", choices=["orbit", "tum"], default="orbit")
    p.add_argument("--tum-root", type=str, default=None)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--max-depth", type=int, default=9)
    p.add_argument("--resolution", type=float, default=0.02)
    p.add_argument("--render-every", type=int, default=1)
    p.add_argument("--render", choices=["splat", "cone", "cone_march",
                                        "none"], default="splat",
                   help="map view: voxel splatting, the slab cone, the "
                        "exact cone march, or none")
    p.add_argument("--track-fuse-level", type=int, default=0,
                   help="pyramid level for ICP and fusion (0 = native "
                        "resolution); the pyramid gains as many levels")
    p.add_argument("--node-capacity", type=int, default=None,
                   help="node-pool size (a multiple of 8, >= 4096)")
    p.add_argument("--no-dense-mips", action="store_true",
                   help="no dense value-mip mirror (613 MB at depth 9); "
                        "the exact march then descends the pool")
    p.add_argument("--host-spill", action="store_true",
                   help="archive cold map regions in host RAM when the "
                        "node pool fills, before growing it")
    p.add_argument("--spill-keep-radius", type=float, default=None,
                   help="metres: cells with a leaf this close to the "
                        "camera stay on the device")
    p.add_argument("--keyframe-tracking", action="store_true",
                   help="track against the last keyframe, not the last "
                        "frame (cfg.track_keyframe)")
    p.add_argument("--no-precompile-ahead", action="store_true",
                   help="sets cfg.precompile_ahead off; the port compiles "
                        "nothing ahead either way")
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--save-state", type=str, default=None,
                   help="write the whole SLAM state to this .npz at the end")
    p.add_argument("--save-mesh", type=str, default=None,
                   help="export the final map as an OBJ of voxel cubes")
    p.add_argument("--save-trajectory", type=str, default=None,
                   help="write the estimated trajectory in the TUM format; "
                        "ground truth, when there is one, goes to "
                        "<path>.gt.txt")
    p.add_argument("--load-state", type=str, default=None,
                   help="resume from a state written by --save-state")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for a run without a "
                        "card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    resume = None
    state_sink: list = []
    if args.node_capacity is not None:
        if args.node_capacity % 8 != 0 or args.node_capacity < 4096:
            p.error("--node-capacity must be a multiple of 8 and >= 4096 "
                    "(the pool is tiled in 8-child blocks and must hold the "
                    "dense-preallocated shallow levels)")
    cap = ({"node_capacity": args.node_capacity,
            "leaf_capacity": args.node_capacity // 4,
            "extract_capacity": args.node_capacity // 8}
           if args.node_capacity else {})
    if args.no_dense_mips:
        cap["use_dense_mips"] = False
    if args.track_fuse_level:
        lvl = args.track_fuse_level
        if lvl < 0 or lvl > 2:
            p.error("--track-fuse-level must be 0..2")
        cap.update(track_finest_level=lvl, fuse_level=lvl,
                   pyramid_depth=SLAMConfig.pyramid_depth + lvl,
                   pyramid_iters=SLAMConfig.pyramid_iters)
    if args.keyframe_tracking:
        cap["track_keyframe"] = True
    if args.no_precompile_ahead:
        cap["precompile_ahead"] = False
    if args.host_spill:
        cap["host_spill"] = True
        if args.spill_keep_radius is not None:
            cap["spill_keep_radius"] = args.spill_keep_radius
            cap["restore_radius"] = max(0.0, args.spill_keep_radius - 1.0)
    run = dict(render_every=args.render_every, render_mode=args.render,
               save_dir=args.save_dir, log_every=args.log_every,
               state_out=state_sink, device=dev)
    if args.source == "orbit":
        from octree_slam_tpu_torch.sensor import sources
        cfg = SLAMConfig(width=args.width, height=args.height,
                         max_depth=args.max_depth,
                         voxel_resolution=args.resolution, **cap)
        scene = sources.default_scene(dev)
        gt = [sources.orbit_pose(i * 0.01, radius=2.0, device=dev)
              for i in range(args.frames)]

        def frame_fn(i):
            return sources.render_frame(scene, gt[i], cfg.focal_x,
                                        cfg.focal_y, width=cfg.width,
                                        height=cfg.height)

        if args.load_state:
            resume, cfg = load_state(args.load_state, cfg, device=dev)
        res = run_slam(frame_fn, args.frames, cfg, initial_pose=gt[0],
                       gt_fn=lambda i: gt[i], initial_state=resume, **run)
    else:
        if not args.tum_root:
            p.error("--source tum requires --tum-root <dataset dir>")
        from octree_slam_tpu_torch.io.tum import TUMDataset
        ds = TUMDataset(args.tum_root, max_frames=args.frames, device=dev)
        cfg = SLAMConfig(width=args.width, height=args.height,
                         focal_x=ds.FX, focal_y=ds.FY,
                         max_depth=args.max_depth,
                         voxel_resolution=args.resolution, **cap)
        frames = ds.prefetched()
        if args.load_state:
            resume, cfg = load_state(args.load_state, cfg, device=dev)
        res = run_slam(lambda i: next(frames), len(ds), cfg,
                       initial_pose=ds.gt_pose(0), gt_fn=ds.gt_pose,
                       initial_state=resume, **run)

    if args.save_state and state_sink:
        save_state(args.save_state, state_sink[0], res.final_cfg)
    if args.save_trajectory:
        from octree_slam_tpu_torch.io.tum import write_trajectory
        # the dataset's own timestamps, which evo and the TUM tools
        # associate against
        ts = ([ds.pairs[i][0][0] for i in range(len(res.poses))]
              if args.source == "tum" else None)
        write_trajectory(args.save_trajectory, res.poses, timestamps=ts)
        if res.gt_poses and len(res.gt_poses) == len(res.poses):
            write_trajectory(args.save_trajectory + ".gt.txt",
                             res.gt_poses, timestamps=ts)
    if args.save_mesh and state_sink:
        export_mesh(args.save_mesh, state_sink[0], res.final_cfg,
                    res.archive)
    print(json.dumps({
        "fps": round(res.fps, 3),
        "steady_fps": round(res.steady_fps, 3),
        "ate_rmse": res.ate_rmse,
        "frames": res.frames,
        "map_nodes": res.map_nodes,
        "diverged": res.diverged,
    }), flush=True)
    return res


if __name__ == "__main__":
    main()
