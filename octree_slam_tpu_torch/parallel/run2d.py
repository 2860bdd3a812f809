"""The app loop on the 2-D ("px", "map") mesh (counterpart:
octree_slam_tpu/parallel/run2d.py).

`run_slam_2d` drives distributed.slam_step_2d, tracking sharded over image
rows and the map Morton-range-sharded, with the disciplines of
app.run_slam:

  * one packed signal vector a frame, read trailing one frame through a
    pinned host buffer and a CUDA event (app.SignalSlots), so that frame
    i+1 is issued before frame i's vector is waited on;
  * capacity growth between frames (distributed.grow_sharded) at a
    headroom of the capacity, off those trailing signals;
  * rebalance before growth: when a shard triggers growth while holding
    more than rebalance_factor times the mean leaf load, the Morton ranges
    are re-cut first and the trigger is checked again against the balanced
    loads, so one hot shard does not double every shard's capacity;
  * renders "splat", "cone", "cone_hybrid" and "none";
  * relocalization: with cfg.recovery_enabled the diverged flag latches in
    the step (fusion gated) and the loop re-anchors the camera by ICP
    against splats of the sharded map at recent keyposes
    (distributed.model_zbuffer_sharded + relocalize.score_zbuffer);
  * host tiering with cfg.host_spill (parallel/tiering2d.py): node-growth
    pressure archives cold cells before growing, and archived cells come
    back as the camera nears them, off the camera position the signal
    vector carries;
  * checkpoints (`save_sharded` / `load_sharded`) in the reference
    package's file (app.write_leaves: `n`, the leaves as a{i} in the
    reference's order, its 13 stamps), so that a sharded map saved by
    either package resumes in the other; the reader also takes the port's
    earlier `field:<name>` files.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch

from octree_slam_tpu_torch import convert
from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.parallel import distributed
from octree_slam_tpu_torch.parallel.distributed import Mesh, State2D


def union_leaves(smap: distributed.ShardedMap):
    """(keys, u32 words) of every live leaf across shards, sorted by key:
    the map's content for comparisons with a single-device run (shards own
    disjoint keys, so keys are globally unique)."""
    k, v = (np.concatenate(x) for x in zip(*(
        distributed.registry_rows(lv) for lv in smap.leaves)))
    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def relocalize_2d(state: State2D, cfg: SLAMConfig, mesh: Mesh, keyposes):
    """Recover a lost camera on the mesh: render the sharded map at each
    recent keypose (per-shard splat + pmin), ICP the live pyramid against
    it, accept the best candidate that clears the inlier gate. One
    candidate at a time, one read each (recovery is rare). Returns (pose
    or None, ok, diagnostics)."""
    from octree_slam_tpu_torch import relocalize as reloc
    cands = [np.asarray(c, np.float32)
             for c in keyposes[::-1][:cfg.reloc_candidates]]
    if not cands:
        return None, False, {"candidates_tried": 0, "inliers": -1,
                             "residual": None}
    best_pose, best_inl, best_res = None, -1, None
    for cand in cands:
        cand_dev = torch.from_numpy(cand).to(mesh.home)
        buf = distributed.model_zbuffer_sharded(state.smap, cand_dev, cfg,
                                                mesh)
        row = reloc.score_zbuffer(buf, cand_dev, state.last_pyramid,
                                  cfg).cpu().numpy()
        if row[18] > 0 and int(row[16]) > best_inl:
            best_pose = row[:16].reshape(4, 4)
            best_inl = int(row[16])
            best_res = float(row[17])
    return best_pose, best_pose is not None, {
        "candidates_tried": len(cands), "inliers": best_inl,
        "residual": best_res}


# the stamps of the reference's save_sharded beside the capacities, the
# prealloc schedule and the shard count (it stamps no track_keyframe: that
# comes from the caller's cfg)
_STAMPS = (("width", int), ("height", int), ("pyramid_depth", int),
           ("track_finest_level", int), ("fuse_level", int),
           ("max_depth", int), ("map_split_level", int),
           ("insert_unique_cap", int), ("voxel_resolution", float))


def save_sharded(path: str, state: State2D, cfg: SLAMConfig) -> None:
    """Checkpoint the 2-D mesh's state (sharded map, pose, pyramids) in
    the reference package's file (its run2d.save_sharded): a compressed
    npz of `n`, the state's leaves as a{i} in the reference's order (the
    map stacked [M, ...], packed words as uint32), the capacity and
    prealloc stamps, the shard count and the layout stamps. Pass the
    run's final cfg: growth changes capacities."""
    from octree_slam_tpu_torch.app import write_leaves
    from octree_slam_tpu_torch.map import svo
    write_leaves(path, convert.state2d_to_numpy(state),
                 convert.state2d_leaf_names(cfg), dict(
                     node_capacity=cfg.node_capacity,
                     leaf_capacity=cfg.leaf_capacity,
                     prealloc=svo.prealloc_levels(cfg.node_capacity),
                     n_shards=len(state.smap.pools),
                     **{k: getattr(cfg, k) for k, _ in _STAMPS}))


def load_sharded(path: str, cfg: SLAMConfig, mesh: Mesh
                 ) -> Tuple[State2D, SLAMConfig]:
    """Restore a save_sharded checkpoint (the reference package's file, or
    the port's earlier `field:<name>` one) onto `mesh`, every shard on its
    device. The file's stamps override the caller's cfg, but for
    track_keyframe, which the reference does not stamp; its shard count
    must be the mesh's "map" size (re-cut a map to another count with
    rebalance_sharded on a matching mesh first). Another prealloc
    schedule, another array count, or a field missing, extra or of
    another dtype or shape than the stamped config makes, raises and names
    it. Returns (state, cfg)."""
    from octree_slam_tpu_torch import app
    from octree_slam_tpu_torch.map import svo
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    m = mesh.shape[distributed.axis_name_of(mesh)]
    stored_m = int(data["n_shards"])
    if stored_m != m:
        raise ValueError(
            f"checkpoint {path!r} holds {stored_m} map shards but the mesh "
            f"has {m}: restore on a matching mesh (then rebalance)")
    cfg = dataclasses.replace(
        cfg, node_capacity=int(data["node_capacity"]),
        leaf_capacity=int(data["leaf_capacity"]),
        **{k: cast(data[k]) for k, cast in _STAMPS})
    if "track_keyframe" in data:   # the port's earlier files stamp it
        cfg = dataclasses.replace(
            cfg, track_keyframe=bool(int(data["track_keyframe"])))
    cur = svo.prealloc_levels(cfg.node_capacity)
    if int(data["prealloc"]) != cur:
        raise ValueError(
            f"checkpoint {path!r} was written with {int(data['prealloc'])} "
            f"dense-preallocated octree levels but this build uses {cur} "
            f"for capacity {cfg.node_capacity}: the pool layout is "
            f"incompatible")
    # the expected fields, from a template that allocates nothing
    meta = distributed.Mesh(np.full(mesh.devices.shape, torch.device("meta"),
                                    dtype=object), mesh.axis_names)
    tree = convert.state2d_to_numpy(distributed.slam_init_2d(cfg, meta))
    if app.is_reference_file(data):
        tree, _ = app.read_leaves(path, data, tree,
                                  convert.state2d_leaf_names(cfg))
    else:
        tree = app.read_fields(path, data, tree)
    return convert.state2d_from_numpy(tree, cfg, mesh), cfg


def run_slam_2d(frames: Iterable, cfg: SLAMConfig, mesh: Mesh,
                *, map_center=(0.0, 0.0, 0.0), initial_pose=None,
                grow_headroom: float = 0.75,
                rebalance_factor: float | None = None,
                rebalance_check_every: int = 8,
                render: str = "splat",
                log=None) -> Tuple[State2D, SLAMConfig, dict]:
    """Run the sharded SLAM pipeline over a frame stream.

    frames: iterable of core.types.Frame (on any device: each slab is
    copied to its own). render: "splat" | "cone" | "cone_hybrid" | "none".
    Returns (final state, final cfg, info): info carries the trajectory
    (np [N, 4, 4]), the growth / rebalance / relocalize / tiering events,
    the last signal vector and the host archive."""
    recovery = cfg.recovery_enabled
    archive = None
    if cfg.host_spill:
        from octree_slam_tpu_torch.map.tiering import HostArchive
        if cfg.restore_radius >= cfg.spill_keep_radius:
            raise ValueError(
                f"host_spill needs restore_radius < spill_keep_radius "
                f"(got restore {cfg.restore_radius} >= keep "
                f"{cfg.spill_keep_radius}): spilled cells would restore "
                f"immediately, thrashing the host tier every frame")
        archive = HostArchive(cfg.tier_level)
    from octree_slam_tpu_torch.app import SignalSlots
    home = mesh.home
    state = distributed.slam_init_2d(cfg, mesh, map_center=map_center,
                                     initial_pose=initial_pose)
    step = distributed.slam_step_2d(cfg, mesh, render=render,
                                    sticky_gate=recovery)
    slots = SignalSlots(2, home)
    pending = None          # the previous frame's signal slot
    poses = []              # device poses, read once at the end
    events = []
    keyposes = []           # relocalization anchors (np poses)
    last_sig = None

    def emit(ev):
        events.append(ev)
        if log:
            log(ev)

    def shard_loads(smap):
        """(max nodes, max leaves) across shards: a host read, rare."""
        return (int(max(int(p.n_nodes) for p in smap.pools)),
                int(distributed.shard_leaf_counts(smap).max()))

    def maybe_rebalance(frame_idx, reason):
        """Re-cut the Morton ranges when one shard carries more than
        rebalance_factor x the mean leaf load. Returns True if it did."""
        nonlocal state
        counts = distributed.shard_leaf_counts(state.smap)
        mean = max(float(counts.mean()), 1.0)
        if counts.max() <= rebalance_factor * mean:
            return False
        smap = distributed.rebalance_sharded(state.smap, cfg, mesh)
        state = state._replace(smap=smap)
        emit({"event": "rebalance", "frame": frame_idx, "reason": reason,
              "counts_before": counts.tolist(),
              "counts_after": distributed.shard_leaf_counts(smap).tolist(),
              "bounds": smap.bounds.tolist()})
        return True

    lost = False            # the last known diverged flag (trails a frame)

    def handle_signals(sig_np, frame_idx):
        nonlocal state, cfg, step, lost
        grew = False
        max_nodes, max_leaves = sig_np[1], sig_np[2]
        leaf_ovf = sig_np[4] > 0.5
        grow_nodes = max_nodes > grow_headroom * cfg.node_capacity
        grow_leaves = leaf_ovf or (
            max_leaves > grow_headroom * cfg.leaf_capacity)
        cam = sig_np[8:11]
        if archive is not None and len(archive):
            # the archive's restore check: host arithmetic off the trailing
            # camera position
            from octree_slam_tpu_torch.parallel import tiering2d
            smap_r, cfg_r, n_rest = tiering2d.restore_due_sharded(
                state.smap, cfg, mesh, archive, camera_pos=cam)
            if n_rest:
                state = state._replace(smap=smap_r)
                if cfg_r is not cfg:
                    cfg = cfg_r
                    step = distributed.slam_step_2d(
                        cfg, mesh, render=render, sticky_gate=recovery)
                emit({"event": "map_restore", "frame": frame_idx,
                      "leaves": n_rest, "archived_cells": len(archive)})
        if grow_nodes and archive is not None:
            # pool pressure: archive cold regions before growing (a spill
            # can avert the doubling; an overflowed registry still grows)
            from octree_slam_tpu_torch.parallel import tiering2d
            smap_s, n_spill = tiering2d.spill_cold_sharded(
                state.smap, cfg, mesh, archive, camera_pos=cam)
            if n_spill:
                state = state._replace(smap=smap_s)
                mn, _ = shard_loads(state.smap)
                averted = mn <= grow_headroom * cfg.node_capacity
                grow_nodes = not averted
                emit({"event": "map_spill", "frame": frame_idx,
                      "leaves": n_spill, "archived_cells": len(archive),
                      "grow_averted": bool(averted)})
        if (grow_nodes or grow_leaves) and rebalance_factor is not None:
            # rebalance before growth: a hot shard's load may fit the
            # present capacity once spread (an overflowed registry still
            # grows: its registrations were dropped)
            if maybe_rebalance(frame_idx, "pre-grow"):
                mn, ml = shard_loads(state.smap)
                averted_n = grow_nodes and \
                    mn <= grow_headroom * cfg.node_capacity
                averted_l = grow_leaves and not leaf_ovf and \
                    ml <= grow_headroom * cfg.leaf_capacity
                grow_nodes = grow_nodes and not averted_n
                grow_leaves = grow_leaves and not averted_l
                if averted_n or averted_l:
                    emit({"event": "grow_averted", "frame": frame_idx,
                          "nodes": bool(averted_n),
                          "leaves": bool(averted_l),
                          "max_nodes": mn, "max_leaves": ml})
        if grow_nodes or grow_leaves:
            smap, cfg = distributed.grow_sharded(
                state.smap, cfg, mesh, grow_nodes=grow_nodes,
                grow_leaves=grow_leaves)
            state = state._replace(smap=smap)
            step = distributed.slam_step_2d(cfg, mesh, render=render,
                                            sticky_gate=recovery)
            grew = True
            emit({"event": "grow", "frame": frame_idx,
                  "nodes": bool(grow_nodes), "leaves": bool(grow_leaves),
                  "node_capacity": cfg.node_capacity,
                  "leaf_capacity": cfg.leaf_capacity})
        # the imbalance check reads the per-shard counts, an extra read:
        # only every rebalance_check_every frames, and not after a growth
        if rebalance_factor is not None and not grew and frame_idx > 0 and (
                frame_idx % rebalance_check_every == 0):
            maybe_rebalance(frame_idx, "periodic")
        # tracking loss: the latched flag gated fusion in the step; try to
        # re-anchor against the sharded map and clear it
        lost = sig_np[5] > 0.5
        if recovery and lost:
            pose_new, ok, diag = relocalize_2d(
                state, cfg, mesh, keyposes or [state.pose.cpu().numpy()])
            if ok:
                pose_t = torch.from_numpy(
                    np.asarray(pose_new, np.float32)).to(home)
                state = state._replace(
                    pose=pose_t,
                    diverged=torch.zeros((), dtype=torch.bool, device=home))
                if cfg.track_keyframe:
                    # the anchor predates the loss: re-seed it at the
                    # recovered pose with the latest frame's maps
                    state = state._replace(
                        key_pyramid=state.last_pyramid,
                        key_pose=pose_t.clone(),
                        key_T_cam=torch.eye(4, dtype=torch.float32,
                                            device=home))
                lost = False
            emit({"event": "relocalize" if ok else "relocalize_failed",
                  "frame": frame_idx, **diag})

    for i, frame in enumerate(frames):
        state, (fb, pose, sig) = step(state, frame)
        poses.append(pose)
        slot = slots.put(i, sig)
        if pending is not None:
            # trailing read: frame i is issued before frame i-1's vector is
            # waited on; growth acts a frame late, which the headroom
            # absorbs
            handle_signals(slots.read(pending), i - 1)
        pending = slot
        if recovery and not lost and i % cfg.keypose_every == 0:
            # the keypose ring: healthy anchors only (skipped while the
            # last known signals said diverged)
            keyposes.append(pose.cpu().numpy())
            keyposes[:] = keyposes[-max(cfg.reloc_candidates, 1):]

    if pending is not None:
        last_sig = slots.read(pending)
        handle_signals(last_sig, len(poses) - 1)

    info = {
        "poses": (torch.stack(poses).cpu().numpy() if poses
                  else np.zeros((0, 4, 4), np.float32)),
        "events": events,
        "last_signals": last_sig,
        "archived_cells": len(archive) if archive is not None else 0,
        "archive": archive,
    }
    return state, cfg, info
