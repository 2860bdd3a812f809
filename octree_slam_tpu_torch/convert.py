"""Carry SLAM state and frames between the JAX package and the port.

`state_from_numpy` takes a reference `SLAMState` after
`jax.tree_util.tree_map(np.asarray, state)` and builds the port's
`SLAMState` on a device; `state_to_numpy` goes back to nested dicts of
numpy arrays under the reference's field names. u32 words (pool values,
registry values) cross as int32 bit patterns through `ndarray.view`, u16
depth crosses as int32, and the render cache (`accel`) is dropped. This
module reads only numpy arrays, so it needs no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu_torch.core.types import Frame, PyramidLevel
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.pipeline import SLAMState
from octree_slam_tpu_torch.render.splat import LeafList


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.array(x, order="C", copy=True)   # keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _expect_len(name: str, arr, n: int) -> None:
    if np.asarray(arr).shape[0] != n:
        raise ValueError(f"{name} has {np.asarray(arr).shape[0]} rows, the "
                         f"config says {n}")


def state_from_numpy(np_tree, cfg: SLAMConfig, device="cpu") -> SLAMState:
    """Port state from a reference SLAMState whose leaves are numpy
    arrays. Capacities must match `cfg`; state of an unported feature
    (directory cache, saturation mask, keyframe anchor) is rejected."""
    p, lv = np_tree.pool, np_tree.leaves
    _expect_len("pool.child", p.child, cfg.node_capacity)
    _expect_len("leaves.keys", lv.keys, cfg.leaf_capacity)
    _expect_len("leaves.node2pos", lv.node2pos, cfg.node_capacity)
    for name in ("dir_keys", "sat_mask", "key_pose"):
        if np.asarray(getattr(np_tree, name)).size:
            raise NotImplementedError(
                f"state carries {name}: that feature is not ported yet")
    pool = SVONodePool(
        child=_t(p.child, device), value=_t(p.value, device),
        n_nodes=_t(p.n_nodes, device), center=_t(p.center, device),
        half_size=_t(p.half_size, device), overflowed=_t(p.overflowed, device))
    leaves = LeafList(
        keys=_t(lv.keys, device), nodes=_t(lv.nodes, device),
        vals=_t(lv.vals, device), node2pos=_t(lv.node2pos, device),
        count=_t(lv.count, device), overflowed=_t(lv.overflowed, device))
    pyramid = tuple(
        PyramidLevel(vertex=_t(l.vertex, device), normal=_t(l.normal, device),
                     intensity=_t(l.intensity, device))
        for l in np_tree.last_pyramid)
    return SLAMState(
        pool=pool, leaves=leaves, accel=None, pose=_t(np_tree.pose, device),
        last_pyramid=pyramid,
        initialized=_t(np_tree.initialized, device),
        frame_idx=_t(np_tree.frame_idx, device),
        diverged=_t(np_tree.diverged, device),
        interior_stale=_t(np_tree.interior_stale, device),
        mirror_stale=_t(np_tree.mirror_stale, device),
        stamps_stale=_t(np_tree.stamps_stale, device))


def _np(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if u32 else a


def state_to_numpy(state: SLAMState) -> dict:
    """Nested dicts of numpy arrays under the reference's field names;
    packed words come back as uint32."""
    p, lv = state.pool, state.leaves
    return {
        "pool": {"child": _np(p.child), "value": _np(p.value, u32=True),
                 "n_nodes": _np(p.n_nodes), "center": _np(p.center),
                 "half_size": _np(p.half_size),
                 "overflowed": _np(p.overflowed)},
        "leaves": {"keys": _np(lv.keys), "nodes": _np(lv.nodes),
                   "vals": _np(lv.vals, u32=True),
                   "node2pos": _np(lv.node2pos), "count": _np(lv.count),
                   "overflowed": _np(lv.overflowed)},
        "pose": _np(state.pose),
        "last_pyramid": [{"vertex": _np(l.vertex), "normal": _np(l.normal),
                          "intensity": _np(l.intensity)}
                         for l in state.last_pyramid],
        **{name: _np(getattr(state, name))
           for name in ("initialized", "frame_idx", "diverged",
                        "interior_stale", "mirror_stale", "stamps_stale")},
    }


def frame_from_numpy(depth: np.ndarray, color: np.ndarray, timestamp=0.0,
                     device="cpu") -> Frame:
    """A port Frame from u16 depth [H, W] and u8 colour [H, W, 3]."""
    return Frame(depth=_t(depth, device), color=_t(color, device),
                 timestamp=torch.tensor(float(np.asarray(timestamp)),
                                        dtype=torch.float32, device=device))
