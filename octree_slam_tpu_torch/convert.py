"""Carry SLAM state and frames between the JAX package and the port.

`state_from_numpy` takes a reference `SLAMState` after
`jax.tree_util.tree_map(np.asarray, state)` and builds the port's
`SLAMState` on a device; `state_to_numpy` goes back to nested dicts of
numpy arrays under the reference's field names (of a state on the "meta"
device, arrays with the fields' dtypes and shapes and no data: the
checkpoint reader's template). u32 words (pool values,
registry values, the dense mirror, the directory's values and the
saturation mask, whose bit 31 is the int32 sign bit) cross as int32 bit
patterns through `ndarray.view`, never by a cast, and u16 depth crosses as
int32. The state of a feature that is off crosses as the empty arrays
`init_state` makes. The render cache (`accel`)
crosses by its fields: `values`, `occ`, `dist` of a dense mirror, or
`entry` of an entry grid. This module reads only numpy arrays, so it needs
no jax.

`sharded_map_from_numpy` / `sharded_map_to_numpy` carry the reference's
Morton-sharded map (its `[M, ...]`-stacked ShardedMap, bounds `[M, M+1]`)
to the port's per-shard lists on a mesh's devices and back, and
`state2d_from_numpy` / `state2d_to_numpy` the 2-D mesh's state tuple
(parallel/distributed.State2D, the reference's tuple order).

`slam_state_leaf_names` / `state2d_leaf_names` give the reference's
pytree leaves in `jax.tree_util.tree_flatten` order, by the dotted names
of the nested dicts above (`pool.child`, `last_pyramid.0.vertex`,
`smap.bounds`): the reference package's checkpoints store leaf i as array
`a{i}`, and app.py / parallel/run2d.py read and write that file.

`clone_state` copies a port state (a SLAMState or a State2D):
`pipeline.step` and the sharded step update the map in place, so a state
that is to be stepped or rendered more than one way (a fidelity
comparison, a test) is cloned first.
"""

from __future__ import annotations

import numpy as np
import torch

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core.types import Frame, PyramidLevel
from octree_slam_tpu_torch.map.mips import RenderCache
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.pipeline import SLAMState
from octree_slam_tpu_torch.render.raycast import AccelGrid
from octree_slam_tpu_torch.render.splat import LeafList


# state fields that are one array each; the u32 ones come back as uint32
_PLAIN = ("initialized", "frame_idx", "diverged", "interior_stale",
          "key_pose", "key_T_cam", "dir_keys", "dir_nodes", "dir_vals",
          "dir_pos", "sat_mask", "mirror_stale", "stamps_stale")
_U32 = ("dir_vals", "sat_mask")


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


def state_from_numpy(np_tree, cfg: SLAMConfig, device="cuda") -> SLAMState:
    """Port state from a reference SLAMState whose leaves are numpy
    arrays. Capacities must match `cfg`."""
    p, lv = np_tree.pool, np_tree.leaves
    _expect_len("pool.child", p.child, cfg.node_capacity)
    _expect_len("leaves.keys", lv.keys, cfg.leaf_capacity)
    _expect_len("leaves.node2pos", lv.node2pos, cfg.node_capacity)
    _expect_len("dir_keys", np_tree.dir_keys,
                cfg.insert_unique_cap if cfg.insert_dircache else 0)
    _expect_len("sat_mask", np_tree.sat_mask,
                (1 << (3 * cfg.max_depth)) // 32 if cfg.saturation_gate
                else 0)
    if bool(len(np_tree.key_pyramid)) != cfg.track_keyframe:
        raise ValueError("state.key_pyramid does not fit cfg.track_keyframe")
    pool = SVONodePool(
        child=_t(p.child, device), value=_t(p.value, device),
        n_nodes=_t(p.n_nodes, device), center=_t(p.center, device),
        half_size=_t(p.half_size, device), overflowed=_t(p.overflowed, device))
    leaves = LeafList(
        keys=_t(lv.keys, device), nodes=_t(lv.nodes, device),
        vals=_t(lv.vals, device), node2pos=_t(lv.node2pos, device),
        count=_t(lv.count, device), overflowed=_t(lv.overflowed, device))
    ac = np_tree.accel
    if cfg.use_dense_mips != hasattr(ac, "values"):
        raise ValueError("state.accel does not fit cfg.use_dense_mips")
    accel = (RenderCache(values=_t(ac.values, device), occ=_t(ac.occ, device),
                         dist=_t(ac.dist, device))
             if cfg.use_dense_mips else AccelGrid(entry=_t(ac.entry, device)))
    return SLAMState(
        pool=pool, leaves=leaves, accel=accel, pose=_t(np_tree.pose, device),
        last_pyramid=_pyramid_of(np_tree.last_pyramid, device),
        key_pyramid=_pyramid_of(np_tree.key_pyramid, device),
        **{name: _t(getattr(np_tree, name), device) for name in _PLAIN})


def _np(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    if t.is_meta:
        # a template's field: the dtype and shape, with no data behind them
        a = np.empty(t.shape, torch.empty((), dtype=t.dtype).numpy().dtype)
    else:
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
        "accel": ({"values": _np(state.accel.values, u32=True),
                   "occ": _np(state.accel.occ), "dist": _np(state.accel.dist)}
                  if isinstance(state.accel, RenderCache)
                  else {"entry": _np(state.accel.entry)}),
        "pose": _np(state.pose),
        **{which: _pyramid_np(getattr(state, which))
           for which in ("last_pyramid", "key_pyramid")},
        **{name: _np(getattr(state, name), u32=name in _U32)
           for name in _PLAIN},
    }


def clone_state(state):
    """A copy of `state` that shares no tensor with it."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        if hasattr(x, "_fields"):
            return type(x)(*map(copy, x))
        return type(x)(map(copy, x))
    return copy(state)


def _pyramid_of(levels, device):
    return tuple(PyramidLevel(vertex=_t(l.vertex, device),
                              normal=_t(l.normal, device),
                              intensity=_t(l.intensity, device))
                 for l in levels)


def _pyramid_np(levels) -> list:
    return [{"vertex": _np(l.vertex), "normal": _np(l.normal),
             "intensity": _np(l.intensity)} for l in levels]


def sharded_map_from_numpy(np_smap, cfg: SLAMConfig, mesh):
    """The port's ShardedMap on `mesh` from the reference's stacked one
    whose leaves are numpy arrays: shard d's rows go to the device of map
    index d. Capacities and the shard count must match."""
    from octree_slam_tpu_torch.parallel import distributed
    devs = mesh.axis_devices(distributed.axis_name_of(mesh))
    p, lv = np_smap.pool, np_smap.leaves
    bounds = np.asarray(np_smap.bounds, np.int32)
    bounds = bounds[0] if bounds.ndim == 2 else bounds
    if bounds.shape[0] != len(devs) + 1:
        raise ValueError(f"the map has {bounds.shape[0] - 1} shards, the "
                         f"mesh's map axis {len(devs)}")
    for d in range(len(devs)):
        _expect_len("pool.child", np.asarray(p.child)[d], cfg.node_capacity)
        _expect_len("leaves.keys", np.asarray(lv.keys)[d],
                    cfg.leaf_capacity)

    def shard(tree, cls, d, dev):
        return cls(*(_t(np.asarray(getattr(tree, f))[d], dev)
                     for f in cls._fields))

    return distributed.ShardedMap(
        pools=[shard(p, SVONodePool, d, dev) for d, dev in enumerate(devs)],
        leaves=[shard(lv, LeafList, d, dev) for d, dev in enumerate(devs)],
        bounds=bounds.copy())


def sharded_map_to_numpy(smap) -> dict:
    """The reference's stacked layout as nested dicts of numpy arrays:
    every field [M, ...], bounds [M, M+1] (identical rows), packed words
    as uint32."""
    def stack(xs, fields, u32):
        return {f: np.stack([_np(getattr(x, f), u32=f in u32) for x in xs])
                for f in fields}
    m = len(smap.pools)
    return {"pool": stack(smap.pools, SVONodePool._fields, ("value",)),
            "leaves": stack(smap.leaves, LeafList._fields, ("vals",)),
            "bounds": np.broadcast_to(np.asarray(smap.bounds, np.int32),
                                      (m, m + 1)).copy()}


def state2d_from_numpy(np_state, cfg: SLAMConfig, mesh):
    """The port's 2-D state on `mesh` from the reference's
    (last_pyramid, pose, initialized, smap, diverged, key_pyramid,
    key_pose, key_T_cam) tuple of numpy arrays (or a namespace with those
    names, as the checkpoint reader makes): the map shard by shard, the
    rest on the mesh's home."""
    from octree_slam_tpu_torch.parallel.distributed import State2D
    if not isinstance(np_state, (tuple, list)):
        np_state = [getattr(np_state, f) for f in State2D._fields]
    (last_pyr, pose, init, smap, div, key_pyr, key_pose,
     key_T) = np_state
    if bool(len(key_pyr)) != cfg.track_keyframe:
        raise ValueError("state key_pyramid does not fit cfg.track_keyframe")
    home = mesh.home
    return State2D(
        last_pyramid=_pyramid_of(last_pyr, home), pose=_t(pose, home),
        initialized=_t(init, home),
        smap=sharded_map_from_numpy(smap, cfg, mesh),
        diverged=_t(div, home), key_pyramid=_pyramid_of(key_pyr, home),
        key_pose=_t(key_pose, home), key_T_cam=_t(key_T, home))


def state2d_to_numpy(state) -> dict:
    """Nested dicts of numpy arrays under State2D's field names, the map in
    the reference's stacked layout."""
    return {"last_pyramid": _pyramid_np(state.last_pyramid),
            "pose": _np(state.pose), "initialized": _np(state.initialized),
            "smap": sharded_map_to_numpy(state.smap),
            "diverged": _np(state.diverged),
            "key_pyramid": _pyramid_np(state.key_pyramid),
            "key_pose": _np(state.key_pose),
            "key_T_cam": _np(state.key_T_cam)}


# The reference's leaf order is its NamedTuples' field order (in the files
# of octree_slam_tpu/ named below), spelled out: state_to_numpy's dict puts
# key_pyramid beside last_pyramid, where the reference's SLAMState has it
# after interior_stale.
_POOL_FIELDS = ("child", "value", "n_nodes", "center", "half_size",
                "overflowed")                    # map/svo.py:57-63
_LEAF_FIELDS = ("keys", "nodes", "vals", "node2pos", "count",
                "overflowed")                    # render/splat.py:44-58
_LEVEL_FIELDS = ("vertex", "normal", "intensity")  # core/types.py:85-90


def _pyramid_names(which: str, levels: int) -> tuple:
    return tuple(f"{which}.{i}.{f}" for i in range(levels)
                 for f in _LEVEL_FIELDS)


def slam_state_leaf_names(cfg) -> tuple:
    """The reference SLAMState's leaves (octree_slam_tpu/pipeline.py:50-114)
    in tree_flatten order, as state_to_numpy's dotted names. Reads
    cfg.pyramid_depth, cfg.use_dense_mips (a RenderCache's three arrays,
    map/mips.py:63-68, or an AccelGrid's entry, render/raycast.py:50-53)
    and cfg.track_keyframe (off, key_pyramid is an empty tuple: no
    leaves)."""
    accel = ("values", "occ", "dist") if cfg.use_dense_mips else ("entry",)
    return (*(f"pool.{f}" for f in _POOL_FIELDS),
            *(f"leaves.{f}" for f in _LEAF_FIELDS),
            *(f"accel.{f}" for f in accel),
            "pose",
            *_pyramid_names("last_pyramid", cfg.pyramid_depth),
            "initialized", "frame_idx", "diverged", "interior_stale",
            *_pyramid_names("key_pyramid",
                            cfg.pyramid_depth if cfg.track_keyframe else 0),
            "key_pose", "key_T_cam",
            "dir_keys", "dir_nodes", "dir_vals", "dir_pos",
            "sat_mask", "mirror_stale", "stamps_stale")


def state2d_leaf_names(cfg) -> tuple:
    """The reference 2-D state's leaves in tree_flatten order, as
    state2d_to_numpy's dotted names: the tuple (last_pyramid, pose,
    initialized, ShardedMap(pool, leaves, bounds), diverged, key_pyramid,
    key_pose, key_T_cam) of octree_slam_tpu/parallel/distributed.py:866-884
    and :114-127, every map array stacked [M, ...]."""
    return (*_pyramid_names("last_pyramid", cfg.pyramid_depth),
            "pose", "initialized",
            *(f"smap.pool.{f}" for f in _POOL_FIELDS),
            *(f"smap.leaves.{f}" for f in _LEAF_FIELDS),
            "smap.bounds", "diverged",
            *_pyramid_names("key_pyramid",
                            cfg.pyramid_depth if cfg.track_keyframe else 0),
            "key_pose", "key_T_cam")


def frame_from_numpy(depth: np.ndarray, color: np.ndarray, timestamp=0.0,
                     device="cuda") -> Frame:
    """A port Frame from u16 depth [H, W] and u8 colour [H, W, 3]."""
    return Frame(depth=_t(depth, device), color=_t(color, device),
                 timestamp=torch.tensor(float(np.asarray(timestamp)),
                                        dtype=torch.float32, device=device))
