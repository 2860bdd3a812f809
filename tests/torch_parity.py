"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; data
crosses as numpy arrays (u32 words as int32 bit patterns, u16 depth as
int32). torch is pinned to one thread: the test workers share the cores.
Each port test module runs at the lowest CPU priority (`yield_cpu`, an
autouse fixture every CPU test file imports), so that the JAX package's long
multi-device files, which set when a whole run ends, keep their share.
The port's entry points put their tensors on the card unless told
otherwise, so the CPU tests pass `device=DEVICE`; each package gets its own
config (`port_config`).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from octree_slam_tpu_torch.config import SLAMConfig as PortConfig

torch.set_num_threads(1)

INVALID_KEY = 0x7FFFFFFF
# where the parity tests run the port
DEVICE = "cpu"


def _set_priority(nice: int) -> None:
    """Give every thread of this process the nice value `nice` (Linux keeps
    one a thread; threads started later inherit their creator's)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.setpriority(os.PRIO_PROCESS, int(tid), nice)
        except OSError:  # the thread ended meanwhile
            pass


@functools.cache
def _priority_restorable() -> bool:
    """Whether this process may lower a nice value again (root, or a
    large enough RLIMIT_NICE): without that a worker would stay at the
    lowest priority for the JAX files it runs after a port test."""
    if not os.path.isdir("/proc/self/task"):
        return False
    base = os.getpriority(os.PRIO_PROCESS, 0)
    try:
        os.setpriority(os.PRIO_PROCESS, 0, base + 1)
        os.setpriority(os.PRIO_PROCESS, 0, base)
    except OSError:
        return False
    return True


@pytest.fixture(scope="module", autouse=True)
def yield_cpu():
    """Run the test module (its module fixtures too) at nice 19 and
    restore the worker's priority after it.

    The test workers share the cores, and the JAX package's multi-device
    files (tests/test_run2d.py takes about 1,100 s alone) run from the
    start of a whole run to its end: at the lowest priority the port's
    tests take the cores those leave idle instead of slowing them."""
    if not _priority_restorable():
        yield
        return
    base = os.getpriority(os.PRIO_PROCESS, 0)
    _set_priority(19)
    try:
        yield
    finally:
        _set_priority(base)


def port_config(jax_cfg) -> PortConfig:
    """The port's SLAMConfig with every field of the JAX package's one."""
    return PortConfig(**{f.name: getattr(jax_cfg, f.name)
                         for f in dataclasses.fields(jax_cfg)})


def to_t(x) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor with the port's dtypes."""
    a = np.array(x, order="C", copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(a)


def words(x) -> np.ndarray:
    """Packed words of either package as uint32 numpy."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int32).view(np.uint32) if a.dtype != np.uint32 else a


def rand_depth(h, w, seed, batch=None):
    """Random u16 depth in [400, 6000) mm with 10% zero holes."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if batch is None else (batch, h, w)
    d = rng.uniform(400, 6000, shape).astype(np.uint16)
    d[rng.random(shape) < 0.1] = 0
    return d


def surface_depth(h, w, seed, batch=None):
    """u16 depth of a noisy surface: a slanted wave (about 1,000 to 4,100
    mm at 640x480), a 300 mm step at mid-width, noise of 15 mm (within a
    bilateral's sigma_depth of 40 mm, so every tap of the window carries
    weight) and 5% zero holes. rand_depth's neighbours lie so far apart in
    depth that a bilateral's output rests mostly on its centre tap."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if batch is None else (batch, h, w)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (2000 + 500 * np.sin(x / 37 + 0.3 * y / 23) * np.cos(y / 29)
            + 2 * x - y + 300 * (x >= w // 2))
    d = base + rng.normal(0, 15, shape)
    d = np.clip(np.rint(d), 400, 6000).astype(np.uint16)
    d[rng.random(shape) < 0.05] = 0
    return d


def random_cloud(n, seed, lo=-0.9, hi=0.9):
    """Random points in [lo, hi)^3 with colours in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, cols


def orbit_frames(cfg, n, step_angle=0.015, radius=2.0):
    """The reference package's synthetic orbit stream as numpy:
    (depth u16 [n,H,W], color u8 [n,H,W,3], gt poses f32 [n,4,4])."""
    import jax.numpy as jnp
    from octree_slam_tpu.sensor import sources
    scene = sources.default_scene()
    depths, colors, poses = [], [], []
    for i in range(n):
        gt = sources.orbit_pose(i * step_angle, radius=radius)
        f = sources.render_frame(scene, jnp.asarray(gt), cfg.focal_x,
                                 cfg.focal_y, width=cfg.width,
                                 height=cfg.height)
        depths.append(np.asarray(f.depth))
        colors.append(np.asarray(f.color))
        poses.append(np.asarray(gt))
    return np.stack(depths), np.stack(colors), np.stack(poses)


def assert_mirror_equal(tcache, jcache, what="", lo=0):
    """A port RenderCache against a JAX one, word for word: `values` from
    cell `lo` on, `occ` and `dist`."""
    np.testing.assert_array_equal(words(tcache.values)[lo:],
                                  np.asarray(jcache.values)[lo:],
                                  err_msg=f"{what} values from cell {lo}")
    np.testing.assert_array_equal(tcache.occ.numpy(), np.asarray(jcache.occ),
                                  err_msg=f"{what} occ")
    np.testing.assert_array_equal(tcache.dist.numpy(),
                                  np.asarray(jcache.dist),
                                  err_msg=f"{what} dist")


def close_share(a, b, tol=1e-4) -> float:
    """Share of pixels (rows of the last axis) whose every channel agrees
    within `tol`."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    with np.errstate(invalid="ignore"):
        same = (np.abs(a - b) <= tol) | ((a == b))   # inf == inf counts
    return float(same.all(-1).mean())


def jax_frame(depth, color, i):
    """Frame i of a numpy stream as the JAX package's Frame."""
    import jax.numpy as jnp
    from octree_slam_tpu.sensor import sources
    return sources.Frame(jnp.asarray(depth[i]), jnp.asarray(color[i]),
                         jnp.float32(0))


def step_both(jstate, tstate, cfg, tcfg, stream, i, render):
    """Frame i of `stream` through the JAX step and the port's step.
    Returns (jstate, jout, tstate, tout)."""
    from octree_slam_tpu import pipeline as jpipeline
    from octree_slam_tpu_torch import convert, pipeline
    depth, color, _ = stream
    jstate, jo = jpipeline.step(jstate, jax_frame(depth, color, i), cfg,
                                render=render)
    tstate, to = pipeline.step(
        tstate, convert.frame_from_numpy(depth[i], color[i], device=DEVICE),
        tcfg, render=render)
    return jstate, jo, tstate, to


def assert_step_parity(tstate, to, jstate, jo, where, pose_atol=1e-4,
                       fb_share=0.99, exact=True):
    """One frame's outputs and the state's integer structures, port against
    JAX: pose within `pose_atol`; node and leaf counts, the overflow and
    divergence flags and the three staleness flags equal; at least
    `fb_share` of the framebuffer's pixels within 1e-4; the saturation mask
    and the directory cache (keys, nodes, values, positions) bit for bit;
    the keyframe anchor's pose and seed within `pose_atol`. With
    exact=False (a stream whose poses differ in the last bits, so that a
    point on a cell boundary may fall into the neighbouring leaf) the
    counts may differ by 1% and the integer structures are not compared."""
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               atol=pose_atol, err_msg=where)
    for name in ("map_nodes", "map_leaves") + (("last_insert_key",) if exact
                                               else ()):
        j, t = int(getattr(jo, name)), int(getattr(to, name))
        assert abs(t - j) <= (0 if exact else 0.01 * j), (where, name, t, j)
    for name in ("diverged", "map_overflowed", "unique_overflow"):
        assert bool(getattr(to, name)) == bool(getattr(jo, name)), \
            (where, name)
    for flag in ("interior_stale", "mirror_stale", "stamps_stale",
                 "initialized"):
        assert bool(getattr(tstate, flag)) == bool(getattr(jstate, flag)), \
            (where, flag)
    assert bool(torch.isfinite(to.framebuffer).all()), where
    assert close_share(to.framebuffer, jo.framebuffer) >= fb_share, where
    for name in (("sat_mask", "dir_keys", "dir_nodes", "dir_vals", "dir_pos")
                 if exact else ()):
        np.testing.assert_array_equal(
            words(getattr(tstate, name)), words(getattr(jstate, name)),
            err_msg=f"{where} {name}")
    for name in ("key_pose", "key_T_cam"):
        np.testing.assert_allclose(
            getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
            atol=pose_atol, err_msg=f"{where} {name}")
    assert len(tstate.key_pyramid) == len(jstate.key_pyramid), where


def assert_leaf_level_equal(tcache, jcache, max_depth, what=""):
    """The part of the dense mirror a lazy hybrid frame keeps, port against
    JAX, word for word: the leaf level of `values` with its distance
    stamps, `occ` and `dist`."""
    assert_mirror_equal(tcache, jcache, what,
                        lo=((1 << (3 * max_depth)) - 8) // 7)


def np_state(state):
    """A JAX state with numpy leaves (what convert.state_from_numpy reads)."""
    import jax
    return jax.tree_util.tree_map(np.asarray, state)


def assert_state_equal(tstate, jstate, where="", pose_atol=1e-4):
    """A port state against a JAX one: the pool, the leaf registry, the
    render cache, the saturation mask, the directory cache and the flags
    bit for bit; the pose within `pose_atol`."""
    def eq(t, j, name):
        j = np.asarray(j)
        np.testing.assert_array_equal(
            words(t) if j.dtype == np.uint32 else t.numpy(), j,
            err_msg=f"{where} {name}")
    for name in ("child", "value", "n_nodes", "overflowed", "center",
                 "half_size"):
        eq(getattr(tstate.pool, name), getattr(jstate.pool, name),
           f"pool.{name}")
    for name in ("keys", "nodes", "vals", "node2pos", "count", "overflowed"):
        eq(getattr(tstate.leaves, name), getattr(jstate.leaves, name),
           f"leaves.{name}")
    for name in type(tstate.accel)._fields:
        eq(getattr(tstate.accel, name), getattr(jstate.accel, name),
           f"accel.{name}")
    for name in ("sat_mask", "dir_keys", "dir_nodes", "dir_vals", "dir_pos",
                 "interior_stale", "mirror_stale", "stamps_stale",
                 "diverged", "initialized", "frame_idx"):
        eq(getattr(tstate, name), getattr(jstate, name), name)
    np.testing.assert_allclose(tstate.pose.numpy(), np.asarray(jstate.pose),
                               atol=pose_atol, err_msg=f"{where} pose")


def orbit_port_frames(stream, device=DEVICE):
    """A numpy stream (orbit_frames) as port Frames."""
    from octree_slam_tpu_torch import convert
    depth, color, _ = stream
    return [convert.frame_from_numpy(depth[i], color[i], device=device)
            for i in range(depth.shape[0])]


def write_field_file(path, tree, stamps: dict) -> None:
    """A checkpoint in the port's earlier layout (before it wrote the
    reference package's file): the stamps and every array of `tree`
    (convert.state_to_numpy / state2d_to_numpy) under `field:<dotted
    name>`. The port's readers still take it."""
    from octree_slam_tpu_torch.app import _flatten
    np.savez_compressed(path, **stamps, **{
        "field:" + k: v for k, v in _flatten(tree).items()})


def reference_leaf_names(tree, top=None) -> list:
    """The dotted names of a JAX pytree's leaves in tree_flatten order
    (`pool.child`, `last_pyramid.0.vertex`, a tuple's items by index, or
    for a tuple at the top by `top[index]`)."""
    import jax
    names = []
    for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "name", getattr(k, "idx", k))) for k in kp]
        if top is not None:
            parts[0] = top[kp[0].idx]
        names.append(".".join(parts))
    return names
