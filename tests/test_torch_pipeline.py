"""Port parity for the whole slice: pipeline.step(render="splat") against
the JAX package from one carried-over state, the port's own ATE, the
synthetic sources, state conversion, and that the port runs without jax.

Tolerances (world points go through a 3x3 product that rounds differently
in the two libraries, so keys at cell boundaries may flip): poses within
1e-4, map_nodes / map_leaves within 1%, at least 99% of framebuffer pixels
identical as 8-bit colours, flags equal."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import orbit_frames, to_t

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.sensor import sources as jsources
from octree_slam_tpu.utils.metrics import ate_rmse
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.sensor import sources

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def stream():
    return orbit_frames(CFG, 4)


def _np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


def test_step_parity_from_carried_state(stream):
    depth, color, gt = stream
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    for i in range(2):
        jstate, _ = jpipeline.step(jstate, jsources.Frame(
            jnp.asarray(depth[i]), jnp.asarray(color[i]), jnp.float32(0)),
            CFG)
    tstate = convert.state_from_numpy(_np_state(jstate), CFG)
    for i in range(2, 4):
        jstate, jo = jpipeline.step(jstate, jsources.Frame(
            jnp.asarray(depth[i]), jnp.asarray(color[i]), jnp.float32(0)),
            CFG)
        tstate, to = pipeline.step(
            tstate, convert.frame_from_numpy(depth[i], color[i]), CFG)
        np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                                   atol=1e-4)
        for name in ("map_nodes", "map_leaves"):
            j, t = int(getattr(jo, name)), int(getattr(to, name))
            assert abs(t - j) <= 0.01 * j, (name, t, j)
        for name in ("diverged", "map_overflowed", "unique_overflow"):
            assert bool(getattr(to, name)) == bool(getattr(jo, name)), name
        np.testing.assert_array_equal(to.track_inliers.numpy(),
                                      np.asarray(jo.track_inliers))
        fb_same = (np.round(to.framebuffer.numpy() * 255)
                   == np.round(np.asarray(jo.framebuffer) * 255)).all(-1)
        assert fb_same.mean() >= 0.99, fb_same.mean()
    assert int(to.map_leaves) > 500 and not bool(to.map_overflowed)
    back = convert.state_to_numpy(tstate)
    jnp_state = _np_state(jstate)
    for name in ("interior_stale", "mirror_stale", "stamps_stale",
                 "initialized", "frame_idx"):
        assert back[name] == getattr(jnp_state, name), name


def test_port_orbit_ate(stream):
    depth, color, gt = stream
    state = pipeline.init_state(CFG, initial_pose=to_t(gt[0]))
    est = []
    for i in range(4):
        state, out = pipeline.step(
            state, convert.frame_from_numpy(depth[i], color[i]), CFG)
        est.append(out.pose.numpy())
        assert not bool(out.diverged) and not bool(out.map_overflowed)
    assert ate_rmse(np.stack(est), gt) < 0.01
    assert (out.framebuffer[..., 3] > 0).sum() > 100
    # render="none" runs the same track + fuse with an empty framebuffer
    state, out = pipeline.step(
        state, convert.frame_from_numpy(depth[3], color[3]), CFG,
        render="none")
    assert float(out.framebuffer.abs().max()) == 0.0


def test_unique_cap_pages_in_step(stream):
    depth, color, gt = stream
    cfg = dataclasses.replace(CFG, insert_unique_cap=1 << 7)
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(gt[0]))
    tstate = pipeline.init_state(cfg, initial_pose=to_t(gt[0]))
    jstate, jo = jpipeline.step(jstate, jsources.Frame(
        jnp.asarray(depth[0]), jnp.asarray(color[0]), jnp.float32(0)), cfg)
    tstate, to = pipeline.step(
        tstate, convert.frame_from_numpy(depth[0], color[0]), cfg)
    # first frame: identical pose, so the paged map is bit-identical
    assert int(to.map_leaves) == int(jo.map_leaves) > (1 << 7)
    assert int(to.last_insert_key) == int(jo.last_insert_key)
    assert not bool(to.unique_overflow)
    np.testing.assert_array_equal(tstate.pool.child.numpy(),
                                  np.asarray(jstate.pool.child))


@pytest.mark.parametrize("change,render", [
    ({"track_keyframe": True}, "splat"),
    ({"saturation_gate": True}, "splat"),
    ({"insert_dircache": True}, "splat"),
    ({"w_rgbd": 0.1}, "splat"),
    ({"lazy_interior": False}, "splat"),
    ({"device_remainder": False}, "splat"),
    ({}, "cone"),
    ({}, "cone_hybrid"),
])
def test_unported_branches_raise(change, render):
    cfg = dataclasses.replace(CFG, **change)
    with pytest.raises(NotImplementedError):
        pipeline.check_supported(cfg, render)
    if change:
        with pytest.raises(NotImplementedError):
            pipeline.init_state(cfg)


def test_sources_match_reference():
    pose_j = jsources.orbit_pose(0.25, radius=2.0)
    pose_t = sources.orbit_pose(0.25, radius=2.0)
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-6)
    jf = jsources.render_frame(jsources.default_scene(), pose_j, 55.0, 55.0,
                               width=64, height=48)
    tf = sources.render_frame(sources.default_scene(), pose_t, 55.0, 55.0,
                              width=64, height=48)
    dd = np.abs(tf.depth.numpy() - np.asarray(jf.depth).astype(np.int64))
    assert dd.max() <= 1 and (dd > 0).mean() <= 0.01
    dc = np.abs(tf.color.numpy().astype(int) - np.asarray(jf.color))
    assert dc.max() <= 1
    rs = sources.ReplaySource(np.asarray(jf.depth)[None],
                              np.asarray(jf.color)[None])
    f0 = rs.frame(0)
    assert len(rs) == 1 and f0.depth.dtype == torch.int32
    np.testing.assert_array_equal(f0.depth.numpy(), np.asarray(jf.depth))


def test_port_imports_and_steps_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "from octree_slam_tpu.config import SLAMConfig\n"
        "from octree_slam_tpu_torch import pipeline, convert, _build\n"
        "from octree_slam_tpu_torch.sensor import sources\n"
        "from octree_slam_tpu_torch.utils import metrics, timing\n"
        "cfg = SLAMConfig(width=32, height=24, focal_x=28.0, focal_y=28.0,"
        " pyramid_depth=2, pyramid_iters=(2, 2), voxel_resolution=0.1,"
        " max_depth=5, node_capacity=1 << 12, leaf_capacity=1 << 10,"
        " insert_unique_cap=1 << 9)\n"
        "pose = sources.orbit_pose(0.0)\n"
        "f = sources.render_frame(sources.default_scene(), pose,"
        " cfg.focal_x, cfg.focal_y, width=32, height=24)\n"
        "s = pipeline.init_state(cfg, initial_pose=pose)\n"
        "s, out = pipeline.step(s, f, cfg)\n"
        "assert int(out.map_leaves) > 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.')"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_convert_round_trip(stream):
    depth, color, gt = stream
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    jstate, _ = jpipeline.step(jstate, jsources.Frame(
        jnp.asarray(depth[0]), jnp.asarray(color[0]), jnp.float32(0)), CFG)
    ref = _np_state(jstate)
    back = convert.state_to_numpy(convert.state_from_numpy(ref, CFG))
    for group in ("pool", "leaves"):
        for name, arr in back[group].items():
            want = np.asarray(getattr(getattr(ref, group), name))
            assert arr.dtype == want.dtype, (group, name)
            np.testing.assert_array_equal(arr, want, err_msg=name)
    np.testing.assert_array_equal(back["pose"], ref.pose)
    for lvl, want in zip(back["last_pyramid"], ref.last_pyramid):
        np.testing.assert_array_equal(lvl["vertex"], want.vertex)
    with pytest.raises(ValueError):
        convert.state_from_numpy(
            ref, dataclasses.replace(CFG, node_capacity=1 << 15))
