"""Port parity for the whole slice: pipeline.step with every render
("splat", "cone", "cone_march", "cone_hybrid") and every optional feature
against the JAX package from one carried-over state, the port's own ATE,
the unique-cap pages, state conversion, and that the port runs without jax
and without the JAX package. Streams that mix the renders, the heal and
cloning are in tests/test_torch_pipeline_streams.py; check_supported, the
sources and the entry points' default device in
tests/test_torch_pipeline_api.py.

Tolerances (world points go through a 3x3 product that rounds differently
in the two libraries, so keys at cell boundaries may flip): poses within
1e-4, map_nodes / map_leaves within 1%, at least 99% of framebuffer pixels
identical as 8-bit colours, flags equal. The streams that start from
init_state in both packages share their first frame's pose exactly and
stay closer: nodes, leaves and the three staleness flags equal after every
frame, at least 99% of framebuffer pixels within 1e-4, and the dense
mirror (values, occ, dist) equal word for word after every eager frame
unless a leaf count differs. The feature streams also hold the saturation
mask and the directory cache bit for bit and the mirror's leaf level after
hybrid and march frames; the two keyframe streams, whose anchored solve
ends a few 1e-7 from the reference's, compare counts within 1% and no
integer structure."""

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

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_leaf_level_equal, assert_step_parity,
                          jax_frame, orbit_frames, port_config, step_both,
                          to_t)

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.sensor import sources as jsources
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.utils.metrics import ate_rmse

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10,
                 max_march_iters=48)
TCFG = port_config(CFG)
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
    tstate = convert.state_from_numpy(_np_state(jstate), TCFG, device=DEVICE)
    for i in range(2, 4):
        jstate, jo = jpipeline.step(jstate, jsources.Frame(
            jnp.asarray(depth[i]), jnp.asarray(color[i]), jnp.float32(0)),
            CFG)
        tstate, to = pipeline.step(
            tstate, convert.frame_from_numpy(depth[i], color[i],
                                             device=DEVICE), TCFG)
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
    state = pipeline.init_state(TCFG, initial_pose=to_t(gt[0]),
                                device=DEVICE)
    est = []
    for i in range(4):
        state, out = pipeline.step(
            state, convert.frame_from_numpy(depth[i], color[i],
                                            device=DEVICE), TCFG)
        est.append(out.pose.numpy())
        assert not bool(out.diverged) and not bool(out.map_overflowed)
    assert ate_rmse(np.stack(est), gt) < 0.01
    assert (out.framebuffer[..., 3] > 0).sum() > 100
    # render="none" runs the same track + fuse with an empty framebuffer
    state, out = pipeline.step(
        state, convert.frame_from_numpy(depth[3], color[3], device=DEVICE),
        TCFG, render="none")
    assert float(out.framebuffer.abs().max()) == 0.0


def test_unique_cap_pages_in_step(stream):
    depth, color, gt = stream
    cfg = dataclasses.replace(CFG, insert_unique_cap=1 << 7)
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(gt[0]))
    tstate = pipeline.init_state(port_config(cfg), initial_pose=to_t(gt[0]),
                                 device=DEVICE)
    jstate, jo = jpipeline.step(jstate, jsources.Frame(
        jnp.asarray(depth[0]), jnp.asarray(color[0]), jnp.float32(0)), cfg)
    tstate, to = pipeline.step(
        tstate, convert.frame_from_numpy(depth[0], color[0], device=DEVICE),
        port_config(cfg))
    # first frame: identical pose, so the paged map is bit-identical
    assert int(to.map_leaves) == int(jo.map_leaves) > (1 << 7)
    assert int(to.last_insert_key) == int(jo.last_insert_key)
    assert not bool(to.unique_overflow)
    np.testing.assert_array_equal(tstate.pool.child.numpy(),
                                  np.asarray(jstate.pool.child))


# The step features and the hybrid render, each as a short stream against
# the JAX package (one compile of the JAX step per case). The first nine are
# the configurations the port used to reject.
FEATURE_CASES = [
    ({"track_keyframe": True}, "splat"),
    ({"saturation_gate": True}, "splat"),
    ({"insert_dircache": True}, "splat"),
    ({"w_rgbd": 0.1}, "splat"),
    ({"track_keyframe": True, "lazy_interior": False}, "splat"),
    ({"device_remainder": False}, "splat"),
    ({"insert_dircache": True}, "cone"),
    ({}, "cone_hybrid"),
    ({"saturation_gate": True}, "cone_march"),
]


@pytest.mark.parametrize("change,render", FEATURE_CASES)
def test_step_features_run_against_reference(stream, change, render):
    cfg = dataclasses.replace(CFG, **change)
    tcfg = port_config(cfg)
    pipeline.check_supported(tcfg, render)
    gt = stream[2]
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(gt[0]))
    tstate = pipeline.init_state(tcfg, initial_pose=to_t(gt[0]),
                                 device=DEVICE)
    for name in ("dir_keys", "dir_pos", "sat_mask", "key_pose", "key_T_cam"):
        assert getattr(tstate, name).shape == getattr(jstate, name).shape
    for i in range(3):
        jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                           i, render)
        # the anchored solve ends a few 1e-7 from the reference's, which
        # moves a leaf or two across a cell boundary
        assert_step_parity(tstate, to, jstate, jo,
                           f"{change} {render} frame {i}",
                           exact=not cfg.track_keyframe)
        # the caller's pager, where the step leaves the pages to it
        uo, lk, pages = to.unique_overflow, to.last_insert_key, 0
        assert not (cfg.device_remainder and bool(uo))
        assert cfg.device_remainder or i > 0 or bool(uo)
        while bool(uo):
            jstate, (juo, jlk) = jpipeline.insert_remainder(
                jstate, jax_frame(*stream[:2], i), cfg, jo.last_insert_key
                if pages == 0 else jlk)
            tstate, (uo, lk) = pipeline.insert_remainder(
                tstate, convert.frame_from_numpy(*(a[i] for a in stream[:2]),
                                                 device=DEVICE), tcfg, lk)
            pages += 1
            assert (bool(uo), int(lk)) == (bool(juo), int(jlk))
            assert int(tstate.leaves.count) == int(jstate.leaves.count)
            np.testing.assert_array_equal(tstate.pool.child.numpy(),
                                          np.asarray(jstate.pool.child))
        assert not bool(to.diverged)
        if render in ("cone_hybrid", "cone_march"):
            assert_leaf_level_equal(tstate.accel, jstate.accel,
                                    cfg.max_depth, f"frame {i}")
    assert int(to.map_leaves) > 500
    assert float((to.framebuffer[..., :3].sum(-1) > 0).float().mean()) > 0.3
    if cfg.insert_dircache:
        assert int((tstate.dir_pos >= 0).sum()) > 500
    if cfg.track_keyframe:
        assert not torch.equal(tstate.key_T_cam, torch.eye(4))


def test_port_imports_and_steps_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['octree_slam_tpu'] = None\n"
        "import torch\n"
        "from octree_slam_tpu_torch import SLAMConfig\n"
        "from octree_slam_tpu_torch import pipeline, convert, _build\n"
        "from octree_slam_tpu_torch.sensor import sources\n"
        "from octree_slam_tpu_torch.utils import metrics, timing\n"
        "from octree_slam_tpu_torch.map import mips\n"
        "from octree_slam_tpu_torch.render import conesplat, hybrid, raycast\n"
        "from octree_slam_tpu_torch import app, relocalize\n"
        "from octree_slam_tpu_torch.map import octree, tiering\n"
        "from octree_slam_tpu_torch.io import png, tum, obj, bmp\n"
        "from octree_slam_tpu_torch.core import camera, se3, types\n"
        "from octree_slam_tpu_torch.map import voxelization\n"
        "from octree_slam_tpu_torch.render import points, raster, renderer\n"
        "from octree_slam_tpu_torch.render import camera_controller\n"
        "from octree_slam_tpu_torch import scene, viewer, live_viewer\n"
        "from octree_slam_tpu_torch.utils import fma\n"
        "cfg = SLAMConfig(width=32, height=24, focal_x=28.0, focal_y=28.0,"
        " pyramid_depth=2, pyramid_iters=(2, 2), voxel_resolution=0.1,"
        " max_depth=5, node_capacity=1 << 12, leaf_capacity=1 << 10,"
        " insert_unique_cap=1 << 9)\n"
        "pose = sources.orbit_pose(0.0, device='cpu')\n"
        "f = sources.render_frame(sources.default_scene('cpu'), pose,"
        " cfg.focal_x, cfg.focal_y, width=32, height=24)\n"
        "s = pipeline.init_state(cfg, initial_pose=pose, device='cpu')\n"
        "s, out = pipeline.step(s, f, cfg)\n"
        "assert int(out.map_leaves) > 0\n"
        "for render in ('cone', 'cone_march', 'cone_hybrid'):\n"
        "    s, out = pipeline.step(s, f, cfg, render=render)\n"
        "    assert float(out.framebuffer[..., :3].max()) > 0\n"
        "res = app.main(['--frames', '2', '--width', '32', '--height', '24',"
        " '--max-depth', '5', '--resolution', '0.1', '--log-every', '0',"
        " '--device', 'cpu'])\n"
        "assert res.frames == 2 and not res.diverged\n"
        "import tempfile, os\n"
        "d = tempfile.mkdtemp()\n"
        "p = os.path.join(d, 'q.obj')\n"
        "open(p, 'w').write('v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nv 1 1 0.2\\n"
        "f 1 2 4 3\\n')\n"
        "sc = scene.Scene(SLAMConfig(vox_log_n=4, vox_tri_budget=64,"
        " node_capacity=1 << 13, extract_capacity=1 << 10), device='cpu')\n"
        "sc.load_obj_file(p)\n"
        "g = sc.voxelize_meshes(octree=True)\n"
        "assert int(g.count) > 0\n"
        "cam = camera.make_camera((0.5, 0.5, 2.0), (0.5, 0.5, 0.0),"
        " (0.0, 1.0, 0.0), 60.0, 4 / 3, device='cpu')\n"
        "fb = renderer.Renderer(32, 24).rasterize(sc.meshes[0], cam)\n"
        "assert float(fb[..., 3].sum()) > 0\n"
        "from octree_slam_tpu_torch.parallel import distributed, run2d\n"
        "from octree_slam_tpu_torch.parallel import tiering2d\n"
        "from octree_slam_tpu_torch.io import native\n"
        "mesh = distributed.make_mesh2(2, 2, devices='cpu')\n"
        "s2 = distributed.slam_init_2d(cfg, mesh, initial_pose=pose)\n"
        "s2, (fb2, pose2, sig) = distributed.slam_step_2d(cfg, mesh)(s2, f)\n"
        "assert float(sig[0]) > 0 and fb2.shape == (24, 32, 4)\n"
        "assert len(run2d.union_leaves(s2.smap)[0]) == int(sig[0])\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None]\n"
        "assert not [m for m in loaded if m.split('.')[0] in"
        " ('jax', 'octree_slam_tpu')], loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_convert_round_trip(stream):
    depth, color, gt = stream
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    jstate, _ = jpipeline.step(jstate, jsources.Frame(
        jnp.asarray(depth[0]), jnp.asarray(color[0]), jnp.float32(0)), CFG)
    ref = _np_state(jstate)
    back = convert.state_to_numpy(
        convert.state_from_numpy(ref, TCFG, device=DEVICE))
    for group in ("pool", "leaves"):
        for name, arr in back[group].items():
            want = np.asarray(getattr(getattr(ref, group), name))
            assert arr.dtype == want.dtype, (group, name)
            np.testing.assert_array_equal(arr, want, err_msg=name)
    for name, arr in back["accel"].items():
        want = np.asarray(getattr(ref.accel, name))
        assert arr.dtype == want.dtype, name
        np.testing.assert_array_equal(arr, want, err_msg=name)
    np.testing.assert_array_equal(back["pose"], ref.pose)
    for lvl, want in zip(back["last_pyramid"], ref.last_pyramid):
        np.testing.assert_array_equal(lvl["vertex"], want.vertex)
    with pytest.raises(ValueError):
        convert.state_from_numpy(
            ref, dataclasses.replace(TCFG, node_capacity=1 << 15),
            device=DEVICE)


