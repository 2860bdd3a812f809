"""What the port's step refuses (check_supported: only what the
reference's step refuses), the synthetic sources
against the JAX package's, and that the port's entry points default to the
card (the step's parity is in tests/test_torch_pipeline.py).

Tolerances: the sources' depth equal, colours within one level."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, orbit_frames, port_config, to_t

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.sensor import sources as jsources
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.map import mips, svo
from octree_slam_tpu_torch.render import splat
from octree_slam_tpu_torch.sensor import sources


CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10,
                 max_march_iters=48)


TCFG = port_config(CFG)




@pytest.fixture(scope="module")
def stream():
    return orbit_frames(CFG, 4)


@pytest.mark.parametrize("change,render,error", [
    ({}, "cone_trace", ValueError),
    ({"use_dense_mips": False}, "cone_hybrid", ValueError),
])
def test_check_supported_rejects(stream, change, render, error):
    """What `step` refuses is what the reference refuses: an unknown
    render (it renders black there) and the hybrid without the dense
    mirror. The slab cone, which reads no mirror, runs without it."""
    cfg = dataclasses.replace(TCFG, **change)
    with pytest.raises(error):
        pipeline.check_supported(cfg, render)
    depth, color, gt = stream
    state = pipeline.init_state(cfg, initial_pose=to_t(gt[0]), device=DEVICE)
    with pytest.raises(error):
        pipeline.step(state, convert.frame_from_numpy(
            depth[0], color[0], device=DEVICE), cfg, render=render)
    if render == "cone_hybrid":
        pipeline.check_supported(cfg, "cone")


def test_sources_match_reference():
    pose_j = jsources.orbit_pose(0.25, radius=2.0)
    pose_t = sources.orbit_pose(0.25, radius=2.0, device=DEVICE)
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-6)
    jf = jsources.render_frame(jsources.default_scene(), pose_j, 55.0, 55.0,
                               width=64, height=48)
    tf = sources.render_frame(sources.default_scene(DEVICE), pose_t, 55.0,
                              55.0, width=64, height=48)
    dd = np.abs(tf.depth.numpy() - np.asarray(jf.depth).astype(np.int64))
    assert dd.max() <= 1 and (dd > 0).mean() <= 0.01
    dc = np.abs(tf.color.numpy().astype(int) - np.asarray(jf.color))
    assert dc.max() <= 1
    rs = sources.ReplaySource(np.asarray(jf.depth)[None],
                              np.asarray(jf.color)[None], device=DEVICE)
    f0 = rs.frame(0)
    assert len(rs) == 1 and f0.depth.dtype == torch.int32
    np.testing.assert_array_equal(f0.depth.numpy(), np.asarray(jf.depth))


def test_entry_points_default_to_the_card():
    """Called with no device, the entry points make their tensors on the
    card; on a machine without one they raise instead of running on the
    CPU."""
    calls = [lambda: pipeline.init_state(TCFG),
             lambda: svo.create(64, (0.0, 0.0, 0.0), 1.0),
             lambda: splat.create_leaf_list(8, 64),
             lambda: mips.create(max_depth=3, dist_level=1),
             lambda: sources.default_scene(),
             lambda: sources.orbit_pose(0.0),
             lambda: convert.frame_from_numpy(
                 np.zeros((4, 6), np.uint16), np.zeros((4, 6, 3), np.uint8)),
             lambda: sources.ReplaySource(
                 np.zeros((1, 4, 6), np.uint16),
                 np.zeros((1, 4, 6, 3), np.uint8)).frame(0)]
    if torch.cuda.is_available():
        assert pipeline.init_state(TCFG).pose.device.type == "cuda"
        for call in calls[1:]:
            call()
        return
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
