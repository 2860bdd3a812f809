"""Port parity for streams of the whole step: the cone renderers' streams
(mixed renders, the heal path) against the JAX package frame by frame,
eager frames against lazy frames plus heal_for_march, state cloning, and a
JAX state with a current mirror carried into the port (the single steps
and the features are in tests/test_torch_pipeline.py).

Tolerances: poses within 1e-4; nodes, leaves and the three staleness flags
equal after every frame; at least 99% of framebuffer pixels within 1e-4;
the dense mirror (values, occ, dist) equal word for word after every eager
frame; a carried state's next frame within 1% of the reference's leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_mirror_equal, close_share, jax_frame,
                          orbit_frames, port_config, to_t)

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.render import raycast


CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10,
                 max_march_iters=48)


TCFG = port_config(CFG)


@pytest.fixture(scope="module")
def stream():
    return orbit_frames(CFG, 4)


def _np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


# each (config, render) pair costs one JAX compile of the whole step, so
# the streams share configs and stay short
STREAMS = {
    "cone": ({}, ["cone"] * 4),
    "cone_march": ({}, ["cone_march"] * 4),
    "heal": ({}, ["splat", "cone_march", "splat", "cone_march"]),
    "heal_after_cone_pointer_march":
        ({"use_dense_mips": False}, ["cone", "cone_march", "cone_march"]),
    "eager_every_frame": ({"lazy_interior": False},
                          ["cone", "cone_march", "cone"]),
    "paged_half_scale_march":
        ({"insert_unique_cap": 1 << 8, "cone_scale": 2},
         ["splat", "cone_march"]),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_cone_renders_stream_parity(stream, name):
    change, renders = STREAMS[name]
    depth, color, gt = stream
    cfg = dataclasses.replace(CFG, **change)
    tcfg = port_config(cfg)
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(gt[0]))
    tstate = pipeline.init_state(tcfg, initial_pose=to_t(gt[0]),
                                 device=DEVICE)
    assert isinstance(tstate.accel, mips.RenderCache if cfg.use_dense_mips
                      else raycast.AccelGrid)
    for i, render in enumerate(renders):
        jstate, jo = jpipeline.step(jstate, jax_frame(depth, color, i), cfg,
                                    render=render)
        tstate, to = pipeline.step(
            tstate, convert.frame_from_numpy(depth[i], color[i],
                                             device=DEVICE), tcfg,
            render=render)
        where = f"{name} frame {i} ({render})"
        np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                                   atol=1e-4, err_msg=where)
        assert int(to.map_nodes) == int(jo.map_nodes), where
        assert int(to.map_leaves) == int(jo.map_leaves), where
        for flag in ("interior_stale", "mirror_stale", "stamps_stale"):
            assert bool(getattr(tstate, flag)) == bool(getattr(jstate, flag)), \
                (where, flag)
        assert not bool(to.unique_overflow) and not bool(to.map_overflowed)
        fb = to.framebuffer
        assert fb.shape == (CFG.height, CFG.width, 4)
        assert bool(torch.isfinite(fb).all()), where
        assert close_share(fb, jo.framebuffer) >= 0.99, where
        if render != "none":
            assert float((fb[..., :3].sum(-1) > 0).float().mean()) > 0.3
        eager = render == "cone_march" or not cfg.lazy_interior
        if eager and cfg.use_dense_mips:
            # identical poses so far give identical leaves, and then the
            # mirrors agree word for word
            assert_mirror_equal(tstate.accel, jstate.accel, where)
        if render == "cone_march" and not cfg.use_dense_mips:
            np.testing.assert_array_equal(tstate.accel.entry.numpy(),
                                          np.asarray(jstate.accel.entry))
    assert int(to.map_leaves) > 500


def _run_port(cfg, stream, renders):
    depth, color, gt = stream
    state = pipeline.init_state(cfg, initial_pose=to_t(gt[0]), device=DEVICE)
    for i, render in enumerate(renders):
        state, _ = pipeline.step(
            state, convert.frame_from_numpy(depth[i], color[i],
                                            device=DEVICE), cfg,
            render=render)
    return state


def test_eager_frames_equal_lazy_frames_plus_heal(stream):
    """The reference's invariant (tests/test_lazy_interior.py): eager
    inserts followed by nothing leave the pool and the mirror that lazy
    inserts followed by heal_for_march leave; and the heal is idempotent.
    The poses do not depend on the interiors, so the leaves are the same."""
    lazy = _run_port(TCFG, stream, ["splat", "cone", "none"])
    eager = _run_port(dataclasses.replace(TCFG, lazy_interior=False),
                      stream, ["none"] * 3)
    assert bool(lazy.interior_stale) and bool(lazy.mirror_stale)
    assert not bool(eager.interior_stale) and not bool(eager.mirror_stale)
    assert not torch.equal(lazy.pool.value, eager.pool.value)
    # untouched by the lazy frames: the mirror is still empty
    assert int(lazy.accel.occ.sum()) == 0
    pool, cache = pipeline.heal_for_march(lazy, TCFG)
    assert torch.equal(pool.value, eager.pool.value)
    assert torch.equal(pool.child, eager.pool.child)
    for name in ("values", "occ"):
        assert torch.equal(getattr(cache, name),
                           getattr(eager.accel, name)), name
    # "none" frames update occ with with_dist=False: dist is the march's
    eager_dist = mips.refresh_dist(eager.accel, dist_level=4,
                                   max_skip=TCFG.dist_max_skip).dist
    assert torch.equal(cache.dist, eager_dist)
    before = pool.value.clone()
    pool2, cache2 = pipeline.heal_for_march(lazy._replace(pool=pool), TCFG)
    assert torch.equal(pool2.value, before)
    for name in ("values", "occ", "dist"):
        assert torch.equal(getattr(cache2, name), getattr(cache, name)), name


def test_clone_state_shares_nothing(stream):
    state = _run_port(TCFG, stream, ["cone_march"])
    twin = convert.clone_state(state)
    assert type(twin) is type(state)
    assert type(twin.accel) is type(state.accel)
    assert isinstance(twin.last_pyramid, tuple)
    flat = lambda s: [  # noqa: E731
        t for part in (s.pool, s.leaves, s.accel) for t in part] + [s.pose]
    for a, b in zip(flat(state), flat(twin)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    depth, color, _ = stream
    f = convert.frame_from_numpy(depth[1], color[1], device=DEVICE)
    kept = convert.clone_state(twin)
    pipeline.step(twin, f, TCFG, render="cone_march")    # writes in place
    assert not torch.equal(twin.pool.value, kept.pool.value)
    assert torch.equal(state.pool.value, kept.pool.value)
    assert torch.equal(state.accel.values, kept.accel.values)
    # the three renders of one map, each from its own copy
    outs = {r: pipeline.step(convert.clone_state(state), f, TCFG,
                             render=r)[1] for r in ("cone", "cone_march")}
    assert int(outs["cone"].map_leaves) == int(outs["cone_march"].map_leaves)


def test_state_with_mirror_carries_over(stream):
    """A JAX state with a current mirror continues in the port."""
    depth, color, gt = stream
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    for i in range(2):
        jstate, _ = jpipeline.step(jstate, jax_frame(depth, color, i), CFG,
                                   render="cone_march")
    tstate = convert.state_from_numpy(_np_state(jstate), TCFG, device=DEVICE)
    assert_mirror_equal(tstate.accel, jstate.accel, "carried")
    jstate, jo = jpipeline.step(jstate, jax_frame(depth, color, 2), CFG,
                                render="cone_march")
    tstate, to = pipeline.step(
        tstate, convert.frame_from_numpy(depth[2], color[2], device=DEVICE),
        TCFG, render="cone_march")
    assert close_share(to.framebuffer, jo.framebuffer) >= 0.99
    assert abs(int(to.map_leaves) - int(jo.map_leaves)) \
        <= 0.01 * int(jo.map_leaves)
    with pytest.raises(ValueError):
        convert.state_from_numpy(
            _np_state(jstate),
            dataclasses.replace(TCFG, use_dense_mips=False), device=DEVICE)
