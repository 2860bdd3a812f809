"""Port parity for tracking-loss recovery (relocalize.py): the batched
pyramid of K rendered candidates against the JAX package's per-candidate
one, the packed score rows, recovery after a garbage frame through
run_slam on the same frames as the JAX package, and a run that stays lost
with relocalize=False.

Tolerances: vertex and normal maps within 1e-4 on at least 99% of pixels
(the bilateral's exp differs from XLA's in the last ulp, which can flip a
1 mm rounding tie); score rows take the same accept decisions and the
same winner, inlier counts within 0.5%, the winner's pose within 1e-4 and
the other accepted candidates' within 5e-4 (their solves stop short of
convergence); the run's poses, the relocalized pose included, within 1e-4
of the JAX package's, with the recoveries on the same frames."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, close_share, jax_frame, np_state,
                          orbit_frames, port_config)

from octree_slam_tpu import app as japp
from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu import relocalize as jreloc
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.render import splat as jsplat
from octree_slam_tpu_torch import app, convert, relocalize
from octree_slam_tpu.sensor import tracking as jtracking
from octree_slam_tpu_torch.sensor import tracking

CFG = SLAMConfig(width=80, height=60, focal_x=70.0, focal_y=70.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.04, max_depth=8,
                 node_capacity=1 << 17, leaf_capacity=1 << 15,
                 insert_unique_cap=1 << 13, max_march_iters=48,
                 keypose_every=2, reloc_candidates=4,
                 reloc_min_inlier_frac=0.05, precompile_ahead=False)
TCFG = port_config(CFG)
GARBAGE = 6


@pytest.fixture(scope="module")
def stream():
    """11 orbit frames; frame GARBAGE has zero depth and colour."""
    depth, color, gt = orbit_frames(CFG, 11, step_angle=0.02)
    depth[GARBAGE] = 0
    color[GARBAGE] = 0
    return depth, color, gt


@pytest.fixture(scope="module")
def mapped(stream):
    """The JAX state after the six good frames."""
    depth, color, gt = stream
    state = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    for i in range(GARBAGE):
        state, _ = jpipeline.step(state, jax_frame(depth, color, i), CFG,
                                  render="none")
    return np_state(state)


def _candidates(stream):
    gt = stream[2]
    # the true pose, two recent keyposes and one looking away from the map
    far = gt[0].copy()
    far[:3, :3] = far[:3, :3] @ np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    return np.stack([gt[5], gt[4], gt[3], far]).astype(np.float32)


def test_batched_pyramid_matches_per_candidate(mapped, stream):
    cands = _candidates(stream)
    lv = mapped.leaves
    live = (np.arange(lv.keys.shape[0]) < lv.count) & (lv.keys >= 0)
    bufs = np.stack([np.asarray(jsplat.splat_zbuffer(
        jnp.asarray(lv.vals), jnp.asarray(lv.keys), jnp.asarray(live),
        jnp.asarray(mapped.pool.center), jnp.asarray(mapped.pool.half_size),
        jnp.asarray(c), CFG.focal_x, CFG.focal_y, width=CFG.width,
        height=CFG.height, depth=CFG.max_depth, max_range=CFG.max_range))
        for c in cands])
    batch = relocalize.pyramid_from_zbuffer(torch.from_numpy(bufs), TCFG)
    for k in range(len(cands)):
        ref = jreloc.pyramid_from_zbuffer(jnp.asarray(bufs[k]), CFG)
        for lvl, (t, j) in enumerate(zip(batch, ref)):
            assert t.vertex.shape[1:] == np.asarray(j.vertex).shape
            for name in ("vertex", "normal"):
                share = close_share(getattr(t, name)[k].numpy(),
                                    np.asarray(getattr(j, name)))
                assert share >= 0.99, (k, lvl, name, share)
            # the last candidate looks away from the map and sees nothing
            hits = np.isfinite(np.asarray(j.vertex)).all(-1).mean()
            assert (hits > 0.2) if k < 3 else (hits == 0), (k, lvl, hits)


def test_score_rows_match_reference(mapped, stream):
    depth, color, gt = stream
    cands = _candidates(stream)
    live_j = jtracking.build_pyramid(jnp.asarray(depth[GARBAGE + 1]),
                                     jnp.asarray(color[GARBAGE + 1]), CFG)
    jrows = np.asarray(jreloc.score_candidates(
        jax_leaves(mapped), jnp.asarray(mapped.pool.center),
        jnp.asarray(mapped.pool.half_size), jnp.asarray(cands), live_j, CFG))
    tstate = convert.state_from_numpy(mapped, TCFG, device=DEVICE)
    frame = convert.frame_from_numpy(depth[GARBAGE + 1], color[GARBAGE + 1],
                                     device=DEVICE)
    live_t = tracking.build_pyramid(frame.depth, frame.color, TCFG)
    trows = relocalize.score_candidates(
        tstate.leaves, tstate.pool.center, tstate.pool.half_size,
        torch.from_numpy(cands), live_t, TCFG).numpy()
    assert trows.shape == jrows.shape == (4, 19)
    np.testing.assert_array_equal(trows[:, 18], jrows[:, 18])
    assert jrows[:3, 18].all() and not jrows[3, 18]
    ok = jrows[:, 18] > 0
    np.testing.assert_allclose(trows[ok, 16], jrows[ok, 16], rtol=0.005)
    # the winner is the relocalized pose
    best = int(np.argmax(np.where(ok, jrows[:, 16], -1)))
    assert int(np.argmax(np.where(ok, trows[:, 16], -1))) == best
    np.testing.assert_allclose(trows[best, :16], jrows[best, :16], atol=1e-4)
    # the losers' solves against the blocky model stop about 1 cm from
    # convergence, where the two libraries' summation orders move them by
    # up to 1.5e-4
    np.testing.assert_allclose(trows[ok, :16], jrows[ok, :16], atol=5e-4)


def jax_leaves(np_tree):
    import jax
    return jax.tree_util.tree_map(jnp.asarray, np_tree.leaves)


def _runs(stream, cfg, capsys):
    depth, color, gt = stream
    jres = japp.run_slam(lambda i: jax_frame(depth, color, i), len(gt), cfg,
                         initial_pose=gt[0], gt_fn=lambda i: gt[i],
                         render_every=0)
    jev = _events(capsys)
    frames = [convert.frame_from_numpy(depth[i], color[i], device=DEVICE)
              for i in range(len(gt))]
    tres = app.run_slam(lambda i: frames[i], len(gt), port_config(cfg),
                        initial_pose=gt[0], gt_fn=lambda i: gt[i],
                        render_every=0, device=DEVICE)
    return jres, jev, tres, _events(capsys)


def _events(capsys):
    out = []
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{") and "relocalize" in line:
            rec = json.loads(line)
            out.append((rec["frame"], rec["event"], rec["candidates_tried"],
                        rec["inliers"]))
    return out


def test_recovers_after_garbage_frame(stream, capsys):
    jres, jev, tres, tev = _runs(stream, CFG, capsys)
    gt = stream[2]
    assert tres.relocalizations == jres.relocalizations >= 1
    assert [e[:3] for e in tev] == [e[:3] for e in jev]
    for (_, _, _, a), (_, _, _, b) in zip(tev, jev):
        assert abs(a - b) <= 0.005 * max(b, 1)
    assert not tres.diverged and not jres.diverged
    err = np.linalg.norm(tres.poses[-1][:3, 3] - gt[-1][:3, 3])
    assert err < 0.05, err
    np.testing.assert_allclose(np.stack(tres.poses), np.stack(jres.poses),
                               atol=1e-4)


def test_without_relocalize_stays_lost(stream, capsys):
    cfg = dataclasses.replace(CFG, relocalize=False)
    jres, jev, tres, tev = _runs(stream, cfg, capsys)
    assert tres.relocalizations == jres.relocalizations == 0
    assert tres.diverged and jres.diverged
    assert tev == jev == []
    np.testing.assert_allclose(np.stack(tres.poses), np.stack(jres.poses),
                               atol=1e-4)


def test_depth_saturates_past_uint16_range():
    """At max_range = 100 m a depth word near 32,766 unpacks to ~100,000
    mm. The reference's float32 -> uint16 convert saturates at 65,535 (XLA
    on the CPU, jitted or not); the port must too, not keep the int32
    value and not wrap as a cast through torch.uint16 would. The words
    hold depths both below and above the uint16 range."""
    cfg = dataclasses.replace(CFG, max_range=100.0)
    tcfg = port_config(cfg)
    rng = np.random.default_rng(11)
    n = cfg.width * cfg.height
    # a smooth ramp across the image keeps normals defined: its left
    # third lies within the vertex map's 15 m, the rest beyond 65.5 m
    ramp = np.concatenate([
        np.linspace(700, 4500, cfg.width // 3),
        np.linspace(21500, 32766, cfg.width - cfg.width // 3)])
    q = np.tile(ramp.astype(np.int32), cfg.height)
    noisy = rng.random(n) < 0.3
    q[noisy] = rng.integers(21500, 32767, int(noisy.sum()))
    buf = (q << 16) | rng.integers(0, 1 << 16, n).astype(np.int32)
    buf[rng.random(n) < 0.05] = jsplat.EMPTY
    img = jsplat.dilate_zbuffer(jnp.asarray(buf), width=cfg.width,
                                height=cfg.height, rounds=3).reshape(-1)
    qz = jnp.where(img != jsplat.EMPTY, img >> 16, 0)
    # the reference's expression (octree_slam_tpu/relocalize.py:57-58)
    want = np.asarray((qz.astype(jnp.float32) * (cfg.max_range / 32766.0)
                       * 1e3).astype(jnp.uint16).reshape(cfg.height,
                                                         cfg.width))
    assert (want == 65535).mean() > 0.4 and (want < 15000).mean() > 0.2
    got = relocalize._depth_from_zbuffer(torch.from_numpy(buf), tcfg)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # the pyramids built on those words, within the module's tolerance
    tpyr = relocalize.pyramid_from_zbuffer(torch.from_numpy(buf), tcfg)
    jpyr = jreloc.pyramid_from_zbuffer(jnp.asarray(buf), cfg)
    for lvl, (t, j) in enumerate(zip(tpyr, jpyr)):
        jv = np.asarray(j.vertex)
        assert np.isfinite(jv).all(-1).mean() > 0.15, lvl
        for name in ("vertex", "normal"):
            share = close_share(getattr(t, name).numpy(),
                                np.asarray(getattr(j, name)))
            assert share >= 0.99, (lvl, name, share)
