"""Port parity for the 2-D mesh's step and app loop
(parallel/distributed.slam_step_2d, parallel/run2d.py) on the CPU: the
step against the JAX package's on make_mesh2(2, 2) (one compile of the
reference's step), and everything else against the port's own
single-device path (pipeline.step, pipeline.grow_state), which the other
test files hold against the JAX package: run_slam_2d through growth and
rebalancing, the three ways of grow_sharded, rebalancing a one-octant
scene, rebalance-before-grow, the keyframe anchor, the renders, the
row-sharded single-map step, relocalization, and checkpoints.

Tolerances: against the reference, poses within 1e-4 and unique counts
and leaves within 1% (world points cross a 3x3 product that rounds
differently in the two libraries); the port's own union of shards equals
a single pool fed the same points, keys and words bit for bit. On a mesh
with one "px" slab the poses, the map and the images equal the
single-device step's bit for bit; with two slabs the normal equations add
in another order, so poses agree within 1e-5 and the maps are held on the
reference estimator (no Huber weights), where a 1e-7 pose difference
cannot flip a blend. A checkpoint round trip is word for word."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, close_share, port_config, random_cloud,
                          to_t, write_field_file)

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.parallel import distributed as jdist
from octree_slam_tpu.sensor import sources as jsources
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.core.types import Frame
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.parallel import distributed, run2d
from octree_slam_tpu_torch.render import splat
from octree_slam_tpu_torch.sensor import sources, tracking

# the reference's TestRunSlam2D configuration
CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(2, 2),
                 voxel_resolution=0.05, max_depth=6,
                 node_capacity=1 << 15, leaf_capacity=1 << 10,
                 insert_unique_cap=1 << 11, map_split_level=2,
                 relocalize=False)
TCFG = port_config(CFG)


def _orbit(cfg, n, step=0.02):
    scene = sources.default_scene(DEVICE)
    gt = [sources.orbit_pose(i * step, device=DEVICE) for i in range(n)]
    return gt, [sources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                     width=cfg.width, height=cfg.height)
                for g in gt]


def _mesh(n_px, n_map):
    return distributed.make_mesh2(n_px, n_map, devices=DEVICE)


def _union(smap):
    return run2d.union_leaves(smap)


def _registry(leaves):
    k, v = leaves.keys.numpy(), leaves.vals.numpy().view(np.uint32)
    live = k >= 0
    o = np.argsort(k[live], kind="stable")
    return k[live][o], v[live][o]


def test_slam_step_2d_matches_reference():
    cfg = dataclasses.replace(CFG, node_capacity=1 << 14,
                              leaf_capacity=1 << 12, insert_unique_cap=1 << 12)
    tcfg = port_config(cfg)
    gt, frames = _orbit(tcfg, 3)
    jmesh = jdist.make_mesh2(2, 2)
    jstep = jdist.slam_step_2d(cfg, jmesh)
    jstate = jdist.slam_init_2d(cfg, jmesh, initial_pose=gt[0].numpy())
    mesh = _mesh(2, 2)
    step = distributed.slam_step_2d(tcfg, mesh)
    state = distributed.slam_init_2d(tcfg, mesh, initial_pose=gt[0])
    poses = []
    for i, f in enumerate(frames):
        depth = jnp.asarray(f.depth.numpy().astype(np.uint16))
        jf = jax.device_put(
            jsources.Frame(depth=depth, color=jnp.asarray(f.color.numpy()),
                           timestamp=jnp.float32(0.0)),
            jdist.frame_sharding(jmesh, "px"))
        jstate, (jfb, jpose, jsig) = jstep(jstate, jf)
        state, (fb, pose, sig) = step(state, f)
        poses.append(pose)
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-4,
                                   err_msg=f"frame {i}")
        s, js = sig.numpy(), np.asarray(jsig)
        assert abs(s[0] - js[0]) <= 0.01 * js[0], (i, s, js)      # uniques
        np.testing.assert_array_equal(s[3:6], js[3:6])            # flags
        # the finest level's mean |r| (summed numerators over summed
        # counts) and inlier count
        np.testing.assert_allclose(s[6], js[6], rtol=1e-3)
        assert abs(s[7] - js[7]) <= 0.005 * js[7], (i, s[7], js[7])
        np.testing.assert_allclose(s[8:], js[8:], atol=1e-4)      # camera
        assert close_share(fb, jfb) >= 0.99, i
    ku, _ = _union(state.smap)
    jk = np.asarray(jstate[3].leaves.keys)
    assert abs(ku.size - int((jk >= 0).sum())) <= 0.01 * ku.size
    # the reference's state carries over and steps on in the port
    carried = convert.state2d_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, mesh)
    np.testing.assert_array_equal(_union(carried.smap)[0],
                                  np.sort(jk[jk >= 0]))
    step(carried, frames[-1])

    # the port's own map: one pool fed the same world points (its poses)
    half = tcfg.voxel_resolution * 2 ** (tcfg.max_depth - 1)
    pool = svo.create(tcfg.node_capacity, (0.0, 0.0, 0.0), half, device=DEVICE)
    leaves = splat.create_leaf_list(tcfg.leaf_capacity, tcfg.node_capacity,
                                    device=DEVICE)
    for f, pose in zip(frames, poses):
        v = tracking.build_pyramid(f.depth, f.color, tcfg)[0].vertex
        wp = v.reshape(-1, 3) @ pose[:3, :3].T + pose[:3, 3]
        pool, st = svo.insert(pool, wp, pipeline._fuse_colors(f, tcfg),
                              depth=tcfg.max_depth,
                              unique_cap=tcfg.insert_unique_cap)
        leaves = splat.append_new_leaves(leaves, st)
    for a, b in zip(_union(state.smap), _registry(leaves)):
        np.testing.assert_array_equal(a, b)


def _single_chip(cfg, frames, gt, render="none", headroom=0.75):
    """pipeline.step over the frames with run_slam_2d's growth policy
    (the reference test's protocol)."""
    s = pipeline.init_state(cfg, initial_pose=gt[0], device=DEVICE)
    poses, fb = [], None
    for f in frames:
        s, out = pipeline.step(s, f, cfg, render=render)
        poses.append(out.pose)
        fb = out.framebuffer
        if (int(out.map_nodes) > headroom * cfg.node_capacity
                or bool(out.map_overflowed)
                or int(out.map_leaves) > headroom * cfg.leaf_capacity):
            s, cfg = pipeline.grow_state(s, cfg, grow_nodes=True,
                                         grow_leaves=True)
    return s, cfg, torch.stack(poses).numpy(), fb


def test_run_slam_2d_through_growth_equals_single_chip():
    gt, frames = _orbit(TCFG, 20)
    state, cfg2, info = run2d.run_slam_2d(
        frames, TCFG, _mesh(2, 4), initial_pose=gt[0], grow_headroom=0.75,
        rebalance_factor=1.1)
    events = [e["event"] for e in info["events"]]
    assert "grow" in events and "rebalance" in events, events
    assert cfg2.leaf_capacity > TCFG.leaf_capacity
    assert not any(bool(p.overflowed) for p in state.smap.pools)
    assert not any(bool(lv.overflowed) for lv in state.smap.leaves)
    s, _, poses, _ = _single_chip(TCFG, frames, gt)
    assert not bool(s.pool.overflowed) and not bool(s.leaves.overflowed)
    for a, b in zip(_union(state.smap), _registry(s.leaves)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(info["poses"], poses, atol=1e-5)
    assert np.linalg.norm(info["poses"][-1][:3, 3]
                          - gt[-1][:3, 3].numpy()) < 0.08


def _cloud_map(cfg, n, seed, lo=-0.6, hi=0.6, smap=None, mesh=None):
    mesh = mesh or distributed.make_mesh(8, axis_name="map", devices=DEVICE)
    pts, cols = random_cloud(n, seed, lo=lo, hi=hi)
    smap = smap or distributed.make_sharded_map(cfg, mesh)
    smap, total = distributed.insert_sharded(smap, to_t(pts), to_t(cols),
                                             cfg, mesh)
    return smap, mesh, int(total)


GROW_CFG = port_config(SLAMConfig(width=64, height=48, max_depth=6,
                                  voxel_resolution=2 * 0.64 / (1 << 6),
                                  node_capacity=1 << 16, leaf_capacity=1 << 11,
                                  insert_unique_cap=1 << 12))


@pytest.mark.parametrize("case", ["pad", "boundary", "overflowed_registry"])
def test_grow_sharded(case):
    """Padding within a prealloc schedule equals a fresh map at the final
    capacity fed the same clouds; a doubling across a prealloc boundary
    keeps every leaf word and the image and takes inserts; an overflowed
    registry is rebuilt from the pools, so no leaf is lost."""
    if case == "pad":
        cfg = GROW_CFG
        assert svo.prealloc_levels(1 << 16) == svo.prealloc_levels(1 << 17)
        smap, mesh, _ = _cloud_map(cfg, 2000, 1)
        smap, cfg2 = distributed.grow_sharded(smap, cfg, mesh,
                                              grow_nodes=True,
                                              grow_leaves=True)
        assert cfg2.node_capacity == 1 << 17 and cfg2.leaf_capacity == 1 << 12
        assert all(p.capacity == 1 << 17 for p in smap.pools)
        smap, _, _ = _cloud_map(cfg2, 2000, 2, smap=smap, mesh=mesh)
        big = dataclasses.replace(cfg, node_capacity=1 << 17,
                                  leaf_capacity=1 << 12)
        ref, _, _ = _cloud_map(big, 2000, 1, mesh=mesh)
        ref, _, _ = _cloud_map(big, 2000, 2, smap=ref, mesh=mesh)
        for a, b in zip(_union(smap), _union(ref)):
            np.testing.assert_array_equal(a, b)
    elif case == "boundary":
        cfg = dataclasses.replace(GROW_CFG, node_capacity=8192,
                                  leaf_capacity=1 << 10,
                                  insert_unique_cap=256)   # paged rebuild
        assert svo.prealloc_levels(8192) != svo.prealloc_levels(16384)
        smap, mesh, _ = _cloud_map(cfg, 1500, 3)
        before = _union(smap)
        eye = torch.eye(4)
        eye[2, 3] = 2.0
        fb0 = distributed.render_sharded_map(smap, eye, cfg.focal_x,
                                             cfg.focal_y, cfg, mesh)
        smap, cfg2 = distributed.grow_sharded(smap, cfg, mesh,
                                              grow_nodes=True)
        assert cfg2.node_capacity == 16384
        for a, b in zip(before, _union(smap)):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(fb0, distributed.render_sharded_map(
            smap, eye, cfg2.focal_x, cfg2.focal_y, cfg2, mesh))
        smap, _, total = _cloud_map(cfg2, 800, 4, smap=smap, mesh=mesh)
        assert total > 0
        assert not any(bool(p.overflowed) for p in smap.pools)
    else:
        cfg = dataclasses.replace(GROW_CFG, node_capacity=1 << 14,
                                  leaf_capacity=64, insert_unique_cap=1 << 10)
        smap, mesh, total = _cloud_map(cfg, 3000, 9)
        assert any(bool(lv.overflowed) for lv in smap.leaves)
        smap, cfg2 = distributed.grow_sharded(smap, cfg, mesh,
                                              grow_nodes=False,
                                              grow_leaves=True)
        assert not any(bool(lv.overflowed) for lv in smap.leaves)
        keys, _ = _union(smap)
        assert keys.size == total
        snap_k, _ = distributed.union_leaf_snapshot(smap, cfg2)
        np.testing.assert_array_equal(np.sort(snap_k), keys)


def test_rebalance_one_octant_scene():
    """All leaves in one shard's range: rebalancing spreads them within 2x
    of the mean, keeps the union word for word, each shard holds only its
    new range, and inserts continue to equal one pool's."""
    cfg = dataclasses.replace(GROW_CFG, node_capacity=1 << 16,
                              leaf_capacity=1 << 12, map_split_level=2)
    smap, mesh, total = _cloud_map(cfg, 3000, 11, lo=-0.6, hi=-0.01)
    counts = distributed.shard_leaf_counts(smap)
    assert total > 500 and counts.max() == counts.sum()
    before = _union(smap)
    smap2 = distributed.rebalance_sharded(smap, cfg, mesh)
    counts2 = distributed.shard_leaf_counts(smap2)
    assert counts2.sum() == counts.sum()
    assert counts2.max() <= 2.0 * counts2.mean(), counts2
    assert np.all(np.diff(smap2.bounds) >= 1)
    for a, b in zip(before, _union(smap2)):
        np.testing.assert_array_equal(a, b)
    shift = 3 * (cfg.max_depth - cfg.map_split_level)
    for d, lv in enumerate(smap2.leaves):
        k = lv.keys.numpy()
        pref = k[k >= 0] >> shift
        assert np.all((pref >= smap2.bounds[d]) & (pref < smap2.bounds[d + 1]))


def test_rebalance_averts_growth():
    """A hot shard crossing the leaf headroom first re-cuts the ranges; the
    balanced loads fit, so the growth is averted and logged."""
    scene = sources.SyntheticScene(
        spheres=torch.tensor([[-0.45, -0.40, -0.45, 0.30]]),
        sphere_albedo=torch.tensor([[0.9, 0.3, 0.2]]),
        boxes=torch.tensor([[-1.0, -0.9, -1.0, -0.15, -0.70, -0.15]]),
        box_albedo=torch.tensor([[0.3, 0.8, 0.3]]),
        planes=torch.zeros((0, 4)), plane_albedo=torch.zeros((0, 3)))
    gt = [sources.orbit_pose(0.9 + i * 0.015, device=DEVICE)
          for i in range(6)]
    frames = [sources.render_frame(scene, g, TCFG.focal_x, TCFG.focal_y,
                                   width=TCFG.width, height=TCFG.height)
              for g in gt]
    state, _, info = run2d.run_slam_2d(
        frames, TCFG, _mesh(2, 4), initial_pose=gt[0], grow_headroom=0.3,
        rebalance_factor=1.1, rebalance_check_every=10**9)
    events = info["events"]
    averted = [e for e in events if e["event"] == "grow_averted"]
    assert averted and averted[0]["leaves"], events
    grows = [e for e in events if e["event"] == "grow"]
    if grows:
        assert averted[0]["frame"] < grows[0]["frame"], events
    pre = [e for e in events if e["event"] == "rebalance"
           and e["reason"] == "pre-grow"]
    assert pre and pre[0]["frame"] == averted[0]["frame"], events
    assert max(pre[0]["counts_after"]) <= 0.3 * TCFG.leaf_capacity
    assert max(pre[0]["counts_before"]) > 0.3 * TCFG.leaf_capacity
    assert not any(bool(lv.overflowed) for lv in state.smap.leaves)


def test_keyframe_matches_single_chip():
    """Keyframe-anchored tracking on the mesh is pipeline.step's branch:
    the union equals a single-device keyframe run bit for bit (on the
    reference estimator) and the poses agree within 1e-5."""
    cfg = dataclasses.replace(
        TCFG, node_capacity=1 << 16, leaf_capacity=1 << 13,
        track_keyframe=True, keyframe_max_dist=0.05,
        keyframe_max_angle_deg=3.0, icp_symmetric=False, icp_huber_k=0.0)
    gt, frames = _orbit(cfg, 10)
    state, _, info = run2d.run_slam_2d(frames, cfg, _mesh(2, 4),
                                       initial_pose=gt[0])
    s, _, poses, _ = _single_chip(cfg, frames, gt)
    for a, b in zip(_union(state.smap), _registry(s.leaves)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(info["poses"], poses, atol=1e-5)


@pytest.mark.parametrize("n_px,n_map", [(1, 8), (2, 4)])
def test_renders_match_single_chip(n_px, n_map):
    """run_slam_2d's splat, cone and hybrid frames against pipeline.step's
    on the same stream: with one slab poses and images bit for bit, with
    two poses within 1e-5 and images within 1e-4 on 99% of pixels."""
    cfg = dataclasses.replace(TCFG, node_capacity=1 << 16,
                              leaf_capacity=1 << 13, pyramid_depth=3,
                              pyramid_iters=(2, 2, 2))
    gt, frames = _orbit(cfg, 4)
    for render in ("splat", "cone", "cone_hybrid"):
        step = distributed.slam_step_2d(cfg, _mesh(n_px, n_map),
                                        render=render)
        state = distributed.slam_init_2d(cfg, _mesh(n_px, n_map),
                                         initial_pose=gt[0])
        poses = []
        for f in frames:
            state, (fb, pose, _) = step(state, f)
            poses.append(pose)
        _, _, ref_poses, ref_fb = _single_chip(cfg, frames, gt, render)
        got = torch.stack(poses).numpy()
        if n_px == 1:
            np.testing.assert_array_equal(got, ref_poses, err_msg=render)
            assert torch.equal(fb, ref_fb), render
        else:
            np.testing.assert_allclose(got, ref_poses, atol=1e-5,
                                       err_msg=render)
            assert close_share(fb, ref_fb) >= 0.99, render
        assert float(fb[..., :3].max()) > 0.1


def test_sharded_step_equals_pipeline_step():
    """sharded_step (the frame row-sharded over 4 slabs, one replicated
    map) against pipeline.step: poses within 1e-5, the same map."""
    cfg = dataclasses.replace(TCFG, node_capacity=1 << 16,
                              leaf_capacity=1 << 13)
    gt, frames = _orbit(cfg, 4)
    mesh = distributed.make_mesh(4, devices=DEVICE)
    fn = distributed.sharded_step(cfg, mesh)
    a = pipeline.init_state(cfg, initial_pose=gt[0], device=DEVICE)
    b = pipeline.init_state(cfg, initial_pose=gt[0], device=DEVICE)
    for f in frames:
        a, oa = fn(a, f)
        b, ob = pipeline.step(b, f, cfg)
        np.testing.assert_allclose(oa.pose.numpy(), ob.pose.numpy(),
                                   atol=1e-5)
    assert abs(int(oa.map_leaves) - int(ob.map_leaves)) <= \
        0.01 * int(ob.map_leaves)


RECOVERY_CFG = port_config(SLAMConfig(
    width=64, height=48, focal_x=55.0, focal_y=55.0, pyramid_depth=2,
    pyramid_iters=(3, 3), voxel_resolution=0.05, max_depth=6,
    node_capacity=1 << 16, leaf_capacity=1 << 12, insert_unique_cap=1 << 11,
    map_split_level=2, relocalize=True, keypose_every=2, reloc_candidates=2,
    reloc_min_inlier_frac=0.02))


def test_relocalize_2d_recovers():
    """A frame of zero depth diverges the solve, the latched flag gates
    fusion, and relocalize_2d re-anchors against splats of the sharded
    map: the flag is clear at the end and the pose back near the truth."""
    cfg = RECOVERY_CFG
    gt, frames = _orbit(cfg, 8, step=0.015)
    f = frames[0]
    bad = Frame(depth=torch.zeros_like(f.depth),
                color=torch.zeros_like(f.color), timestamp=f.timestamp)
    stream = frames[:4] + [bad] + frames[4:]
    state, _, info = run2d.run_slam_2d(stream, cfg, _mesh(2, 4),
                                       initial_pose=gt[0])
    evs = [e["event"] for e in info["events"]]
    assert "relocalize" in evs, evs
    assert not bool(state.diverged)
    err = np.linalg.norm(info["poses"][-1][:3, 3] - gt[-1][:3, 3].numpy())
    assert err < 0.15, err


@pytest.mark.parametrize("fmt", ["reference", "field"])
def test_save_load_round_trip(tmp_path, fmt):
    """save_sharded -> load_sharded word for word (the reference package's
    file, which save_sharded writes, and the port's earlier field:<name>
    file), the next frame equal from both; a wrong shard count and a wrong
    capacity raise, naming them."""
    cfg = RECOVERY_CFG
    gt, frames = _orbit(cfg, 5, step=0.015)
    mesh = _mesh(2, 4)
    state, cfg2, _ = run2d.run_slam_2d(frames[:4], cfg, mesh,
                                       initial_pose=gt[0])
    p = str(tmp_path / "smap.npz")
    if fmt == "reference":
        run2d.save_sharded(p, state, cfg2)
    else:
        write_field_file(p, convert.state2d_to_numpy(state), dict(
            node_capacity=cfg2.node_capacity,
            leaf_capacity=cfg2.leaf_capacity,
            prealloc=svo.prealloc_levels(cfg2.node_capacity),
            n_shards=len(state.smap.pools),
            track_keyframe=int(cfg2.track_keyframe),
            **{k: getattr(cfg2, k) for k, _ in run2d._STAMPS}))
    state2, cfg3 = run2d.load_sharded(p, cfg, mesh)
    assert cfg3 == cfg2
    a, b = convert.state2d_to_numpy(state), convert.state2d_to_numpy(state2)
    from octree_slam_tpu_torch.app import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    step = distributed.slam_step_2d(cfg2, mesh)
    sa, _ = step(convert.clone_state(state), frames[4])
    sb, _ = step(state2, frames[4])
    for x, y in zip(_union(sa.smap), _union(sb.smap)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="4 map shards but the mesh has 2"):
        run2d.load_sharded(p, cfg, _mesh(1, 2))
    z = dict(np.load(p))
    z["node_capacity"] = np.asarray(cfg2.node_capacity * 16)
    np.savez(str(tmp_path / "bad.npz"), **z)
    with pytest.raises(ValueError, match="dense-preallocated|pool.child"):
        run2d.load_sharded(str(tmp_path / "bad.npz"), cfg, mesh)
