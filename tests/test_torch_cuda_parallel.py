"""The multi-device path on the card against itself and the CPU: the
row-sharded pyramid's kernel launches, one per slab, against the launch on
the whole frame; the Morton-sharded insert on the card against the same
insert on the CPU; and the native PNG decoder against the pure one where
the native runtime builds. Then run_slam_2d, the app loop on the 2-D
("px", "map") mesh, on the benchmark orbit (tests/torch_orbit.py) with
every shard on the card: the map axis alone (1 x 8) against the
single-device orbit bit for bit; two row slabs (2 x 4) for the splat, the
slab cone and the hybrid, against the orbit within 1e-5 and against the
single-device renderer on the same leaves; a run that grows and
rebalances against one pool fed its poses; the sharded tiering and
checkpoint round trips; a recovery from a blanked frame.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_parallel.py --noconftest -q

Tolerances: bit for bit (pyramid levels and maps, pool and registry words,
pixels). On the 2 x 4 mesh the slab sums of the normal equations add in
another order: poses within 1e-5 of the orbit's and the ATE within 1e-5 m
of its pin; the slab cone's image within 2e-7, the hybrid's within 1e-5 on
all but 0.5% of pixels at more than 40 dB (tests/test_run2d.py's
bounds)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import torch_orbit as orb
from octree_slam_tpu_torch import SLAMConfig, convert, pipeline
from octree_slam_tpu_torch.app import _flatten
from octree_slam_tpu_torch.io import native, png
from octree_slam_tpu_torch.map import mips, svo, tiering
from octree_slam_tpu_torch.parallel import distributed, run2d, tiering2d
from octree_slam_tpu_torch.render import conesplat, hybrid, splat
from octree_slam_tpu_torch.sensor import cuda_ops, sources, tracking

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_px", [2, 4])
def test_slab_pyramid_launches_equal_whole_frame(device, n_px):
    cfg = SLAMConfig(width=640, height=480)
    scene = sources.default_scene(device)
    f = sources.render_frame(scene, sources.orbit_pose(0.2, device=device),
                             cfg.focal_x, cfg.focal_y, width=640, height=480)
    gen = torch.Generator(device="cuda").manual_seed(n_px)
    noise = torch.randint(-60, 60, f.depth.shape, generator=gen,
                          device=device, dtype=torch.int32)
    f = f._replace(depth=torch.clamp(f.depth + noise, min=0).contiguous())
    mesh = distributed.make_mesh2(n_px, 2, devices=device)
    sensor = distributed.row_sharded_sensor(cfg, mesh)
    cuda_ops.reset_launches()
    whole, _ = sensor(f)
    launches = dict(cuda_ops.LAUNCHES)
    ref = tracking.build_pyramid(f.depth, f.color, cfg)
    assert launches == {"bilateral7x7": n_px, "bilateral_window": 0,
                        "gated_pyramid5x5": n_px}
    for lvl, (a, b) in enumerate(zip(whole, ref)):
        for name in a._fields:
            np.testing.assert_array_equal(getattr(a, name).cpu().numpy(),
                                          getattr(b, name).cpu().numpy(),
                                          err_msg=f"L{lvl} {name}")


def test_sharded_insert_card_equals_cpu(device):
    cfg = SLAMConfig(width=64, height=48, max_depth=8, voxel_resolution=0.01,
                     node_capacity=1 << 18, leaf_capacity=1 << 16,
                     insert_unique_cap=1 << 12, map_split_level=2)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.0, 1.0, (60000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (60000, 3)).astype(np.float32)
    out = {}
    for dev in (device, torch.device("cpu")):
        mesh = distributed.make_mesh(8, axis_name="map", devices=dev)
        smap = distributed.make_sharded_map(cfg, mesh)
        for _ in range(2):
            smap, total = distributed.insert_sharded(
                smap, torch.from_numpy(pts).to(dev),
                torch.from_numpy(cols).to(dev), cfg, mesh)
        out[dev.type] = (smap, int(total))
    (a, ta), (b, tb) = out["cuda"], out["cpu"]
    assert ta == tb > 8 * cfg.insert_unique_cap   # the shards paged
    for pa, pb in zip(a.pools, b.pools):
        assert torch.equal(pa.child.cpu(), pb.child)
        assert torch.equal(pa.value.cpu(), pb.value)
    for x, y in zip(run2d.union_leaves(a), run2d.union_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_native_read_png_equals_pure(tmp_path):
    if not native.available():
        # the reference's own rule (tests/test_native.py): a machine
        # without libpng takes the pure decoder, and there is nothing to
        # compare
        pytest.skip(f"the native runtime does not build: "
                    f"{native.BUILD_ERROR}")
    rng = np.random.default_rng(5)
    depth = rng.integers(0, 65535, (480, 640), dtype=np.uint16)
    rgb = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    for img, name in ((depth, "d.png"), (rgb, "c.png")):
        p = str(tmp_path / name)
        png.write_png(p, img)
        got = native.read_png(p)
        np.testing.assert_array_equal(got, png.read_png(p))
        np.testing.assert_array_equal(got, img)


# ---------------------------------------------------------------- full size

POSE_TOL, ATE_TOL_M = 1e-5, 1e-5
# the stamps of the reference package's sharded checkpoint beside `n` and
# the arrays a0 .. a{n-1} (its run2d.save_sharded)
REFERENCE_SHARDED_STAMPS = ("node_capacity", "leaf_capacity", "prealloc",
                            "width", "height", "pyramid_depth",
                            "track_finest_level", "fuse_level", "max_depth",
                            "map_split_level", "insert_unique_cap",
                            "voxel_resolution", "n_shards")


@pytest.fixture(scope="module")
def orbit():
    """The orbit and the single-device run of it through
    pipeline.step("splat"), held to its pins: (cfg, frames, gts, that
    run's final state, its poses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark orbit on the card")
    cfg = orb.bench_config()
    frames, gts = orb.orbit(cfg)
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    poses = []
    for f in frames:
        state, out = pipeline.step(state, f, cfg)
        poses.append(out.pose)
    poses = torch.stack(poses).cpu().numpy()
    assert abs(orb.orbit_ate(list(poses), gts) - orb.ORBIT_ATE_M) \
        <= orb.ORBIT_ATE_TOL_M
    assert int(out.map_nodes) == orb.ORBIT_MAP_NODES
    assert int(state.leaves.count) == orb.ORBIT_MAP_LEAVES
    return cfg, frames, gts, state, poses


def _union_leaf_list(smap):
    """The union of the shards' registries as one single-device LeafList
    (node indices are the shards' own and unused by the renderers)."""
    keys = torch.cat([lv.keys for lv in smap.leaves])
    return splat.LeafList(
        keys=keys, nodes=torch.cat([lv.nodes for lv in smap.leaves]),
        vals=torch.cat([lv.vals for lv in smap.leaves]),
        node2pos=keys.new_zeros((1,)),
        count=torch.tensor(keys.shape[0], dtype=torch.int32,
                           device=keys.device),
        overflowed=torch.zeros((), dtype=torch.bool, device=keys.device))


def _union_pool(smap, cfg):
    """One pool holding exactly the union's leaf words, interiors
    refreshed: the single-device map of the same leaves."""
    keys, vals = run2d.union_leaves(smap)
    p0 = smap.pools[0]
    pool = svo.create(cfg.node_capacity * len(smap.pools), p0.center,
                      p0.half_size, device="cuda")
    pool, _ = tiering.bulk_insert_exact(
        pool, keys, vals, depth=cfg.max_depth,
        unique_cap=cfg.insert_unique_cap,
        shallow_level=pipeline._accel_level(cfg), overwrite=True)
    return svo.refresh_interior(pool, depth=cfg.max_depth)


def test_map_axis_alone_equals_the_orbit(orbit):
    cfg, frames, gts, ref, ref_poses = orbit
    mesh = distributed.make_mesh2(1, 8)
    state, _, info, launches = orb.run_2d(cfg, mesh, frames, gts)
    np.testing.assert_array_equal(info["poses"], ref_poses)
    k, v = run2d.union_leaves(state.smap)
    rk, rv = (x.numpy() for x in orb.sorted_registry(ref))
    np.testing.assert_array_equal(k, rk)
    np.testing.assert_array_equal(v, rv.view(np.uint32))
    pose = torch.from_numpy(info["poses"][-1]).cuda()
    zb = distributed.model_zbuffer_sharded(state.smap, pose, cfg, mesh)
    live = (torch.arange(ref.leaves.keys.shape[0], device="cuda")
            < ref.leaves.count) & (ref.leaves.keys >= 0)
    assert torch.equal(zb, splat.splat_zbuffer(
        ref.leaves.vals, ref.leaves.keys, live, ref.pool.center,
        ref.pool.half_size, pose, cfg.focal_x, cfg.focal_y, width=cfg.width,
        height=cfg.height, depth=cfg.max_depth, max_range=cfg.max_range))
    for name in orb.KERNELS:
        assert launches[name] == orb.ORBIT_FRAMES, name


def test_row_slab_pyramids_equal_the_whole_frames(orbit):
    cfg, frames = orbit[:2]
    sensor = distributed.row_sharded_sensor(cfg,
                                            distributed.make_mesh2(2, 4))
    for f in frames:
        whole, _ = sensor(f)
        for a, b in zip(whole, tracking.build_pyramid(f.depth, f.color,
                                                      cfg)):
            for x, y in zip(a, b):
                assert torch.equal(x, y)


@pytest.mark.parametrize("render", ["splat", "cone", "cone_hybrid"])
def test_row_slabs_track_and_render_the_orbit(orbit, render):
    """The 2 x 4 mesh's run: poses and ATE against the orbit, two launches
    of each kernel a frame, and its render of its map against the
    single-device renderer on the same leaves: the splat's packed z-buffer
    and image bit for bit, the slab cone's slab words bit for bit (min per
    shard then across shards is the global scatter-min), the hybrid's
    union mirror word for word against one rebuilt from a pool of the same
    leaves."""
    cfg, frames, gts, _, ref_poses = orbit
    if render == "cone_hybrid":
        cfg = dataclasses.replace(cfg, **orb.HYBRID_BAND)
    mesh = distributed.make_mesh2(2, 4)
    state, _, info, launches = orb.run_2d(cfg, mesh, frames, gts, render)
    assert float(np.abs(info["poses"] - ref_poses).max()) <= POSE_TOL
    assert abs(orb.orbit_ate(list(info["poses"]), gts) - orb.ORBIT_ATE_M) \
        <= ATE_TOL_M
    for name in orb.KERNELS:
        assert launches[name] == 2 * orb.ORBIT_FRAMES, name
    smap = state.smap
    pose = torch.from_numpy(info["poses"][-1]).cuda()
    fx, fy, spec = cfg.focal_x, cfg.focal_y, pipeline._slab_spec(cfg)
    leaves = _union_leaf_list(smap)
    p0 = smap.pools[0]
    fb = {"splat": distributed.render_sharded_map,
          "cone": distributed.render_sharded_cone,
          "cone_hybrid": distributed.render_sharded_hybrid}[render](
        smap, pose, fx, fy, cfg, mesh)
    if render == "splat":
        words = distributed.model_zbuffer_sharded(smap, pose, cfg, mesh)
        one = splat.splat_zbuffer(
            leaves.vals, leaves.keys, leaves.keys >= 0, p0.center,
            p0.half_size, pose, fx, fy, width=cfg.width, height=cfg.height,
            depth=cfg.max_depth, max_range=cfg.max_range)
        assert torch.equal(words, one)
        assert torch.equal(fb, splat.finish_zbuffer(one, width=cfg.width,
                                                    height=cfg.height))
    elif render == "cone":
        words = distributed.slab_words_sharded(smap, pose, fx, fy, cfg, spec)
        assert torch.equal(words, conesplat.slab_scatter_min(
            leaves.vals, leaves.keys, leaves.keys >= 0, p0.center,
            p0.half_size, pose, fx, fy, spec=spec, depth=cfg.max_depth))
        ref = conesplat.render_cone_splat(leaves, p0.center, p0.half_size,
                                          pose, fx, fy, spec=spec,
                                          depth=cfg.max_depth)
        assert float((fb - ref).abs().max()) <= 2e-7
    else:
        lvl = pipeline._accel_level(cfg)
        cache, _ = distributed.union_leaf_mirror(smap, cfg)
        one = mips.rebuild_from_pool(_union_pool(smap, cfg),
                                     max_depth=cfg.max_depth, dist_level=lvl,
                                     max_skip=cfg.dist_max_skip)
        one = mips.encode_free_dist(one, max_depth=cfg.max_depth,
                                    dist_level=lvl)
        lo = mips.level_offset(cfg.max_depth)
        assert torch.equal(cache.values[lo:], one.values[lo:])
        assert torch.equal(cache.occ, one.occ)
        assert torch.equal(cache.dist, one.dist)
        ref = hybrid.render_cone_hybrid(
            leaves, one, p0.center, p0.half_size, pose, fx, fy, spec=spec,
            depth=cfg.max_depth, dist_level=lvl, max_range=cfg.max_range,
            start_dist=cfg.start_dist, band_cap=cfg.cone_band_cap,
            band_iters=cfg.cone_band_iters, crawl=cfg.cone_band_crawl,
            fused_dist=cfg.cone_band_fused_dist,
            depth_prio=cfg.cone_band_depth_prio,
            compact_after=cfg.cone_band_compact_after)
        d = (fb[..., :3] - ref[..., :3]).abs()
        assert float((d.max(-1).values > 1e-5).float().mean()) < 0.005
        mse = float((d ** 2).mean())
        assert 10.0 * math.log10(1.0 / max(mse, 1e-12)) > 40.0


def test_row_slabs_grow_and_rebalance_like_one_pool(orbit):
    """Registries of 4,096 rows overflow on the first frame and grow; the
    pools have room for any shard's share. The union of the shards'
    leaves equals one pool fed the run's own poses."""
    cfg, frames, gts = orbit[:3]
    gcfg = dataclasses.replace(cfg, map_split_level=2,
                               node_capacity=1 << 19, leaf_capacity=1 << 12)
    state, _, info, _ = orb.run_2d(gcfg, distributed.make_mesh2(2, 4),
                                   frames, gts, rebalance_factor=1.1)
    events = [e["event"] for e in info["events"]]
    assert "grow" in events and "rebalance" in events
    smap = state.smap
    assert not any(bool(p.overflowed) for p in smap.pools)
    assert not any(bool(lv.overflowed) for lv in smap.leaves)
    one = svo.create(cfg.node_capacity, smap.pools[0].center,
                     smap.pools[0].half_size, device="cuda")
    reg = splat.create_leaf_list(cfg.leaf_capacity, cfg.node_capacity,
                                 device="cuda")
    for f, p in zip(frames, info["poses"]):
        p = torch.from_numpy(p).cuda()
        v = tracking.build_pyramid(f.depth, f.color, cfg)[0].vertex
        wp = v.reshape(-1, 3) @ p[:3, :3].T + p[:3, 3]
        lk = None
        while True:
            one, st = svo.insert(one, wp, pipeline._fuse_colors(f, cfg),
                                 depth=cfg.max_depth,
                                 unique_cap=cfg.insert_unique_cap, min_key=lk)
            reg = splat.append_new_leaves(reg, st)
            if not bool(st.unique_overflow):
                break
            lk = st.last_key
    k1, v1 = distributed.registry_rows(reg)
    o = np.argsort(k1, kind="stable")
    k2, v2 = run2d.union_leaves(smap)
    np.testing.assert_array_equal(k1[o], k2)
    np.testing.assert_array_equal(v1[o], v2)


def test_row_slabs_tier_and_checkpoint_the_orbit(orbit, tmp_path):
    """The 2 x 4 splat run's map: every leaf spilled (camera far) and
    restored; then save_sharded writes the reference package's file (n,
    a0 .. a{n-1}, its 13 stamps), load_sharded brings back every word
    with every shard on its device, and one more frame from the loaded
    state and from a copy of the original alike."""
    cfg, frames, gts = orbit[:3]
    mesh = distributed.make_mesh2(2, 4)
    state = orb.run_2d(cfg, mesh, frames, gts)[0]
    smap = state.smap
    k0, v0 = run2d.union_leaves(smap)
    tcfg = dataclasses.replace(cfg, restore_radius=1e6)
    archive = tiering.HostArchive(tcfg.tier_level)
    cam = gts[-1][:3, 3].cpu().numpy()
    smap, n_spill = tiering2d.spill_cold_sharded(
        smap, tcfg, mesh, archive, camera_pos=cam + 1000.0)
    assert n_spill == k0.size
    assert int(distributed.shard_leaf_counts(smap).sum()) == 0
    smap, tcfg2, n_rest = tiering2d.restore_due_sharded(
        smap, tcfg, mesh, archive, camera_pos=cam)
    assert n_rest == k0.size
    k1, v1 = run2d.union_leaves(smap)
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(v0, v1)

    state = state._replace(smap=smap)
    path = str(tmp_path / "smap.npz")
    run2d.save_sharded(path, state, tcfg2)
    with np.load(path) as z:
        keys = set(z.files)
    n = len(convert.state2d_leaf_names(tcfg2))
    assert keys == {"n", *REFERENCE_SHARDED_STAMPS,
                    *(f"a{i}" for i in range(n))}
    loaded, lcfg = run2d.load_sharded(path, tcfg2, mesh)
    assert lcfg == tcfg2
    for dev, p, lv in zip(mesh.axis_devices("map"), loaded.smap.pools,
                          loaded.smap.leaves):
        assert p.child.device == lv.keys.device == dev
    a = _flatten(convert.state2d_to_numpy(state))
    b = _flatten(convert.state2d_to_numpy(loaded))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    step = distributed.slam_step_2d(lcfg, mesh)
    sa, _ = step(convert.clone_state(state), frames[-1])
    sb, _ = step(loaded, frames[-1])
    assert torch.equal(sa.pose, sb.pose)
    for x, y in zip(run2d.union_leaves(sa.smap), run2d.union_leaves(sb.smap)):
        np.testing.assert_array_equal(x, y)


def test_row_slabs_recover_the_orbit(orbit):
    cfg, frames, gts = orbit[:3]
    rcfg, frames = orb.recovery(cfg, frames)
    state, _, info, _ = orb.run_2d(rcfg, distributed.make_mesh2(2, 4),
                                   frames, gts)
    assert "relocalize" in [e["event"] for e in info["events"]]
    assert not bool(state.diverged)
    err = np.linalg.norm(info["poses"][-1][:3, 3]
                         - gts[-1][:3, 3].cpu().numpy())
    assert err < orb.RELOC_ERR_MAX_M
